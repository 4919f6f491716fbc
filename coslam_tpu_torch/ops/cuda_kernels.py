"""Hand-written CUDA kernels for the hot ops (the counterpart of
coslam_tpu/ops/pallas_kernels.py), with their plain PyTorch twins.

  * `fast_score_nms_pyramid` (K1, csrc/fast_score_nms.cu) — FAST-9/16
    score + 3x3 NMS + border mask of every pyramid level in one launch;
    `fast_score_nms` is its one-level call without a border.
  * `masked_match`   (K2, csrc/masked_match.cu) — gated Hamming matcher:
    best / second-best distance and argmin per query, streaming targets
    as packed gate records and skipping whatever holds nothing.
  * `pose_opt_lm`    (K3, csrc/pose_opt_lm.cu) — the whole motion-only LM
    in one thread block, one pass per step over observations in registers.

Each wrapper runs its `*_plain` twin for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises — there is no fallback.  Every
launch adds one to `LAUNCHES[name]`, so a run can show which kernels it
went through.

The kernels are compiled at first use with `nvcc` (sm_90a) into a shared
library under coslam_tpu_torch/build/, keyed by a hash of the sources and
flags, and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from coslam_tpu_torch.ops import fast as fast_ops
from coslam_tpu_torch.ops import hamming

INF_I32 = 1 << 20

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("fast_score_nms.cu", "masked_match.cu", "pose_opt_lm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches of each kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {"fast_score_nms": 0, "masked_match": 0,
                            "pose_opt_lm": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    """Build the kernels' shared library if its sources changed; return it.

    One nvcc per source, all started together, then one link.  The
    compiler's resource report (-Xptxas -v) is kept beside the library as
    `<name>.log`."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    out = BUILD_DIR / f"libcoslam_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o") for s in SOURCES]
    cmds = [[nvcc, *compile_flags, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    cmds.append([nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)])
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    link = subprocess.run(cmds[-1], capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed ({link.returncode}):\n"
                           f"{' '.join(cmds[-1])}\n{link.stdout}"
                           f"{link.stderr}")
    out.with_suffix(".log").write_text("".join(logs) + link.stdout
                                       + link.stderr)
    os.replace(tmp, out)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path()))
    lib.coslam_fast_score_nms_pyramid.argtypes = [_P, _P, _P, _P, _I, _I, _P]
    lib.coslam_masked_match_segments.argtypes = [_I, _I]
    lib.coslam_masked_match_query_block.argtypes = [_I]
    lib.coslam_masked_match.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
        _P, _P, _P, _P, _P, _P]
    lib.coslam_pose_opt_lm.argtypes = [
        _P, _P, _P, _P, _I, _F, _F, _F, _F, _I, _I, _F, _P, _P, _P]
    lib.coslam_pose_opt_lm_register_limit.argtypes = []
    for fn in (lib.coslam_fast_score_nms_pyramid,
               lib.coslam_masked_match_segments,
               lib.coslam_masked_match_query_block,
               lib.coslam_masked_match, lib.coslam_pose_opt_lm,
               lib.coslam_pose_opt_lm_register_limit):
        fn.restype = ctypes.c_int
    return lib


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises on anything else
    (mixed devices, other device types)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: Tuple[Optional[int], ...]) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K1: FAST score + NMS
# ---------------------------------------------------------------------------

K1_MAX_LEVELS = 8     # levels one launch takes (MAX_LEVELS in the source)


def fast_score_nms_plain(img: torch.Tensor) -> torch.Tensor:
    return fast_ops.nms3(fast_ops.fast_score(img))


def fast_score_nms_pyramid_plain(levels: Sequence[torch.Tensor],
                                 margin: int) -> List[torch.Tensor]:
    return [fast_score_nms_plain(l)
            * fast_ops.border_mask_on(l.shape[0], l.shape[1], margin, l.device)
            for l in levels]


def fast_score_nms_pyramid(levels: Sequence[torch.Tensor],
                           margin: int) -> List[torch.Tensor]:
    """(H_l, W_l) float32 images -> their NMS'd FAST score maps with a
    border of `margin` pixels set to zero, in one launch for up to 8 levels
    (views of one allocation).  Agrees with nms3(fast_score(img)) *
    border_mask at least 4 px inside the image (the reference wraps at the
    image border, the kernel clamps): everywhere for margin >= 4."""
    if not levels or not _on_cuda("fast_score_nms", *levels):
        return fast_score_nms_pyramid_plain(levels, margin)
    levels = [l.contiguous() for l in levels]
    for l in levels:
        _check("fast_score_nms img", l, torch.float32, (None, None))
    if margin < 0:
        raise ValueError(f"fast_score_nms: margin {margin}")
    flat = torch.empty(sum(l.numel() for l in levels), dtype=torch.float32,
                       device=levels[0].device)
    outs, offset = [], 0
    for l in levels:
        outs.append(flat[offset:offset + l.numel()].view(l.shape))
        offset += l.numel()
    lib, stream = _lib(), _stream(flat)
    for s in range(0, len(levels), K1_MAX_LEVELS):
        ins, res = levels[s:s + K1_MAX_LEVELS], outs[s:s + K1_MAX_LEVELS]
        n = len(ins)
        rc = lib.coslam_fast_score_nms_pyramid(
            (_P * n)(*[t.data_ptr() for t in ins]),
            (_P * n)(*[t.data_ptr() for t in res]),
            (_I * n)(*[t.shape[0] for t in ins]),
            (_I * n)(*[t.shape[1] for t in ins]), n, int(margin), stream)
        _raise_on(rc, "fast_score_nms")
        LAUNCHES["fast_score_nms"] += 1
    return outs


def fast_score_nms(img: torch.Tensor) -> torch.Tensor:
    """(H, W) float32 -> NMS'd FAST score map of one image, no border mask:
    agrees with nms3(fast_score(img)) at least 4 px inside the border."""
    if not _on_cuda("fast_score_nms", img):
        return fast_score_nms_plain(img)
    return fast_score_nms_pyramid([img], 0)[0]


# ---------------------------------------------------------------------------
# K2: gated Hamming matcher
# ---------------------------------------------------------------------------

def masked_match_plain(desc_q, uv_q, r2_q, valid_q, level_q, desc_t, uv_t,
                       valid_t, r2_t, level_t, use_level: bool,
                       level_lo: float, level_hi: float,
                       block: int = 2048):
    """Dense formulation of the gated matcher, in query blocks of `block`
    rows so that the (block, M) matrices stay small."""
    n = desc_q.shape[0]
    best = torch.empty(n, dtype=torch.int32, device=desc_q.device)
    second = torch.empty_like(best)
    idx = torch.empty_like(best)
    for s in range(0, n, block):
        e = min(n, s + block)
        d = hamming.pairwise_hamming_pm1(desc_q[s:e], desc_t)
        dd0 = uv_q[s:e, 0, None] - uv_t[None, :, 0]
        dd1 = uv_q[s:e, 1, None] - uv_t[None, :, 1]
        d2 = dd0 * dd0 + dd1 * dd1
        ok = (d2 <= r2_q[s:e, None]) & (d2 <= r2_t[None, :]) \
            & valid_q[s:e, None] & valid_t[None, :]
        if use_level:
            dl = level_t[None, :] - level_q[s:e, None]
            ok = ok & (dl >= level_lo) & (dl <= level_hi)
        d = torch.where(ok, d, INF_I32)
        if d.shape[1] == 0:
            best[s:e] = INF_I32
            second[s:e] = INF_I32
            idx[s:e] = -1
            continue
        b, am = d.min(1)           # first index of the minimum
        d.scatter_(1, am[:, None].long(), INF_I32)
        best[s:e] = b
        second[s:e] = d.amin(1)
        idx[s:e] = torch.where(b < INF_I32, am.to(torch.int32), -1)
    return best, second, idx


# Per (device, stream, n, m): the kernel's segment results and its ticket
# counters (zero before the first launch, left zero by every launch), kept
# so that a call allocates only its three outputs.
_MATCH_SCRATCH: Dict[Tuple[int, int, int, int],
                     Tuple[torch.Tensor, torch.Tensor]] = {}


def _match_scratch(lib, dev: torch.device, stream: int, n: int, m: int):
    key = (dev.index, stream, n, m)
    hit = _MATCH_SCRATCH.get(key)
    if hit is None:
        n_seg = lib.coslam_masked_match_segments(n, m)
        q_blocks = -(-n // lib.coslam_masked_match_query_block(n))
        hit = (torch.empty(3 * n_seg * n if n_seg > 1 else 1,
                           dtype=torch.int32, device=dev),
               torch.zeros(max(q_blocks, 1), dtype=torch.int32, device=dev))
        _MATCH_SCRATCH[key] = hit
    return hit


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return t if t is None or t.dtype == torch.float32 \
        else t.to(torch.float32)


def masked_match(desc_q, uv_q, r2_q, valid_q, desc_t, uv_t, valid_t,
                 level_q=None, level_t=None,
                 level_lo: float = -1e9, level_hi: float = 1e9,
                 r2_t=None):
    """Fused windowed matcher (the reference's `pallas_kernels.masked_match`).

    desc_q: (N, 8) int32 (uint32 bits); uv_q: (N, 2) f32 predicted
    locations; r2_q: (N,) squared window radii, or None for no window on the
    query side (the reference's radius of 1e18); valid_q: (N,) bool;
    desc_t (M, 8), uv_t (M, 2), valid_t (M,).  Optional per-target radii
    r2_t and octave gates level_t - level_q in [level_lo, level_hi] (applied
    when either bound is within +-100; an absent level counts as octave 0).
    Returns (best, second, idx), each (N,) int32; best = second = 2^20 and
    idx = -1 where no target passes."""
    n, m = desc_q.shape[0], desc_t.shape[0]
    dev = desc_q.device
    use_level = level_lo > -100.0 or level_hi < 100.0
    r2_q, r2_t, level_q, level_t = (_f32(t) for t in
                                    (r2_q, r2_t, level_q, level_t))
    given = [t for t in (desc_q, uv_q, r2_q, valid_q, level_q, desc_t, uv_t,
                         valid_t, r2_t, level_t) if t is not None]
    if not _on_cuda("masked_match", *given):
        def filled(t, size, value):
            return t if t is not None else torch.full(
                (size,), value, dtype=torch.float32, device=dev)
        return masked_match_plain(
            desc_q, uv_q, filled(r2_q, n, 1e18), valid_q,
            filled(level_q, n, 0.0), desc_t, uv_t, valid_t,
            filled(r2_t, m, 1e18), filled(level_t, m, 0.0), use_level,
            float(level_lo), float(level_hi))
    ptrs, keep = [], []
    for name, t, dt, shape in (
            ("desc_q", desc_q, torch.int32, (n, 8)),
            ("uv_q", uv_q, torch.float32, (n, 2)),
            ("r2_q", r2_q, torch.float32, (n,)),
            ("valid_q", valid_q, torch.bool, (n,)),
            ("level_q", level_q, torch.float32, (n,)),
            ("desc_t", desc_t, torch.int32, (m, 8)),
            ("uv_t", uv_t, torch.float32, (m, 2)),
            ("valid_t", valid_t, torch.bool, (m,)),
            ("r2_t", r2_t, torch.float32, (m,)),
            ("level_t", level_t, torch.float32, (m,))):
        if t is None:
            if name not in ("r2_q", "r2_t", "level_q", "level_t"):
                raise TypeError(f"masked_match {name}: missing")
            ptrs.append(None)          # a null pointer: the kernel's default
            continue
        t = t.contiguous()
        _check(f"masked_match {name}", t, dt, shape)
        if t.data_ptr() % 16:      # the kernel loads 16 bytes at a time
            t = t.clone()
        keep.append(t)             # a copy made here lives until the launch
        ptrs.append(t.data_ptr())
    lib = _lib()
    stream = _stream(desc_q)
    out = torch.empty((3, n), dtype=torch.int32, device=dev)
    o = out.data_ptr()
    part, tickets = _match_scratch(lib, dev, stream, n, m)
    rc = lib.coslam_masked_match(
        *ptrs, n, m, int(use_level), float(level_lo), float(level_hi),
        o, o + 4 * n, o + 8 * n, part.data_ptr(), tickets.data_ptr(), stream)
    _raise_on(rc, "masked_match")
    LAUNCHES["masked_match"] += 1
    return out.unbind(0)


# ---------------------------------------------------------------------------
# K3: fused pose-only LM
# ---------------------------------------------------------------------------

def chol_solve6(H, b):
    """Unrolled Cholesky solve of a 6x6 SPD system (the reference kernel's
    `_chol6_scalar`); H indexable as H[i][j], b as b[i]."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-12))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = H[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def _exp_se3_twist(dx):
    """SE3 exponential of a (6,) twist -> (R (3, 3), t (3,)), with the
    reference kernel's `_exp_se3_scalar` constants."""
    w = dx[3:]
    t2 = (w * w).sum()
    th = torch.sqrt(t2 + 1e-12)
    small = t2 < 1e-8
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / (t2 + 1e-12))
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (1.0 - A) / (t2 + 1e-12))
    z = torch.zeros_like(t2)
    W = torch.stack([torch.stack([z, -w[2], w[1]]),
                     torch.stack([w[2], z, -w[0]]),
                     torch.stack([-w[1], w[0], z])])
    W2 = W @ W
    I = torch.eye(3, dtype=dx.dtype, device=dx.device)
    R = I + A * W + B * W2
    V = I + B * W + C * W2
    return R, V @ dx[:3]


def pose_opt_lm_plain(T_init, X, uv, isg, *, fx, fy, cx, cy, rounds, iters,
                      chi2_th, trace: Optional[list] = None):
    """The kernel's LM in tensor ops (host-driven iterations, no host sync).

    Like the kernel it makes one pass per LM step: the pass at the trial
    pose gives the normal equations and the cost together, an accepted step
    carries them over as the next step's H, b and cost, and a rejected step
    keeps the ones it had.  Only the start of a round linearises at the
    current pose.  `trace`, if a list, receives (P, lam, improved) after
    every step."""
    delta = float(np.sqrt(chi2_th))
    valid = isg > 0
    U, V = uv[:, 0], uv[:, 1]
    diag = torch.arange(6, device=X.device)

    def resid(P):
        pc = X @ P[:, :3].T + P[:, 3]
        pcx, pcy, pcz = pc[:, 0], pc[:, 1], pc[:, 2]
        zs = torch.where(pcz.abs() < 1e-6, torch.full_like(pcz, 1e-6), pcz)
        iz = 1.0 / zs
        ru = fx * pcx * iz + cx - U
        rv = fy * pcy * iz + cy - V
        return pcx, pcy, iz, ru, rv, pcz <= 0.05, (ru * ru + rv * rv) * isg

    def linearise(P, active, robust):
        """(H (6, 6), b (6,), cost ()) at pose P over the active points."""
        pcx, pcy, iz, ru, rv, behind, chi2 = resid(P)
        ok = active & ~behind
        e = torch.sqrt(torch.clamp(chi2, min=1e-12))
        over = (e > delta) if robust else torch.zeros_like(ok)
        w = torch.where(ok, isg * torch.where(over, delta / e, 1.0), 0.0)
        per = torch.where(over, delta * (2.0 * e - delta), chi2)
        cost = torch.where(ok, per, 0.0).sum()
        iz2 = iz * iz
        zero = torch.zeros_like(iz)
        Ju = torch.stack([fx * iz, zero, -fx * pcx * iz2,
                          -fx * pcx * pcy * iz2,
                          fx * (1.0 + pcx * pcx * iz2), -fx * pcy * iz], 1)
        Jv = torch.stack([zero, fy * iz, -fy * pcy * iz2,
                          -fy * (1.0 + pcy * pcy * iz2),
                          fy * pcx * pcy * iz2, fy * pcx * iz], 1)
        H = (Ju * w[:, None]).T @ Ju + (Jv * w[:, None]).T @ Jv
        b = (Ju * (w * ru)[:, None]).sum(0) + (Jv * (w * rv)[:, None]).sum(0)
        return H, b, cost

    P = T_init[:3, :4].to(torch.float32)
    active = valid
    for rnd in range(rounds):
        robust = rnd < 2
        lam = torch.tensor(1e-3, dtype=torch.float32, device=X.device)
        H, b, cost = linearise(P, active, robust)
        for _ in range(iters):
            Hd = H.clone()
            Hd[diag, diag] = torch.diagonal(H) * (1.0 + lam) + 1e-9
            dx = -chol_solve6(Hd, b)
            Rd, td = _exp_se3_twist(dx)
            Pn = Rd @ P
            Pn = torch.cat([Pn[:, :3], (Pn[:, 3] + td)[:, None]], 1)
            Hn, bn, cost_n = linearise(Pn, active, robust)
            improved = cost_n < cost
            P = torch.where(improved, Pn, P)
            H = torch.where(improved, Hn, H)
            b = torch.where(improved, bn, b)
            cost = torch.where(improved, cost_n, cost)
            lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0),
                              1e-6, 1e3)
            if trace is not None:
                trace.append((P, lam, improved))
        _, _, _, _, _, behind, chi2 = resid(P)
        active = valid & ~behind & (chi2 < chi2_th)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32,
                          device=X.device)
    return torch.cat([P, bottom]), active


def pose_opt_lm(T_init, X, uv, isg_masked, *, fx, fy, cx, cy, rounds, iters,
                chi2_th):
    """Fused pose-only LM.  T_init (4, 4) f32; X (N, 3); uv (N, 2);
    isg_masked (N,) f32 with zeros for invalid observations.  Returns
    (T (4, 4) f32, inliers (N,) bool)."""
    kw = dict(fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
              rounds=int(rounds), iters=int(iters), chi2_th=float(chi2_th))
    if not _on_cuda("pose_opt_lm", T_init, X, uv, isg_masked):
        return pose_opt_lm_plain(T_init, X, uv, isg_masked, **kw)
    n = X.shape[0]
    T_init, X, uv, isg_masked = (t.contiguous() for t in
                                 (T_init, X, uv, isg_masked))
    for name, t, shape in (("T_init", T_init, (4, 4)), ("X", X, (n, 3)),
                           ("uv", uv, (n, 2)), ("isg", isg_masked, (n,))):
        _check(f"pose_opt_lm {name}", t, torch.float32, shape)
    T = torch.empty((4, 4), dtype=torch.float32, device=X.device)
    inl = torch.empty(n, dtype=torch.bool, device=X.device)
    rc = _lib().coslam_pose_opt_lm(
        X.data_ptr(), uv.data_ptr(), isg_masked.data_ptr(),
        T_init.data_ptr(), n, kw["fx"], kw["fy"], kw["cx"], kw["cy"],
        kw["rounds"], kw["iters"], kw["chi2_th"], T.data_ptr(),
        inl.data_ptr(), _stream(X))
    _raise_on(rc, "pose_opt_lm")
    LAUNCHES["pose_opt_lm"] += 1
    return T, inl

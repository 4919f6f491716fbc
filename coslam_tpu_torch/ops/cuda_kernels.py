"""Hand-written CUDA kernels for the hot ops (the counterpart of
coslam_tpu/ops/pallas_kernels.py), with their plain PyTorch twins.

  * `fast_score_nms` (K1, csrc/fast_score_nms.cu) — FAST-9/16 score + 3x3
    NMS in one shared-memory pass per pyramid level.
  * `masked_match`   (K2, csrc/masked_match.cu) — gated Hamming matcher:
    best / second-best distance and argmin per query, streaming targets.
  * `pose_opt_lm`    (K3, csrc/pose_opt_lm.cu) — the whole motion-only LM
    in one thread block.

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
from typing import Dict, Optional, Tuple

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

    The compiler's resource report (-Xptxas -v) is kept beside the library
    as `<name>.log`."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    out = BUILD_DIR / f"libcoslam_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path()))
    lib.coslam_fast_score_nms.argtypes = [_P, _P, _I, _I, _P]
    lib.coslam_masked_match_segments.argtypes = [_I, _I]
    lib.coslam_masked_match.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
        _P, _P, _P, _P, _P]
    lib.coslam_pose_opt_lm.argtypes = [
        _P, _P, _P, _P, _I, _F, _F, _F, _F, _I, _I, _F, _P, _P, _P]
    for fn in (lib.coslam_fast_score_nms, lib.coslam_masked_match_segments,
               lib.coslam_masked_match, lib.coslam_pose_opt_lm):
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

def fast_score_nms_plain(img: torch.Tensor) -> torch.Tensor:
    return fast_ops.nms3(fast_ops.fast_score(img))


def fast_score_nms(img: torch.Tensor) -> torch.Tensor:
    """(H, W) float32 -> NMS'd FAST score map.  Agrees with
    nms3(fast_score(img)) at least 4 px inside the border (the reference
    wraps at the border, the kernel clamps)."""
    if not _on_cuda("fast_score_nms", img):
        return fast_score_nms_plain(img)
    _check("fast_score_nms img", img, torch.float32, (None, None))
    h, w = img.shape
    out = torch.empty_like(img)
    _raise_on(_lib().coslam_fast_score_nms(img.data_ptr(), out.data_ptr(),
                                           h, w, _stream(img)),
              "fast_score_nms")
    LAUNCHES["fast_score_nms"] += 1
    return out


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


def masked_match(desc_q, uv_q, r2_q, valid_q, desc_t, uv_t, valid_t,
                 level_q=None, level_t=None,
                 level_lo: float = -1e9, level_hi: float = 1e9,
                 r2_t=None):
    """Fused windowed matcher (the reference's `pallas_kernels.masked_match`).

    desc_q: (N, 8) int32 (uint32 bits); uv_q: (N, 2) f32 predicted
    locations; r2_q: (N,) squared window radii; valid_q: (N,) bool;
    desc_t (M, 8), uv_t (M, 2), valid_t (M,).  Optional per-target radii
    r2_t and octave gates level_t - level_q in [level_lo, level_hi] (applied
    when either bound is within +-100).  Returns (best, second, idx), each
    (N,) int32; best = second = 2^20 and idx = -1 where no target passes."""
    n, m = desc_q.shape[0], desc_t.shape[0]
    dev = desc_q.device
    level_q = (torch.zeros(n, dtype=torch.float32, device=dev)
               if level_q is None else level_q.to(torch.float32))
    level_t = (torch.zeros(m, dtype=torch.float32, device=dev)
               if level_t is None else level_t.to(torch.float32))
    r2_t = (torch.full((m,), 1e18, dtype=torch.float32, device=dev)
            if r2_t is None else r2_t.to(torch.float32))
    use_level = level_lo > -100.0 or level_hi < 100.0
    args = (desc_q, uv_q, r2_q, valid_q, level_q, desc_t, uv_t, valid_t,
            r2_t, level_t)
    if not _on_cuda("masked_match", *args):
        return masked_match_plain(*args, use_level, float(level_lo),
                                  float(level_hi))
    args = tuple(a.contiguous() for a in args)
    for name, t, dt, shape in zip(
            ("desc_q", "uv_q", "r2_q", "valid_q", "level_q",
             "desc_t", "uv_t", "valid_t", "r2_t", "level_t"), args,
            (torch.int32, torch.float32, torch.float32, torch.bool,
             torch.float32, torch.int32, torch.float32, torch.bool,
             torch.float32, torch.float32),
            ((n, 8), (n, 2), (n,), (n,), (n,), (m, 8), (m, 2), (m,), (m,),
             (m,))):
        _check(f"masked_match {name}", t, dt, shape)
    lib = _lib()
    best = torch.empty(n, dtype=torch.int32, device=dev)
    second = torch.empty_like(best)
    idx = torch.empty_like(best)
    n_seg = lib.coslam_masked_match_segments(n, m)
    scratch = torch.empty(3 * n_seg * n if n_seg > 1 else 1,
                          dtype=torch.int32, device=dev)
    rc = lib.coslam_masked_match(
        *[a.data_ptr() for a in args], n, m, int(use_level),
        float(level_lo), float(level_hi), best.data_ptr(),
        second.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
        _stream(desc_q))
    _raise_on(rc, "masked_match")
    LAUNCHES["masked_match"] += 1
    return best, second, idx


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
                      chi2_th):
    """The reference kernel's LM in tensor ops (host-driven iterations)."""
    delta = float(np.sqrt(chi2_th))
    valid = isg > 0
    U, V = uv[:, 0], uv[:, 1]

    def resid(P):
        pc = X @ P[:, :3].T + P[:, 3]
        pcx, pcy, pcz = pc[:, 0], pc[:, 1], pc[:, 2]
        zs = torch.where(pcz.abs() < 1e-6, torch.full_like(pcz, 1e-6), pcz)
        iz = 1.0 / zs
        ru = fx * pcx * iz + cx - U
        rv = fy * pcy * iz + cy - V
        return pcx, pcy, iz, ru, rv, pcz <= 0.05, (ru * ru + rv * rv) * isg

    def robust_per(chi2, robust):
        if not robust:
            return chi2
        e = torch.sqrt(torch.clamp(chi2, min=1e-12))
        return torch.where(e > delta, delta * (2.0 * e - delta), chi2)

    P = T_init[:3, :4].to(torch.float32)
    active = valid
    for rnd in range(rounds):
        robust = rnd < 2
        lam = torch.tensor(1e-3, dtype=torch.float32, device=X.device)
        for _ in range(iters):
            pcx, pcy, iz, ru, rv, behind, chi2 = resid(P)
            ok = active & ~behind
            e = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w_rob = torch.where(e > delta, delta / e, 1.0) if robust \
                else torch.ones_like(e)
            w = torch.where(ok, isg * w_rob, 0.0)
            cost = torch.where(ok, robust_per(chi2, robust), 0.0).sum()
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
            diag = torch.arange(6, device=X.device)
            H[diag, diag] = torch.diagonal(H) * (1.0 + lam) + 1e-9
            dx = -chol_solve6(H, b)
            Rd, td = _exp_se3_twist(dx)
            Pn = Rd @ P
            Pn = torch.cat([Pn[:, :3], (Pn[:, 3] + td)[:, None]], 1)
            _, _, _, _, _, behind_n, chi2_n = resid(Pn)
            cost_n = torch.where(active & ~behind_n,
                                 robust_per(chi2_n, robust), 0.0).sum()
            improved = cost_n < cost
            P = torch.where(improved, Pn, P)
            lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0),
                              1e-6, 1e3)
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

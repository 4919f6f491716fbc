"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the result
lines):

  1. card: name and power limit (nvidia-smi), CUDA kernel build time;
  2. kernels: each hand-written CUDA kernel against its plain PyTorch twin on
     the card, at the shapes the tracking and mapping paths give it (K2 at
     both map capacities, 32768 and 16384 point slots), with kernel and
     twin times (CUDA events, after a warm-up);
  3. slice: resume the saved map coslam_tpu_torch/assets/smoke_map.npz,
     activate localization mode and `run_sequence` over frames 80-119 of the
     synthetic reference workload (640x480, 1000 features, map capacity
     K=256 / P=32768); checks 0 lost frames, no keyframe inserted, every
     kernel launched by the run, and per-frame poses / inlier counts / ATE
     against the JAX package's run on the same checkpoint
     (coslam_tpu_torch/assets/smoke_expected.npz, written by
     scripts/make_torch_smoke_assets.py).

  4. mapping: `System(cfg, device="cuda", enable_loop_closing=False)
     .run_sequence` from the first frame over frames 0-119 of the same
     workload at the bench's capacity (K=64 keyframes, P=16384 points):
     initialisation, tracking, keyframe inserts through the backend (local
     BA, fusion — K2 over all 16384 point slots —, culling) and BoW rows,
     with the JAX run's RANSAC draws injected
     (coslam_tpu_torch/assets/smoke_mapping_expected.npz).  Checks 0 lost
     frames, the initialisation (see MAPPING_INIT_WINDOW), every frame after
     it tracked, the keyframe count, ATE, similarity-aligned camera centres
     against the JAX run, all kernels launched and K2 launched inside every
     backend insert; prints frames/s, backend-insert ms per keyframe and
     host syncs per keyframe.

The second-to-last line is a JSON object with each kernel's launches (in
the mapping run; `launches_by_path` has both runs), error and times; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(ROOT, "coslam_tpu_torch", "assets")
LOC_FRAMES = (80, 120)
MAPPING_FRAMES = 120
TPU_KERNELS = "coslam_tpu/ops/pallas_kernels.py"
# The JAX run's initialisation frame is decided by f32 rounding: at its
# frame 13 the winning F hypothesis leads the runner-up by less than the
# scoring noise, and in float64 the runner-up wins and fails the 0.9
# triangulation gate (PERF.md, PR 2).  The port must initialise against the
# same reference frame within this many frames after the JAX run's frame.
MAPPING_INIT_WINDOW = 3
# camera-centre bar after similarity alignment to the JAX run, in the JAX
# map's units: 3x the CPU port's divergence on this run (PERF.md, PR 2)
MAPPING_CENTRE_BAR = 0.025


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of `fn` on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def smoke_config():
    from coslam_tpu_torch.config import (CameraConfig, ExtractorConfig,
                                         MapperConfig, SystemConfig,
                                         TrackerConfig)
    return SystemConfig(
        camera=CameraConfig(fx=400, fy=400, cx=320, cy=240,
                            width=640, height=480),
        extractor=ExtractorConfig(n_features=1000, max_keypoints=1024),
        tracker=TrackerConfig(mapper_latency_frames=3),
        mapper=MapperConfig())


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    from coslam_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    lib = ck.library_path()
    ck._lib()
    build_s = time.perf_counter() - t0
    print(card)
    print(f"[card] {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | kernels built in "
          f"{build_s:.1f} s ({lib.name})", flush=True)
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"[ptxas] {line.strip()}")
    return card


def phase_kernels(frame_img: np.ndarray, cfg):
    """Each kernel against its plain twin at the slice's shapes."""
    from coslam_tpu_torch.ops import cuda_kernels as ck
    from coslam_tpu_torch.ops import pyramid

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = []

    # K1 on all 8 levels of a rendered 640x480 frame
    levels = [l.contiguous() for l in pyramid.build_pyramid(
        torch.as_tensor(frame_img, device=dev), cfg.extractor)]
    err = 0.0
    for lvl, img in enumerate(levels):
        got = ck.fast_score_nms(img)
        ref = ck.fast_score_nms_plain(img)
        e = float((got - ref)[8:-8, 8:-8].abs().max())
        check(e <= 1e-5, f"K1 level {lvl} {tuple(img.shape)}: max err {e}")
        err = max(err, e)
    ms = time_cuda(lambda: [ck.fast_score_nms(l) for l in levels], 50)
    plain = time_cuda(lambda: [ck.fast_score_nms_plain(l) for l in levels], 20)
    print(f"[K1 fast_score_nms] 8 levels {tuple(levels[0].shape)}.."
          f"{tuple(levels[-1].shape)}: interior max err {err:g} (atol 1e-5); "
          f"{ms:.4f} ms kernel vs {plain:.4f} ms plain per frame", flush=True)
    rows.append(dict(name="fast_score_nms", route="cuda",
                     source="coslam_tpu_torch/csrc/fast_score_nms.cu",
                     replaces=f"{TPU_KERNELS}:97", shape="8-level pyramid of "
                     "480x640", max_abs_err=err, ms=ms, plain_ms=plain))

    # K2 at the motion-model and local-map shapes, level gates and r2_t on
    def match_inputs(n, m):
        dq = rng.integers(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64)
        dt = rng.integers(-2 ** 31, 2 ** 31, (m, 8), dtype=np.int64)
        k = min(n, m) // 2
        dt[:k] = dq[:k] ^ (1 << rng.integers(0, 31, (k, 8)))
        uq = rng.uniform(0, 640, (n, 2))
        ut = rng.uniform(0, 640, (m, 2))
        ut[:k] = uq[:k] + rng.normal(0, 4, (k, 2))
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
        b = lambda a: torch.as_tensor(a, device=dev)
        return (i32(dq), f32(uq), f32(rng.uniform(10, 60, n) ** 2),
                b(rng.uniform(size=n) > 0.1), i32(dt), f32(ut),
                b(rng.uniform(size=m) > 0.1)), dict(
            level_q=f32(rng.integers(0, 8, n)),
            level_t=f32(rng.integers(0, 8, m)), level_lo=-1, level_hi=1,
            r2_t=f32(rng.uniform(10, 60, m) ** 2))

    def match_plain(args, kw):
        dq, uq, r2, vq, dt, ut, vt = args
        return ck.masked_match_plain(dq, uq, r2, vq, kw["level_q"], dt, ut, vt,
                                     kw["r2_t"], kw["level_t"], True,
                                     kw["level_lo"], kw["level_hi"])

    err = 0
    times = {}
    for n, m in ((1024, 1024), (32768, 1024), (1024, 32768), (16384, 1024),
                 (1024, 16384)):
        args, kw = match_inputs(n, m)
        got = ck.masked_match(*args, **kw)
        ref = match_plain(args, kw)
        check(torch.equal(got[0], ref[0]), f"K2 {n}x{m}: best differs")
        check(torch.equal(got[1], ref[1]), f"K2 {n}x{m}: second differs")
        has = ref[0] < ck.INF_I32
        check(torch.equal(got[2][has], ref[2][has]), f"K2 {n}x{m}: idx differs")
        check(bool((got[2][~has] == -1).all()), f"K2 {n}x{m}: idx not -1")
        n_has = int(has.sum())
        ms = time_cuda(lambda: ck.masked_match(*args, **kw), 20)
        plain = time_cuda(lambda: match_plain(args, kw), 5)
        times[(n, m)] = (ms, plain)
        print(f"[K2 masked_match] {n}x{m}: best/second/idx equal ({n_has} "
              f"queries matched); {ms:.4f} ms kernel vs {plain:.4f} ms plain",
              flush=True)
    ms = times[(16384, 1024)][0] + times[(1024, 16384)][0]
    plain = times[(16384, 1024)][1] + times[(1024, 16384)][1]
    rows.append(dict(name="masked_match", route="cuda",
                     source="coslam_tpu_torch/csrc/masked_match.cu",
                     replaces=f"{TPU_KERNELS}:216", shape="mapping path's "
                     "local-map search and whole-map fuse: 16384x1024 "
                     "forward + 1024x16384 reverse",
                     max_abs_err=err, ms=ms, plain_ms=plain))

    # K3 at N=1024 with planted outliers
    n = 1024
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 10, n)], 1).astype(np.float32)
    w, t = np.array([0.03, -0.02, 0.05]), np.array([0.1, -0.05, 0.08])
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    pc = X @ R.T + t
    uv = np.stack([pc[:, 0] / pc[:, 2] * 400 + 320,
                   pc[:, 1] / pc[:, 2] * 400 + 240], 1)
    uv += rng.normal(0, 0.5, uv.shape)
    out_idx = rng.choice(n, 120, replace=False)
    uv[out_idx] += rng.uniform(20, 80, (120, 2))
    isg = (1.0 / 1.2 ** (2 * rng.integers(0, 8, n))).astype(np.float32)
    isg[rng.choice(n, 100, replace=False)] = 0.0
    targs = [torch.eye(4, device=dev)] + [
        torch.as_tensor(np.asarray(a, np.float32), device=dev)
        for a in (X, uv, isg)]
    kw = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, rounds=4, iters=10,
              chi2_th=5.991)
    Tk, ik = ck.pose_opt_lm(*targs, **kw)
    Tp, ip = ck.pose_opt_lm_plain(*targs, **kw)
    e = float((Tk - Tp).abs().max())
    n_diff = int((ik != ip).sum())
    check(e <= 1e-3, f"K3: T differs by {e}")
    check(n_diff <= 5, f"K3: inlier masks differ in {n_diff} of {n}")
    Tgt = np.eye(4)
    Tgt[:3, :3], Tgt[:3, 3] = R, t
    check(float(np.abs(Tk.cpu().numpy() - Tgt).max()) < 5e-3,
          "K3: pose not recovered")
    ms = time_cuda(lambda: ck.pose_opt_lm(*targs, **kw), 50)
    plain = time_cuda(lambda: ck.pose_opt_lm_plain(*targs, **kw), 3, 1)
    print(f"[K3 pose_opt_lm] N={n}: T max err {e:g} (1e-3), inlier masks "
          f"differ in {n_diff} (<= 5); {ms:.4f} ms kernel vs {plain:.4f} ms "
          f"plain", flush=True)
    rows.append(dict(name="pose_opt_lm", route="cuda",
                     source="coslam_tpu_torch/csrc/pose_opt_lm.cu",
                     replaces=f"{TPU_KERNELS}:464", shape="N=1024, 4x10 LM",
                     max_abs_err=e, ms=ms, plain_ms=plain))
    return rows


def rot_err_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    c = (np.trace(Ra @ np.swapaxes(Rb, -1, -2), axis1=-2, axis2=-1) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def phase_slice(seq: np.ndarray, cfg):
    from coslam_tpu_torch.models.system import System
    from coslam_tpu_torch.ops import cuda_kernels as ck
    from coslam_tpu_torch.ops import orb
    from coslam_tpu_torch.utils import checkpoint, evaluation

    budgets = orb.level_budgets(cfg.extractor)
    check(all(b > 0 for b in budgets), f"zero level budget in {budgets}")
    map_path = os.path.join(ASSETS, "smoke_map.npz")
    exp = np.load(os.path.join(ASSETS, "smoke_expected.npz"))
    lo, hi = LOC_FRAMES
    ids = list(range(lo, hi))

    def fresh():
        s = System(cfg, device="cuda")
        checkpoint.load_system(map_path, s)
        s.activate_localization_mode()
        return s

    fresh().run_sequence(seq[:8], frame_ids=ids[:8])   # warm-up
    slam = fresh()
    n_kf0 = int(slam.map.kf_valid.sum())
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    slam.run_sequence(seq, frame_ids=ids)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)

    got_ids, T = slam.trajectory_poses()
    n = len(slam.stats)
    lost = sum(1 for s in slam.stats if s.get("lost"))
    new_kf = sum(1 for s in slam.stats if s.get("keyframe"))
    inl = np.array([s["inliers"] for s in slam.stats])
    check(list(got_ids) == ids, f"tracked frames {got_ids}")
    check(lost == 0, f"{lost} lost frames")
    check(new_kf == 0 and int(slam.map.kf_valid.sum()) == n_kf0,
          "a keyframe was inserted in localization mode")
    check(all(v > 0 for v in launches.values()), f"launches {launches}")
    check(launches["fast_score_nms"] >= 8 * n,
          f"K1 launched {launches['fast_score_nms']} times for {n} frames")
    check(bool(np.isfinite(T).all()) and T.shape == (n, 4, 4), "bad poses")

    c_err = np.linalg.norm(evaluation.trajectory_xyz(T)
                           - evaluation.trajectory_xyz(exp["T"]), axis=1)
    r_err = rot_err_deg(T[:, :3, :3].astype(np.float64),
                        exp["T"][:, :3, :3].astype(np.float64))
    i_err = np.abs(inl - exp["n_inliers"])
    i_tol = np.maximum(3, 0.05 * exp["n_inliers"])
    ate = evaluation.ate_rmse(evaluation.trajectory_xyz(T),
                              evaluation.trajectory_xyz(exp["gt_T"]))
    check(float(c_err.max()) <= 0.01, f"camera centre off by {c_err.max()}")
    check(float(r_err.max()) <= 0.1, f"rotation off by {r_err.max()} deg")
    check(bool((i_err <= i_tol).all()),
          f"n_inliers off: port {inl.tolist()} vs {exp['n_inliers'].tolist()}")
    check(ate <= float(exp["ate"]) + 0.01, f"ATE {ate} vs {float(exp['ate'])}")
    fps = n / dt
    print(f"[slice] localization frames {lo}-{hi - 1}: {n} tracked, lost "
          f"{lost}, new keyframes {new_kf}, inliers min {inl.min()} mean "
          f"{inl.mean():.1f}; vs JAX run: centre err max {c_err.max():.2e}, "
          f"rotation err max {r_err.max():.2e} deg, inlier diff max "
          f"{i_err.max()}; ATE {ate:.5f} (JAX {float(exp['ate']):.5f}); "
          f"{fps:.2f} frames/s ({dt:.3f} s); launches {launches}", flush=True)
    return launches, fps


def mapping_config():
    import dataclasses
    cfg = smoke_config()
    return cfg.replace(mapper=dataclasses.replace(
        cfg.mapper, max_keyframes=64, max_points=16384))


class BackendProbe:
    """Wraps local_mapping.backend_insert: CUDA events around each call,
    K2 launches inside it, host syncs inside it (CUDA sync debug mode)."""

    def __init__(self):
        from coslam_tpu_torch.models import local_mapping as lm
        self.lm = lm
        self.inner = lm.backend_insert
        self.events, self.k2, self.syncs = [], [], []

    def __enter__(self):
        from coslam_tpu_torch.ops import cuda_kernels as ck

        def probe(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            k2 = ck.LAUNCHES["masked_match"]
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                start.record()
                out = self.inner(*a, **kw)
                stop.record()
            self.events.append((start, stop))
            self.k2.append(ck.LAUNCHES["masked_match"] - k2)
            self.syncs.append(sum("synchroniz" in str(x.message) for x in w))
            return out

        self.lm.backend_insert = probe
        return self

    def __exit__(self, *exc):
        self.lm.backend_insert = self.inner

    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def phase_mapping(seq: np.ndarray, gt_poses: np.ndarray):
    from coslam_tpu_torch.models.system import System
    from coslam_tpu_torch.ops import cuda_kernels as ck
    from coslam_tpu_torch.utils import evaluation

    cfg = mapping_config()
    exp = np.load(os.path.join(ASSETS, "smoke_mapping_expected.npz"))
    draws = {int(f): d.astype(np.int64)
             for f, d in zip(exp["draw_frames"], exp["draws"])}

    def fresh():
        s = System(cfg, device="cuda", enable_loop_closing=False)
        s.init_draws = draws
        return s

    fresh().run_sequence(seq[:24])                     # warm-up
    slam = fresh()
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    slam.run_sequence(seq)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)

    # a second, identical run counts host syncs and times each insert
    probe_run = fresh()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w_all, \
                BackendProbe() as probe:
            warnings.simplefilter("always")
            probe_run.run_sequence(seq)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs_total = sum("synchroniz" in str(x.message) for x in w_all) \
        + sum(probe.syncs)
    insert_ms = probe.ms()

    ids, T = slam.trajectory_poses()
    n = len(slam.stats)
    lost = sum(1 for st in slam.stats if st.get("lost"))
    inserted = sum(1 for st in slam.stats if st.get("keyframe"))
    n_kf = int(slam.map.kf_valid.sum())
    ref, init = int(ids[0]), int(ids[1])
    exp_ref, exp_init = int(exp["ref_frame"]), int(exp["init_frame"])
    check(lost == 0, f"{lost} lost frames")
    check(ref == exp_ref, f"reference frame {ref}, JAX run {exp_ref}")
    check(exp_init <= init <= exp_init + MAPPING_INIT_WINDOW,
          f"initialised at frame {init}, JAX run at {exp_init}")
    want_ids = [ref] + list(range(init, MAPPING_FRAMES))
    check(list(ids) == want_ids, f"tracked frames {ids}")
    check([i for i in exp["frame_ids"] if i >= init] == want_ids[1:],
          "the JAX run did not track the same frames")
    check(abs(n_kf - int(exp["n_keyframes"])) <= 1,
          f"{n_kf} keyframes, JAX run {int(exp['n_keyframes'])}")
    check(bool(np.isfinite(T).all()), "non-finite poses")
    check(all(v > 0 for v in launches.values()), f"launches {launches}")
    probe_inserted = sum(1 for st in probe_run.stats if st.get("keyframe"))
    check(len(probe.k2) == probe_inserted > 0
          and all(k >= 2 for k in probe.k2),
          f"K2 launches per backend insert {probe.k2}")
    ate = evaluation.ate_rmse(evaluation.trajectory_xyz(T),
                              evaluation.trajectory_xyz(gt_poses[ids]))
    check(ate <= float(exp["ate"]) + 0.01,
          f"ATE {ate} vs JAX {float(exp['ate'])}")
    j_ids = list(exp["frame_ids"])
    common = [i for i in ids if i in j_ids]
    a = evaluation.trajectory_xyz(T[[list(ids).index(i) for i in common]])
    b = evaluation.trajectory_xyz(exp["T"][[j_ids.index(i) for i in common]])
    sc, R, t = evaluation.umeyama_alignment(a, b)
    c_err = np.linalg.norm((sc * (R @ a.T)).T + t - b, axis=1)
    check(float(c_err.max()) <= MAPPING_CENTRE_BAR,
          f"aligned camera centre off by {c_err.max()}")
    fps = MAPPING_FRAMES / dt          # every input frame, init included
    info = slam.shutdown()
    print(f"[mapping] frames 0-{MAPPING_FRAMES - 1} from the first frame: "
          f"reference frame {ref}, initialised at {init} (JAX {exp_init}), "
          f"{n} tracked, lost {lost}, keyframes inserted {inserted}, valid "
          f"{n_kf} (JAX {int(exp['n_keyframes'])}), points "
          f"{int(slam.map.pt_valid.sum())} (JAX {int(exp['n_points'])}); "
          f"ATE {ate:.5f} (JAX {float(exp['ate']):.5f}); aligned centre "
          f"err vs JAX max {c_err.max():.2e} (bar {MAPPING_CENTRE_BAR}, "
          f"scale {sc:.4f}); chunked frames {info['frames_chunked']}, "
          f"re-tracked {info['frames_discarded']}; launches {launches}",
          flush=True)
    print(f"[mapping] {fps:.2f} frames/s over the {MAPPING_FRAMES}-frame run "
          f"({dt:.3f} s, {len(ids)} poses); backend insert "
          f"{np.mean(insert_ms):.3f} ms per keyframe (CUDA events, "
          f"{len(insert_ms)} inserts, min {min(insert_ms):.3f} max "
          f"{max(insert_ms):.3f}); K2 launches per insert {probe.k2}; host "
          f"syncs {syncs_total} in the run = "
          f"{syncs_total / max(probe_inserted, 1):.1f} per keyframe, "
          f"{sum(probe.syncs) / max(probe_inserted, 1):.1f} per keyframe inside "
          f"the backend inserts", flush=True)
    return launches, fps


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, ROOT)
    import coslam_tpu_torch  # noqa: F401
    from coslam_tpu_torch.utils import synthetic

    check("jax" not in sys.modules, "jax was imported")
    cfg = smoke_config()
    phase_card()
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(360, seed=3)
    lo, hi = LOC_FRAMES
    seq = synthetic.render_sequence(
        cfg.camera, synthetic.Trajectory(traj.poses_cw[lo:hi]), scene)

    rows = phase_kernels(seq[0], cfg)
    loc_launches, _fps = phase_slice(seq, cfg)
    mapping_seq = synthetic.render_sequence(
        cfg.camera, synthetic.Trajectory(traj.poses_cw[:MAPPING_FRAMES]),
        scene)
    map_launches, _fps = phase_mapping(mapping_seq,
                                       traj.poses_cw[:MAPPING_FRAMES])
    check("jax" not in sys.modules, "jax was imported")
    for r in rows:
        r["launches"] = map_launches[r["name"]]
        r["launches_by_path"] = {"localization": loc_launches[r["name"]],
                                 "mapping": map_launches[r["name"]]}
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

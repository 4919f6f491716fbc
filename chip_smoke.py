"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

It needs, beside itself, the repository's `coslam_tpu_torch/` package with
its `assets/` (the JAX package's reference runs, written by
scripts/make_torch_smoke_assets.py), the CUDA sources under
`coslam_tpu_torch/csrc/`, which it builds with nvcc, and the shipped
vocabulary `coslam_tpu/assets/vocab.npz`, read as data; it checks that they
are there before anything else and names what is missing.  It imports
nothing of JAX or of the JAX package.

Phases (each prints its lines; any failure exits non-zero before the result
lines):

  1. card: name and power limit (nvidia-smi), CUDA kernel build time;
  2. kernels: each hand-written CUDA kernel against its plain PyTorch twin on
     the card, at the shapes the tracking and mapping paths give it (the
     inputs of coslam_tpu_torch/utils/kernel_cases.py: K1 on the 8 pyramid
     levels of a rendered frame, one by one and as the one launch with the
     extractor's border that the paths make; K2 at both map
     capacities, 32768 and 16384 point slots, on dense inputs and on
     map-like ones whose table is mostly empty, then on the edges of its
     code paths; K3 below its block size, at 1024 with most and with 215
     observations carrying information, and above its register path), with
     the kernel's device time (its duration in torch.profiler: back-to-back
     calls are host-bound), the twin's time (CUDA events) and the card's
     bound for the work these inputs need;
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

  5. kidnap and recover: phase 4's System, still in mapping mode, is fed
     grey frames until it is LOST and then frames of the same sequence from
     a viewpoint mapped earlier (`track_mono`), the frames of the JAX run in
     coslam_tpu_torch/assets/smoke_reloc_expected.npz.  Checks that LOST is
     entered on the grey frames and not before, that a relocalization
     (place recognition -> EPnP RANSAC -> pose optimization -> recovery
     rounds) brings it back within 4 returned frames, that the recovered
     frames' camera centres, aligned as in phase 4, agree with the JAX
     run's, and that K2 and K3 ran inside the attempts; prints ms per
     attempt (CUDA events) beside the JAX run's outcome.

  6. loop closing, at full width (640x480, 1000 features, K=96 keyframes,
     P=16384 points; 1.25 laps round a cylinder scene, 115 frames, default
     LoopConfig), in two halves:
     (a) on the JAX package's own map: the map handed to the JAX run's
     closing `LoopCloser.on_keyframe` call
     (coslam_tpu_torch/assets/smoke_loop_map.npz, with the database's BoW
     rows and consistency groups, the closer's state and the Sim3 draws) is
     loaded on the card, `on_keyframe` runs with the draws injected, then
     `maybe_run_gba`.  Checks the accepted candidate, the expanded inlier
     count, s / R / t, the keyframe centres after the correction and after
     the global BA against coslam_tpu_torch/assets/smoke_loop_expected.npz,
     and that K2 ran inside `expand_sim3_matches`;
     (b) end to end over the revisit: `System(cfg, device="cuda",
     enable_loop_closing=True)` resumes the JAX run's checkpoint of frame 69
     (coslam_tpu_torch/assets/smoke_loop_resume.npz, with its trajectory
     log) and `run_sequence` takes frames 70-114, then the same with loop
     closing off.  Checks 0 lost frames, a loop closed within 3 keyframes of
     the JAX run's closing keyframe, ATE over the whole trajectory at most
     0.01 above the JAX run's and below the run's without loop closing;
     (c) from the first frame, with and without loop closing, under
     deterministic algorithms with the mapper cycle pinned
     (MAPPER_CYCLE_S).  The port's run parts ways with the JAX run
     long before the revisit (PERF.md, Findings), and by then its tracker
     may have joined the old map on its own:
     checks 0 lost frames, ATE within LOOP_ATE_BAR of the JAX run's, and
     either a loop closed within 3 keyframes of the JAX run's or the
     revisit's first keyframes connected to the loop's first keyframes by
     shared landmarks (which takes them out of the detector's reach).
     (b) and (c) print ms per `on_keyframe` that closes and per one that
     does not, ms of `correct_loop` and `global_ba` (CUDA events), host
     readbacks per `on_keyframe`, K2 launches per closure and frames/s with
     and without loop closing.

  7. stereo at KITTI width: `kitti_config()` (1241x376, 1000 features,
     bf=386.1448) with K=64, P=16384, keyframe throttle 3, loop closing on;
     60 frames of make_trajectory(60, seed=3) in make_scene(600, seed=3),
     stereo pairs rendered with baseline bf / fx, through
     `System(cfg, device="cuda").run_sequence(left, right_images=right)`.
     Checks frame 0's `match_stereo` on the JAX run's keypoints (valid sets
     differing in at most 1% of keypoints, depth within 1e-3 relative where
     both are valid), then, on a run under deterministic algorithms with
     the mapper cycle pinned (MAPPER_CYCLE_S), against the JAX run
     (coslam_tpu_torch/assets/smoke_stereo_expected.npz): the
     initialisation frame, 0 lost, every frame tracked, keyframes made
     (the initial one and those inserted) within max(1, 10%), metric ATE
     (no scale alignment) at most 0.01
     above the JAX run's, camera centres within DEPTH_CENTRE_BAR m
     unaligned; K1 launched at least twice per frame, K2 and K3 launched;
     then K2 inside every backend insert of a timed run.  Prints frames/s
     (median of DEPTH_TIMED_RUNS plain runs and their spread) and ms per
     backend insert (CUDA events).
  8. RGB-D: the bench's camera (640x480, fx=400) with bf=48 and
     render_depth, 1000 features, K=64, P=16384, loop closing off, 60
     frames, `run_sequence(rgb, depths=depth)`
     (coslam_tpu_torch/assets/smoke_rgbd_expected.npz): frame 0's
     `rgbd_depth` equal to the JAX run's, then phase 7's gates with K1 at
     least once per frame.
  9. online vocabulary: (a) `bow.train_vocabulary_device` on the JAX run's
     descriptor pool at its first retrain milestone with its permutation
     (coslam_tpu_torch/assets/smoke_vocab_expected.npz): the words bit for
     bit, `bow_rows` within 1e-6; (b) phase 8's System again over
     VOCAB_FRAMES frames with LoopConfig(vocab_pretrained=False): retrains
     at the JAX run's `_n_added` milestones, after each the database rows
     equal to `bow_rows` of the new words (1e-6); prints ms per retrain
     (CUDA events).

The second-to-last line is a JSON object with each kernel's launches (in
the mapping run; `launches_by_path` and `launches_per_frame` have every
path's run), error, times and bound.  K2's and K3's headline numbers are those of
the inputs most like the paths' own (the mapping path's pair of launches on
a map-like table; 215 of 1024 observations with information); the other
shapes stand under `ms_by_shape`, `bound_ms_by_shape` and `dense`.
`prev_ms` is null: an earlier design's time is taken by
scripts/compare_torch_kernels.py, not here.  The last line is {"ok": true,
"device": {...}}.
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
LOOP_FRAMES = 115                  # 1.25 laps: the revisit begins at frame 92
LOOP_SEED = 5
LOOP_SPLIT = 70                    # the JAX run's checkpoint: frames 0-69
# From the first frame the port's run and the JAX run part ways before the
# revisit (initialisation frame, keyframe cadence) and two runs of the port
# on the card differ as well (scatter-add order): ATE between 0.108 and
# 0.133 over three runs against the JAX run's 0.107 (PERF.md, Findings).
LOOP_ATE_BAR = 0.04
# Two runs of one code differ (ROADMAP Queue 3): a keyframe that arrives
# within the measured mapper cycle gets a truncated local BA
# (`System._mapper_busy_frames`, from the host's wall clock even with the
# throttle pinned), and `index_add_` on the card sums in the order its
# atomics land.  Unpinned, a slow host's runs failed the gates of phase 6
# (c) and 7 that a fast host's passed (PERF.md, Findings).  The runs
# that phases 6 (c), 7 and 8 gate therefore pin both, so that one card and
# one software stack give one outcome: deterministic algorithms, and the
# mapper cycle at these seconds (pin_mapper_cycle).  The JAX stereo run
# measured 0.39-0.52 s on its CPU host (4-6 frames at KITTI's 10 frames/s),
# the card 0.1-0.2 s, so it truncated more local BAs than the card does:
# pinned at 0.1 or 0.15 s the stereo run made 12 keyframes against the JAX
# run's 10, at 1.0 s 10 (RGB-D: 41 and 43 against 40).  Stereo and RGB-D
# take 1.0 s.  The loop run parts from its JAX run at frame 1 and cannot
# follow it: it takes the System's own prior of 0.1 s, 3 frames at 30
# frames/s, inside the pinned throttle (at 1.0 s it drifted to ATE 0.186).
MAPPER_CYCLE_S = {"loop": 0.1, "stereo": 1.0, "rgbd": 1.0}
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
DEV = "cuda"                       # phases 7-9 run here
DEPTH_FRAMES = 60                  # phases 7 and 8
DEPTH_TIMED_RUNS = 3               # phases 7 and 8: frames/s, median
VOCAB_FRAMES = 30                  # phase 9 (b)
RGBD_BF = 48.0                     # 12 cm at fx = 400
# Unaligned camera-centre bar against the JAX run, in metres.  A landmark
# made from depth and seen by its keyframe alone has no constraint along
# its ray in the local BA (no stereo term, as in the JAX package), so two
# f32 solves of one insert part by centimetres (PERF.md, Findings):
# the port on the CPU ends 0.0325 m (stereo) and 0.0482 m (RGB-D) from the
# JAX run.  The bar is twice the larger; accuracy is gated by the metric
# ATE against the ground truth.
DEPTH_CENTRE_BAR = 0.1
# what the script reads beside itself (the kernels' sources and the JAX
# package's reference runs)
NEEDS = (["coslam_tpu_torch/__init__.py", "coslam_tpu/assets/vocab.npz"]
         + [f"coslam_tpu_torch/csrc/{n}" for n in
            ("fast_score_nms.cu", "masked_match.cu", "pose_opt_lm.cu")]
         + [f"coslam_tpu_torch/assets/{n}.npz" for n in
            ("smoke_map", "smoke_expected", "smoke_mapping_expected",
             "smoke_reloc_expected", "smoke_loop_map", "smoke_loop_resume",
             "smoke_loop_expected", "smoke_stereo_expected",
             "smoke_rgbd_expected", "smoke_vocab_expected")])
# Published peaks of one H100 SXM: f32 outside the tensor cores (integer
# operations are counted at the same rate) and device memory.
PEAK_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


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


def kernel_ms(fn, tag: str, reps: int = 50) -> float:
    """Mean device milliseconds per call of `fn` spent in kernel `tag` (its
    name in the launch counters and in its kernel's name), from
    torch.profiler's kernel durations.  Every launch is one kernel, so the
    mean duration of the kernels the profiler recorded times the launches a
    call makes is the call's time even where the profiler dropped some."""
    from torch.profiler import ProfilerActivity, profile
    from coslam_tpu_torch.ops import cuda_kernels as ck
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    launched = ck.LAUNCHES[tag]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launched = ck.LAUNCHES[tag] - launched
    events = [e for e in prof.key_averages() if tag in e.key
              and e.device_type == torch.autograd.DeviceType.CUDA]
    us, seen = (sum(e.self_device_time_total for e in events),
                sum(e.count for e in events))
    check(us > 0, f"the profiler saw no kernel named *{tag}*")
    if seen != launched:
        print(f"[profiler] recorded {seen} of {launched} {tag} kernels",
              flush=True)
    return us / seen * launched / reps / 1e3


def bound(ops: float, nbytes: float):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = ops / PEAK_OPS_PER_S, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


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


def phase_kernels(cfg):
    """Each kernel against its plain twin at the main paths' shapes, with
    its device time beside the card's bound for the same work."""
    from coslam_tpu_torch.ops import cuda_kernels as ck
    from coslam_tpu_torch.utils import kernel_cases as kc

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)          # the timed cases, in kc's order
    edge_rng = np.random.default_rng(1)
    rows = []

    def report(tag, ms, plain, bound_ms, bound_by):
        print(f"[{tag}] {ms * 1e3:.2f} us kernel, {plain:.4f} ms plain; bound "
              f"{bound_ms * 1e3:.3f} us by {bound_by}: bound / time = "
              f"{bound_ms / ms:.4f}", flush=True)

    # K1 on the 8 pyramid levels of a rendered 640x480 frame: level by level
    # through the one-level entry (no border mask; the twin wraps at the
    # image border where the kernel clamps, so away from it), then as the
    # path calls it, one launch with the extractor's border inside
    levels = kc.fast_inputs(dev)
    margin = cfg.extractor.edge_threshold
    check(margin == kc.FAST_MARGIN, f"edge_threshold {margin}")
    err = 0.0
    for lvl, img in enumerate(levels):
        got = ck.fast_score_nms(img)
        ref = ck.fast_score_nms_plain(img)
        e = float((got - ref)[8:-8, 8:-8].abs().max())
        check(e <= 1e-5, f"K1 level {lvl} {tuple(img.shape)}: max err {e}")
        err = max(err, e)
    before = ck.LAUNCHES["fast_score_nms"]
    got = ck.fast_score_nms_pyramid(levels, margin)
    check(ck.LAUNCHES["fast_score_nms"] == before + 1,
          "K1: the pyramid took more than one launch")
    ref = ck.fast_score_nms_pyramid_plain(levels, margin)
    for lvl, (g, r) in enumerate(zip(got, ref)):
        e = float((g - r).abs().max())
        check(e <= 1e-5, f"K1 pyramid level {lvl}: max err {e}")
        check(float(g[:margin].abs().max()) == 0.0
              and float(g[:, -margin:].abs().max()) == 0.0,
              f"K1 pyramid level {lvl}: the border is not zero")
        err = max(err, e)
    ms = kernel_ms(lambda: ck.fast_score_nms_pyramid(levels, margin),
                   "fast_score_nms")
    plain = time_cuda(
        lambda: ck.fast_score_nms_pyramid_plain(levels, margin), 20)
    # What the function needs, counted in two-input operations of its
    # cheapest exact form known: on every pixel of the kept region and its
    # 1-px ring the arcs' minima and maxima of the ring pixels from suffix
    # and prefix extrema of the circle's two halves (2 x 42; the kernel's
    # three-input instructions do two of these each), the best arc of 16
    # (2 x 15), two differences and a maximum; the 3x3 maximum as 3 + 3
    # shared row maxima (8 a pixel with the ring's) and the comparison and
    # selection: 127 operations.  Every pixel read once and written once.
    px = sum(l.numel() for l in levels)
    scored = sum((l.shape[0] - 2 * margin + 2) * (l.shape[1] - 2 * margin + 2)
                 for l in levels)
    b_ms, b_by = bound(127.0 * scored, 8.0 * px)
    print(f"[K1 fast_score_nms] 8 levels {tuple(levels[0].shape)}.."
          f"{tuple(levels[-1].shape)}, one by one and as one launch with a "
          f"{margin}-px border: max err {err:g} (atol 1e-5; exactly 0: "
          f"{err == 0.0})")
    report("K1 fast_score_nms, one frame's pyramid in one launch", ms, plain,
           b_ms, b_by)
    rows.append(dict(name="fast_score_nms", route="cuda",
                     source="coslam_tpu_torch/csrc/fast_score_nms.cu",
                     replaces=f"{TPU_KERNELS}:97", shape="8-level pyramid of "
                     f"480x640 in one launch, {margin}-px border inside",
                     max_abs_err=err, ms=ms, plain_ms=plain,
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # K2 with the octave gate and per-target radii on, at the inputs of
    # kernel_cases (scripts/compare_torch_kernels.py times the same ones)
    def match_plain(args, kw):
        return kc.match_plain(ck, args, kw)

    def match_check(name, args, kw):
        got = ck.masked_match(*args, **kw)
        ref = match_plain(args, kw)
        check(torch.equal(got[0], ref[0]), f"K2 {name}: best differs")
        check(torch.equal(got[1], ref[1]), f"K2 {name}: second differs")
        has = ref[0] < ck.INF_I32
        check(torch.equal(got[2][has], ref[2][has]), f"K2 {name}: idx differs")
        check(bool((got[2][~has] == -1).all()), f"K2 {name}: idx not -1")
        return int(has.sum())

    def match_bound(args, kw):
        """The gate (~8 operations) on every pair of a valid query and a
        valid target, the distance (8 xor, 8 popcount, 7 adds, the update:
        ~24) on the pairs that pass it; every input row and output once."""
        dq, uq, r2, vq, dt, ut, vt = args
        n, m = dq.shape[0], dt.shape[0]
        passing = 0
        for s0 in range(0, n, 4096):
            sl = slice(s0, s0 + 4096)
            d = uq[sl, None, :] - ut[None, :, :]
            d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
            dl = kw["level_t"][None, :] - kw["level_q"][sl, None]
            ok = (d2 <= r2[sl, None]) & (d2 <= kw["r2_t"][None, :]) \
                & vq[sl, None] & vt[None, :] \
                & (dl >= kw["level_lo"]) & (dl <= kw["level_hi"])
            passing += int(ok.sum())
        ops = 8.0 * int(vq.sum()) * int(vt.sum()) + 24.0 * passing
        nbytes = 49.0 * (n + m) + 12.0 * n
        return bound(ops, nbytes)

    def match_row(names):
        """(kernel ms, plain ms, bound ms, what bounds it) of launches made
        one after the other: the times add, the larger bound names it."""
        ts = [times[k] for k in names]
        return tuple(sum(t[i] for t in ts) for i in range(3)) \
            + (max(ts, key=lambda t: t[2])[3],)

    times = {}
    for name, n, m, nvq, nvt in kc.MATCH_CASES:
        args, kw = kc.match_inputs(rng, dev, n, m, nvq, nvt)
        n_has = match_check(name, args, kw)
        ms = kernel_ms(lambda: ck.masked_match(*args, **kw), "masked_match")
        plain = time_cuda(lambda: match_plain(args, kw), 5)
        b_ms, b_by = match_bound(args, kw)
        times[name] = (ms, plain, b_ms, b_by)
        print(f"[K2 masked_match] {name}: best/second/idx equal ({n_has} "
              f"queries matched)")
        report(f"K2 masked_match {name}", ms, plain, b_ms, b_by)

    # K3 with planted outliers, at the inputs of kernel_cases.  The bound
    # counts the observations that carry information: rounds * (iters + 1)
    # + 1 passes of ~110 operations on each (the 40 solves are ~350 each
    # and do not count beside them); every input and output once.
    limit = ck._lib().coslam_pose_opt_lm_register_limit()
    k3 = {}
    for name, n, n_live in kc.POSE_CASES:
        check((n > limit) == (n == 3000), f"K3 register limit {limit}")
        targs, kw, Tgt = kc.pose_inputs(rng, dev, n, n_live)
        Tk, ik = ck.pose_opt_lm(*targs, **kw)
        Tp, ip = ck.pose_opt_lm_plain(*targs, **kw)
        e = float((Tk - Tp).abs().max())
        n_diff = int((ik != ip).sum())
        check(e <= 1e-3, f"K3 {name}: T differs by {e}")
        check(n_diff <= 5, f"K3 {name}: inlier masks differ in {n_diff}")
        # 0.5 px of noise on ~200 points leaves more pose error than on 1024
        check(float(np.abs(Tk.cpu().numpy() - Tgt).max())
              < (5e-3 if name in ("N=1024", "N=3000") else 2e-2),
              f"K3 {name}: pose not recovered")
        ms = kernel_ms(lambda: ck.pose_opt_lm(*targs, **kw), "pose_opt_lm")
        plain = time_cuda(lambda: ck.pose_opt_lm_plain(*targs, **kw), 3, 1)
        live = int((targs[3] > 0).sum())
        passes = kw["rounds"] * (kw["iters"] + 1) + 1
        b_ms, b_by = bound(110.0 * live * passes, 25.0 * n + 128)
        k3[name] = (ms, plain, b_ms, b_by, e, live)
        print(f"[K3 pose_opt_lm] {name} ({live} with information): T max err "
              f"{e:g} (1e-3), inlier masks differ in {n_diff} (<= 5)")
        report(f"K3 pose_opt_lm {name}, 4x10 LM", ms, plain, b_ms, b_by)
    # the row's headline is what tracking hands over: 1024 slots, 215 matched
    ms, plain, b_ms, b_by, e, live = k3[kc.POSE_MAIN_PATH]
    k3_row = dict(name="pose_opt_lm", route="cuda",
                  source="coslam_tpu_torch/csrc/pose_opt_lm.cu",
                  replaces=f"{TPU_KERNELS}:464",
                  shape=f"N=1024 ({live} with information), 4x10 LM",
                  max_abs_err=max(v[4] for v in k3.values()), ms=ms,
                  plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                  library_ms=None,
                  ms_by_shape={k: v[0] for k, v in k3.items()},
                  bound_ms_by_shape={k: v[2] for k, v in k3.items()})

    # the edges of the kernel's code paths
    for name, n, m, nvq, nvt in (
            ("all targets invalid", 1024, 4096, None, 0),
            ("all queries invalid", 4096, 1024, 0, None),
            ("ragged, lanes share a query", 1000, 3001, None, None),
            ("ragged, a thread per query", 5000, 777, None, None),
            ("one valid target in the last tile", 300, 16384, None, None),
            ("no targets", 7, 0, None, None)):
        args, kw = kc.match_inputs(edge_rng, dev, n, m, nvq, nvt)
        if name.startswith("one valid"):
            vt = torch.zeros(m, dtype=torch.bool, device=dev)
            vt[m - 3] = True               # and query 5 sees it
            args[1][5] = args[5][m - 3]
            args[3][5] = True
            kw["r2_t"][m - 3] = 1e6
            kw["level_q"][5] = kw["level_t"][m - 3]
            args = args[:6] + (vt,)
        n_has = match_check(name, args, kw)
        empty = "invalid" in name or m == 0
        check((n_has == 0) == empty, f"K2 {name}: {n_has} matched")
        print(f"[K2 masked_match] edge {n}x{m} ({name}): equal to the twin, "
              f"{n_has} queries matched", flush=True)
    # a caller without octaves or per-target radii, and the reverse pass's
    # query side without a radius (null pointers in the kernel)
    args, kw = kc.match_inputs(edge_rng, dev, 2048, 1024)
    got = ck.masked_match(args[0], args[1], None, *args[3:])
    big = torch.full((2048,), 1e18, device=dev)
    zq, zt = torch.zeros(2048, device=dev), torch.zeros(1024, device=dev)
    ref = ck.masked_match_plain(args[0], args[1], big, args[3], zq, args[4],
                                args[5], args[6], big[:1024], zt, False,
                                -1e9, 1e9)
    check(all(torch.equal(g, r) for g, r in zip(got[:2], ref[:2])),
          "K2 without optional inputs: best / second differ")
    print("[K2 masked_match] 2048x1024 without radii and octaves: equal to "
          "the twin", flush=True)

    # the row's headline is the mapping path's pair (local-map search and
    # whole-map fuse) on a table filled as the path fills it; the same pair
    # with 90% of either side valid stands beside it
    ms, plain, b_ms, b_by = match_row(kc.MATCH_MAPPING_PAIR)
    d_ms, d_plain, d_b_ms, d_b_by = match_row(kc.MATCH_MAPPING_PAIR_DENSE)
    report("K2 masked_match, the mapping path's pair, map-like", ms, plain,
           b_ms, b_by)
    report("K2 masked_match, the mapping path's pair, dense", d_ms, d_plain,
           d_b_ms, d_b_by)
    rows.append(dict(name="masked_match", route="cuda",
                     source="coslam_tpu_torch/csrc/masked_match.cu",
                     replaces=f"{TPU_KERNELS}:216", shape="mapping path's "
                     "local-map search and whole-map fuse on a map-like "
                     "table: " + " + ".join(kc.MATCH_MAPPING_PAIR),
                     max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None,
                     dense=dict(shape=" + ".join(kc.MATCH_MAPPING_PAIR_DENSE)
                                + ", 90% of either side valid", ms=d_ms,
                                plain_ms=d_plain, bound_ms=d_b_ms,
                                bound_by=d_b_by),
                     ms_by_shape={k: v[0] for k, v in times.items()},
                     bound_ms_by_shape={k: v[2] for k, v in times.items()}))
    rows.append(k3_row)
    # the designs these replaced were timed in turns with them by
    # scripts/compare_torch_kernels.py --parent; this run has no such time
    for r in rows:
        r["prev_ms"] = None
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
    check(launches["fast_score_nms"] == n,
          f"K1 launched {launches['fast_score_nms']} times for {n} frames: "
          "not one launch a frame")
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
    repeat = run_to_run(T, probe_run, fresh, seq)
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
    print(f"[mapping] run to run: {repeat}", flush=True)
    return launches, fps, slam, (sc, R, t)


class DeterministicAlgorithms:
    """torch.use_deterministic_algorithms(True, warn_only=True) inside the
    block (uninitialised memory left as it is); `ops` collects the ops torch
    reports as having no deterministic implementation."""

    def __enter__(self):
        import torch.utils.deterministic
        self._det = torch.utils.deterministic
        self._fill = self._det.fill_uninitialized_memory
        self._det.fill_uninitialized_memory = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        self._caught = warnings.catch_warnings(record=True)
        self._w = self._caught.__enter__()
        warnings.simplefilter("always")
        self.ops = set()
        return self

    def __exit__(self, *exc):
        import re
        self._caught.__exit__(*exc)
        torch.use_deterministic_algorithms(False)
        self._det.fill_uninitialized_memory = self._fill
        for w in self._w:
            m = re.match(r"(.+?) does not have a deterministic",
                         str(w.message))
            if m:
                self.ops.add(m.group(1).strip())


def pin_mapper_cycle(s, seconds: float) -> None:
    """Fix the System's measured mapper cycle (the InterruptBA window) at
    `seconds` instead of the host's wall clock."""
    s._insert_cost_s = seconds
    s._note_insert_cost = lambda dt: None


def run_to_run(T, other, fresh, seq) -> str:
    """Whether two runs of the mapping path on the card give the same
    poses, and which ops torch itself calls nondeterministic on the path
    (two more runs under torch.use_deterministic_algorithms(warn_only))."""

    def diff(a, b):
        if a.shape != b.shape:
            return f"{a.shape[0]} against {b.shape[0]} poses"
        return "bit-equal" if np.array_equal(a, b) \
            else f"max pose difference {np.abs(a - b).max():.3e}"

    plain = diff(T, other.trajectory_poses()[1])
    runs = []
    with DeterministicAlgorithms() as det:
        for _ in range(2):
            s = fresh()
            s.run_sequence(seq)
            runs.append(s.trajectory_poses()[1])
    return (f"two plain runs {plain}; two runs under "
            f"use_deterministic_algorithms {diff(*runs)}, ops torch reports "
            f"nondeterministic on the path: {sorted(det.ops) or 'none'}")


def phase_reloc(slam, align, seq: np.ndarray):
    """Kidnap phase 4's System and let it find its way back."""
    from coslam_tpu_torch.ops import cuda_kernels as ck
    from coslam_tpu_torch.utils import evaluation

    exp = np.load(os.path.join(ASSETS, "smoke_reloc_expected.npz"))
    blank = np.full_like(seq[0], 96)
    frames = [(int(f), blank if src < 0 else seq[src], int(src))
              for f, src in zip(exp["frame_ids"], exp["source"])]
    n_blank = sum(1 for f in frames if f[2] < 0)
    check(slam.state == "OK" and slam.n_relocalizations == 0,
          f"before the kidnap: state {slam.state}")

    attempts = []            # (events, launches inside, candidates, accepted)
    inner_attempt = slam._attempt_relocalization
    inner_detect = slam.db.detect_reloc_candidates
    seen = []

    def detect(*a, **kw):
        seen.append(inner_detect(*a, **kw))
        return seen[-1]

    def attempt(frame):
        before = dict(ck.LAUNCHES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        best = inner_attempt(frame)
        stop.record()
        attempts.append(((start, stop),
                         {k: ck.LAUNCHES[k] - v for k, v in before.items()},
                         seen[-1], -1 if best is None else int(best.ref_kf),
                         0 if best is None else int(best.n_inliers)))
        return best

    slam._attempt_relocalization = attempt
    slam.db.detect_reloc_candidates = detect
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    rows = []
    try:
        for fid, img, _src in frames:
            T = slam.track_mono(img, fid)
            rows.append((slam.state, bool(slam.stats[-1]["lost"]),
                         slam.stats[-1]["inliers"], np.asarray(T)))
    finally:
        slam._attempt_relocalization = inner_attempt
        slam.db.detect_reloc_candidates = inner_detect
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)

    states = [r[0] for r in rows]
    check(all(st == "LOST" and r[1] for st, r in
              zip(states[:n_blank], rows[:n_blank])),
          f"not LOST on the grey frames: {states[:n_blank]}")
    back = [i for i, st in enumerate(states[n_blank:]) if st == "OK"]
    check(bool(back) and back[0] < 4 and states[-1] == "OK",
          f"no relocalization within 4 returned frames: {states}")
    check(slam.n_relocalizations >= 1
          and slam.shutdown()["relocalizations"] == slam.n_relocalizations,
          f"{slam.n_relocalizations} relocalizations")
    check(all(np.isfinite(r[3]).all() for r in rows), "non-finite poses")
    check(all(v > 0 for v in launches.values()), f"launches {launches}")
    # inside every attempt with candidates: per candidate the seed match is
    # dense (no K2), the two recovery rounds are 2 x 2 K2 launches, and
    # there are 3 pose optimizations
    for _ev, inside, cands, _acc, _n in attempts:
        check(inside["masked_match"] == 4 * len(cands)
              and inside["pose_opt_lm"] == 3 * len(cands),
              f"launches inside an attempt over {len(cands)} candidates: "
              f"{inside}")
    hit = [a for a in attempts if a[3] >= 0]
    check(len(hit) == slam.n_relocalizations and len(hit[0][2]) > 0,
          "the accepted attempt had no candidate")
    # recovered frames against the JAX run's, in the JAX map's frame
    sc, R, t = align
    both = [i for i in range(n_blank, len(rows))
            if states[i] == "OK" and exp["ok"][i]]
    check(bool(both), "no recovered frame in common with the JAX run")
    mine = evaluation.trajectory_xyz(np.stack([rows[i][3] for i in both]))
    ref = evaluation.trajectory_xyz(exp["T"][both])
    c_err = np.linalg.norm((sc * (R @ mine.T)).T + t - ref, axis=1)
    check(float(c_err.max()) <= MAPPING_CENTRE_BAR,
          f"recovered camera centre off by {c_err.max()}")
    ms = [a[0][0].elapsed_time(a[0][1]) for a in attempts]
    print(f"[reloc] {n_blank} grey frames then frames "
          f"{[f[2] for f in frames[n_blank:]]}: states {states}, inliers "
          f"{[r[2] for r in rows]}; recovered on returned frame "
          f"{back[0] + 1} against keyframe {hit[0][3]} with {hit[0][4]} "
          f"inliers after the recovery rounds; {slam.n_relocalizations} "
          f"relocalizations; aligned centre err vs the JAX run max "
          f"{c_err.max():.2e} (bar {MAPPING_CENTRE_BAR}, {len(both)} "
          f"frames); launches {launches} ({dt:.3f} s)", flush=True)
    print(f"[reloc] JAX run: states "
          f"{['OK' if o else 'LOST' for o in exp['ok']]}, inliers "
          f"{exp['n_inliers'].tolist()}; recovered on frame id "
          f"{int(exp['recovered_frame'])} against keyframe "
          f"{[int(a) for a in exp['attempt_accepted'] if a >= 0][:1]} with "
          f"{[int(n) for n in exp['attempt_inliers'] if n > 0][:1]} "
          f"inliers; candidates per attempt "
          f"{[[int(c) for c in cs if c >= 0] for cs in exp['attempt_candidates']]}; "
          f"{int(exp['n_relocalizations'])} relocalizations", flush=True)
    print(f"[reloc] {len(attempts)} attempts: "
          f"{', '.join(f'{m:.2f}' for m in ms)} ms each (CUDA events), mean "
          f"{np.mean(ms):.2f} ms; candidates tried "
          f"{[len(a[2]) for a in attempts]}; K2 / K3 launches per attempt "
          f"{[(a[1]['masked_match'], a[1]['pose_opt_lm']) for a in attempts]}",
          flush=True)
    return launches, len(frames)


def loop_config():
    import dataclasses
    cfg = smoke_config()
    return cfg.replace(mapper=dataclasses.replace(
        cfg.mapper, max_keyframes=96, max_points=16384))


class EventTimer:
    """Replaces `owner.name` by a wrapper that brackets each call with CUDA
    events and counts K2 launches inside it."""

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name
        self.inner = getattr(owner, name)
        self.events, self.k2, self.results = [], [], []

    def __enter__(self):
        from coslam_tpu_torch.ops import cuda_kernels as ck

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            k2 = ck.LAUNCHES["masked_match"]
            start.record()
            out = self.inner(*a, **kw)
            stop.record()
            self.events.append((start, stop))
            self.k2.append(ck.LAUNCHES["masked_match"] - k2)
            self.results.append(out)
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.inner)

    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def centres(T: np.ndarray) -> np.ndarray:
    return -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])


def saved_map_closer(cfg, ex):
    """A LoopCloser and its database in the state the JAX run's had before
    its closing `on_keyframe` call (`ex`: the extras of smoke_loop_map.npz),
    with that call's Sim3 draws injected."""
    from coslam_tpu_torch.models import keyframe_db as kdb
    from coslam_tpu_torch.models import loop_closing as lc

    db = kdb.KeyFrameDatabase(cfg, vocab=ex["db_vocab"], device="cuda")
    db.bows, db.has = ex["db_bows"].copy(), ex["db_has"].copy()
    if ex["cg_groups"].shape[0]:
        db._consistent_groups = (ex["cg_groups"], ex["cg_counts"])
    c = lc.LoopCloser(cfg, db)
    c.last_loop_kf = int(ex["last_loop_kf"])
    c.loop_edges = [tuple(int(v) for v in e) for e in ex["loop_edges"]]
    for pair, d in zip(ex["sim3_draw_pairs"], ex["sim3_draws"]):
        c.sim3_draws[(int(pair[0]), int(pair[1]))] = d
    return c


def phase_loop_map(card: str):
    """Half (a): the closing call on the JAX package's own map."""
    from coslam_tpu_torch.models import loop_closing as lc
    from coslam_tpu_torch.ops import cuda_kernels as ck
    from coslam_tpu_torch.utils import checkpoint

    cfg = loop_config()
    exp = np.load(os.path.join(ASSETS, "smoke_loop_expected.npz"))
    m, ex = checkpoint.load_map(os.path.join(ASSETS, "smoke_loop_map.npz"),
                                device="cuda")
    check(m.kf_pose.shape[0] == cfg.mapper.max_keyframes
          and m.kf_uv.shape[1] == cfg.extractor.max_keypoints
          and m.pt_pos.shape[0] == cfg.mapper.max_points,
          "the saved map is not at the full width")
    kf_id = int(ex["kf_id"])

    # warm-up: the first call pays for cuSOLVER / cuBLAS handles
    w = saved_map_closer(cfg, ex)
    w.maybe_run_gba(w.on_keyframe(m, kf_id, covis_row=ex["covis_row"])[0])
    torch.cuda.synchronize()

    c = saved_map_closer(cfg, ex)
    ck.reset_launch_counts()
    with EventTimer(lc, "expand_sim3_matches") as t_expand, \
            EventTimer(lc, "correct_loop") as t_correct, \
            EventTimer(c, "on_keyframe") as t_on, \
            EventTimer(c, "maybe_run_gba") as t_gba:
        m2, closed = c.on_keyframe(m, kf_id, covis_row=ex["covis_row"])
        m3 = c.maybe_run_gba(m2)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)

    check(closed, "the loop was not closed on the JAX package's map")
    got = c.last_closure
    cand, n_exp = int(exp["candidate"]), int(exp["n_inliers"])
    check(got["candidate"] == cand and c.loop_edges[-1] == (kf_id, cand),
          f"accepted candidate {got['candidate']}, JAX run {cand}")
    check(abs(got["n_inliers"] - n_exp) <= max(3, 0.05 * n_exp),
          f"{got['n_inliers']} expanded inliers, JAX run {n_exp}")
    s_err = abs(float(got["s"]) - float(exp["s"]))
    r_err = float(rot_err_deg(got["R"].cpu().numpy().astype(np.float64),
                              exp["R"].astype(np.float64)))
    t_err = float(np.abs(got["t"].cpu().numpy() - exp["t"]).max())
    check(s_err <= 1e-3 and r_err <= 0.1 and t_err <= 1e-3,
          f"Sim3 off: s {s_err}, R {r_err} deg, t {t_err}")
    kfv = m.kf_valid.cpu().numpy()
    c_exp = centres(exp["kf_pose_corrected"])[kfv]
    extent = float(np.linalg.norm(c_exp - c_exp.mean(0), axis=1).max())
    c_err = float(np.linalg.norm(
        centres(m2.kf_pose.cpu().numpy())[kfv] - c_exp, axis=1).max())
    g_err = float(np.linalg.norm(
        centres(m3.kf_pose.cpu().numpy())[kfv]
        - centres(exp["kf_pose_gba"])[kfv], axis=1).max())
    ptv = exp["pt_valid_corrected"]
    p_err = float(np.linalg.norm(m2.pt_pos.cpu().numpy()[ptv]
                                 - exp["pt_pos_corrected"][ptv], axis=1).max())
    check(c_err <= 1e-3 * extent,
          f"corrected keyframe centres off by {c_err} (extent {extent})")
    check(g_err <= 5e-3 * extent,
          f"keyframe centres after the global BA off by {g_err}")
    check(bool(np.array_equal(m2.pt_valid.cpu().numpy(), ptv)),
          "pt_valid after the correction differs")
    check(bool(torch.isfinite(m3.kf_pose).all())
          and bool(torch.isfinite(m3.pt_pos).all()), "non-finite map")
    check(len(t_expand.k2) >= 1 and all(k == 2 for k in t_expand.k2)
          and launches["masked_match"] == sum(t_expand.k2),
          f"K2 launches inside expand_sim3_matches {t_expand.k2}, in the "
          f"call {launches['masked_match']}")
    print(f"[loop a] JAX map at the closing call ({int(kfv.sum())} keyframes, "
          f"{int(m.pt_valid.sum())} points, K={kfv.shape[0]} "
          f"N={m.kf_uv.shape[1]} P={m.pt_pos.shape[0]}): keyframe {kf_id} "
          f"closed against {got['candidate']} (JAX {cand}) with "
          f"{got['n_inliers']} expanded inliers (JAX {n_exp}); Sim3 vs JAX: "
          f"s {s_err:.2e}, R {r_err:.2e} deg, t {t_err:.2e}; keyframe centres "
          f"after correct_loop {c_err:.2e}, after global_ba {g_err:.2e}, "
          f"points after correct_loop {p_err:.2e} (map extent {extent:.3f})",
          flush=True)
    print(f"[loop a] on_keyframe that closes {t_on.ms()[0]:.2f} ms, of which "
          f"correct_loop {t_correct.ms()[0]:.2f} ms; global_ba "
          f"{t_gba.ms()[0]:.2f} ms (CUDA events); host readbacks in "
          f"on_keyframe {c.n_host_syncs}; K2 launches in the closure "
          f"{launches['masked_match']} | {card}", flush=True)
    return launches


def phase_loop_run(card: str):
    """Halves (b) and (c): the loop sequence through `System.run_sequence`,
    with and without loop closing; (b) resumes the JAX run's checkpoint of
    frame LOOP_SPLIT - 1, (c) starts at the first frame."""
    from coslam_tpu_torch.models import loop_closing as lc
    from coslam_tpu_torch.models.system import System
    from coslam_tpu_torch.ops import cuda_kernels as ck
    from coslam_tpu_torch.utils import checkpoint, evaluation, synthetic

    cfg = loop_config()
    exp = np.load(os.path.join(ASSETS, "smoke_loop_expected.npz"))
    resume_path = os.path.join(ASSETS, "smoke_loop_resume.npz")
    with np.load(resume_path) as z:
        resume = {k[6:]: z[k] for k in z.files if k.startswith("extra_traj")
                  or k in ("extra_last_ref_kf", "extra_n_frames_tracked")}
    draws = {int(f): d.astype(np.int64)
             for f, d in zip(exp["draw_frames"], exp["draws"])}
    scene = synthetic.make_cylinder_scene(700, seed=LOOP_SEED)
    traj = synthetic.make_loop_trajectory(LOOP_FRAMES, seed=LOOP_SEED,
                                          frac=1.25)
    seq = synthetic.render_sequence(cfg.camera, traj, scene)
    f_jax = int(exp["loop_kf_frame"])
    ate_jax = float(exp["ate"])

    def run(on: bool, resumed: bool):
        """One run; with loop closing on, every LoopCloser call is timed."""
        timers = {}
        s = System(cfg, device="cuda", enable_loop_closing=on)
        first = 0
        if resumed:
            checkpoint.load_system(resume_path, s)
            s.trajectory = [(int(f), int(r), T) for f, r, T in zip(
                resume["traj_frame"], resume["traj_ref_kf"],
                resume["traj_T_rel"])]
            s.last_ref_kf = int(resume["last_ref_kf"])
            s.n_frames_tracked = int(resume["n_frames_tracked"])
            first = LOOP_SPLIT
        else:
            s.init_draws = draws
            pin_mapper_cycle(s, MAPPER_CYCLE_S["loop"])
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        with EventTimer(lc, "correct_loop") as timers["correct_loop"], \
                EventTimer(lc, "global_ba") as timers["global_ba"]:
            if on:
                timers["on_keyframe"] = EventTimer(
                    s.loop_closer, "on_keyframe").__enter__()
            t0 = time.perf_counter()
            s.run_sequence(seq[first:],
                           frame_ids=list(range(first, LOOP_FRAMES)))
            info = s.shutdown()             # runs a pending global BA
            dt = time.perf_counter() - t0
        ids, T = s.trajectory_poses()
        ate = evaluation.ate_rmse(
            evaluation.trajectory_xyz(T),
            evaluation.trajectory_xyz(traj.poses_cw[np.asarray(ids)]))
        lost = sum(1 for st in s.stats if st.get("lost"))
        check(lost == 0 and s.state == "OK",
              f"{lost} lost frames (loop closing {on}, resumed {resumed})")
        check(bool(np.isfinite(T).all()), "non-finite poses")
        check(list(ids[-(LOOP_FRAMES - max(first, int(ids[1]))):])
              == list(range(max(first, int(ids[1])), LOOP_FRAMES)),
              f"tracked frames {ids}")
        return dict(s=s, info=info, fps=(LOOP_FRAMES - first) / dt, ids=ids,
                    ate=ate, launches=dict(ck.LAUNCHES), timers=timers)

    def closure_facts(r):
        """What the loop closer did in a run, and the lines that say so."""
        s, t_on = r["s"], r["timers"]["on_keyframe"]
        closer = s.loop_closer
        closed = [bool(out[1]) for out in t_on.results]
        ms_on = t_on.ms()
        # a call that examined candidates takes milliseconds; the cooldown
        # and keyframes without a consistent candidate return at once
        worked = [ms for ms, c in zip(ms_on, closed) if not c and ms > 1.0]
        closing = [ms for ms, c in zip(ms_on, closed) if c]
        kf_valid = s.map.kf_valid.cpu().numpy()
        kf_frame_id = s.map.kf_frame_id.cpu().numpy()
        apart = None
        if closer.loop_edges:
            kf_frames = np.sort(kf_frame_id[kf_valid])
            f_port = int(kf_frame_id[closer.loop_edges[0][0]])
            apart = abs(int(np.searchsorted(kf_frames, f_port))
                        - int(np.searchsorted(kf_frames, f_jax)))

        def mean(v):
            return float(np.mean(v)) if len(v) else float("nan")

        t_c, t_g = r["timers"]["correct_loop"], r["timers"]["global_ba"]
        return dict(
            closer=closer, apart=apart, kf_valid=kf_valid,
            kf_frame_id=kf_frame_id,
            k2_closing=[k for k, c in zip(t_on.k2, closed) if c],
            what=f"loops closed {s.n_loops_closed} on frames "
            f"{[st['frame'] for st in s.stats if st.get('loop_closed')]} "
            f"(JAX {int(exp['n_loops_closed'])} on frame "
            f"{int(exp['loop_frame'])}), edges {closer.loop_edges} with "
            f"{closer.last_closure['n_inliers'] if closer.last_closure else 0}"
            f" inliers (JAX ({int(exp['kf_id'])}, {int(exp['candidate'])}) "
            f"with {int(exp['n_inliers'])}, keyframe of frame {f_jax}"
            + (f": {apart} keyframes apart" if apart is not None else "")
            + ")",
            times=f"on_keyframe: {len(ms_on)} calls, {len(closing)} closing "
            f"{mean(closing):.2f} ms, {len(worked)} that verified candidates "
            f"without closing {mean(worked):.2f} ms (max "
            f"{max(worked) if worked else 0:.2f}); correct_loop "
            f"{mean(t_c.ms()):.2f} ms, global_ba {mean(t_g.ms()):.2f} ms "
            f"(CUDA events); host readbacks "
            f"{closer.n_host_syncs / max(len(ms_on), 1):.1f} per on_keyframe "
            f"({closer.n_host_syncs} in the run); K2 launches per closure "
            f"{[k for k, c in zip(t_on.k2, closed) if c]}")

    # ---- (b) the revisit, resumed from the JAX run's checkpoint
    off = run(False, True)
    on = run(True, True)
    f = closure_facts(on)
    print(f"[loop b] the JAX run's checkpoint of frame {LOOP_SPLIT - 1} "
          f"resumed, frames {LOOP_SPLIT}-{LOOP_FRAMES - 1} with loop closing "
          f"on: lost 0, keyframes {int(f['kf_valid'].sum())}; {f['what']}; "
          f"ATE over all {len(on['ids'])} poses {on['ate']:.5f} (JAX "
          f"{ate_jax:.5f}; the same run without loop closing "
          f"{off['ate']:.5f}); launches {on['launches']}", flush=True)
    print(f"[loop b] {on['fps']:.2f} frames/s with loop closing, "
          f"{off['fps']:.2f} without ({LOOP_FRAMES - LOOP_SPLIT} frames each, "
          f"shutdown included); {f['times']} | {card}", flush=True)
    check(on["s"].n_loops_closed >= 1 and on["info"]["loops_closed"] >= 1,
          "no loop was closed")
    check(f["apart"] <= 3, f"the loop was closed {f['apart']} keyframes from "
          "the JAX run's closing keyframe")
    check(all(k >= 2 for k in f["k2_closing"]),
          f"K2 launches inside the closing on_keyframe {f['k2_closing']}")
    check(f["closer"].pending_gba is None, "the global BA was left pending")
    check(on["ate"] <= ate_jax + 0.01, f"ATE {on['ate']} vs JAX {ate_jax}")
    check(on["ate"] < off["ate"],
          f"ATE {on['ate']} with loop closing, {off['ate']} without")
    check(all(v > 0 for v in on["launches"].values()),
          f"launches {on['launches']}")

    # ---- (c) from the first frame, its run-to-run causes pinned
    with DeterministicAlgorithms() as det:
        off0 = run(False, False)
        on0 = run(True, False)
    f0 = closure_facts(on0)
    # where no loop is closed, the revisit must have joined the old map by
    # tracking: the first keyframe of the revisit shares landmarks with the
    # loop's first keyframes, which takes them out of the detector's reach
    s0 = on0["s"]
    back = np.nonzero(f0["kf_valid"] & (f0["kf_frame_id"] >= f_jax))[0]
    from coslam_tpu_torch.models import map_state as ms
    per_kf = ms.covisibility_rows(
        s0.map, torch.as_tensor(back, device="cuda"))[:, :4] \
        .amax(dim=1).tolist() if back.size else []
    shared = max(per_kf[:3], default=0)
    print(f"[loop c] frames 0-{LOOP_FRAMES - 1} from the first frame, loop "
          f"closing on: initialised at {int(on0['ids'][1])} (JAX "
          f"{int(exp['init_frame'])}), {len(on0['ids'])} poses, lost 0, "
          f"keyframes {int(f0['kf_valid'].sum())}; {f0['what']}; landmarks "
          f"the revisit's first keyframes share with keyframes 0-3: up to "
          f"{shared} (connected from {cfg.mapper.covis_edge_threshold}; "
          f"every revisit keyframe, frames "
          f"{f0['kf_frame_id'][back].tolist()}: {per_kf}); mapper cycle "
          f"pinned at {MAPPER_CYCLE_S['loop']} s, deterministic algorithms "
          f"(reported without: {sorted(det.ops) or 'none'}); ATE "
          f"{on0['ate']:.5f} (JAX {ate_jax:.5f}; this run without loop "
          f"closing {off0['ate']:.5f}); launches {on0['launches']}",
          flush=True)
    print(f"[loop c] {on0['fps']:.2f} frames/s with loop closing, "
          f"{off0['fps']:.2f} without ({LOOP_FRAMES} frames each, shutdown "
          f"included); {f0['times']} | {card}", flush=True)
    if s0.n_loops_closed:
        check(f0["apart"] <= 3, f"the loop was closed {f0['apart']} keyframes"
              " from the JAX run's closing keyframe")
    else:
        check(shared >= cfg.mapper.covis_edge_threshold,
              "no loop was closed and the revisit did not join the old map")
    check(max(on0["ate"], off0["ate"]) <= ate_jax + LOOP_ATE_BAR,
          f"ATE {on0['ate']} / {off0['ate']} vs JAX {ate_jax}")
    check(all(v > 0 for v in on0["launches"].values()),
          f"launches {on0['launches']}")
    return on["launches"], on0["launches"]


def depth_config(sensor: str, loop=None):
    import dataclasses
    from coslam_tpu_torch.config import (LoopConfig, MapperConfig,
                                         TrackerConfig, kitti_config)
    if sensor == "stereo":
        return kitti_config(
            mapper=MapperConfig(max_keyframes=64, max_points=16384),
            tracker=TrackerConfig(mapper_latency_frames=3))
    cfg = mapping_config()
    return cfg.replace(camera=dataclasses.replace(cfg.camera, bf=RGBD_BF),
                       sensor="rgbd", loop=loop or LoopConfig())


def depth_frames(cfg, n: int):
    """(left images, right images or depth maps, ground-truth poses), as
    scripts/make_torch_smoke_assets.py renders them."""
    from coslam_tpu_torch.utils import synthetic
    scene = synthetic.make_scene(600, seed=3)
    poses = synthetic.make_trajectory(DEPTH_FRAMES, seed=3).poses_cw[:n]
    cam = cfg.camera
    if cfg.sensor == "stereo":
        pairs = [synthetic.render_stereo_frame(cam, T, scene,
                                               baseline=cam.bf / cam.fx)
                 for T in poses]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]), poses)
    return (synthetic.render_sequence(cam, synthetic.Trajectory(poses),
                                      scene),
            np.stack([synthetic.render_depth(cam, T, scene) for T in poses]),
            poses)


def _kps(ex, prefix: str):
    out = {k: torch.from_numpy(np.ascontiguousarray(ex[f"{prefix}_{k}"]))
           .to(DEV) for k in ("uv", "level", "desc", "valid")}
    out["desc"] = out["desc"].view(torch.int32)
    return out


def check_frame0_depth(sensor: str, cfg, ex, left, aux) -> str:
    """Frame 0's per-keypoint depth on the JAX run's keypoints."""
    from coslam_tpu_torch.ops import stereo
    kl = _kps(ex, "kpl")
    L = torch.from_numpy(left[0]).to(DEV)
    A = torch.from_numpy(aux[0]).to(DEV)
    if sensor == "stereo":
        sd = stereo.match_stereo(cfg.camera, cfg.extractor, cfg.matcher, kl,
                                 _kps(ex, "kpr"), L, A)
    else:
        sd = stereo.rgbd_depth(cfg.camera, kl["uv"], kl["valid"], A)
    tv, jv = sd.valid.cpu().numpy(), ex["sd_valid"]
    td, jd = sd.depth.cpu().numpy(), ex["sd_depth"]
    both = tv & jv
    rel = np.abs(td - jd)[both] / jd[both]
    diff = float((tv != jv).mean())
    if sensor == "stereo":
        check(diff <= 0.01, f"frame 0 stereo valid sets differ in {diff}")
        check(float(rel.max()) <= 1e-3, f"frame 0 depth off by {rel.max()}")
    else:
        check(diff == 0.0 and float(rel.max()) == 0.0,
              f"frame 0 rgbd_depth differs ({diff}, {rel.max()})")
    return (f"frame 0: {int(tv.sum())} keypoints with depth (JAX "
            f"{int(jv.sum())}), valid sets differ in {diff:.4f}, depth max "
            f"rel err {rel.max():.2e}")


def phase_depth(sensor: str, card: str):
    """Phase 7 (stereo) or 8 (RGB-D)."""
    from coslam_tpu_torch.models.system import System
    from coslam_tpu_torch.ops import cuda_kernels as ck
    from coslam_tpu_torch.utils import evaluation

    tag = "stereo" if sensor == "stereo" else "rgbd"
    cfg = depth_config(sensor)
    ex = np.load(os.path.join(ASSETS, f"smoke_{tag}_expected.npz"))
    left, aux, poses = depth_frames(cfg, DEPTH_FRAMES)
    frame0 = check_frame0_depth(sensor, cfg, ex, left, aux)
    kw = {"right_images" if sensor == "stereo" else "depths": aux}
    loops = sensor == "stereo"

    def fresh():
        s = System(cfg, device=DEV, enable_loop_closing=loops)
        pin_mapper_cycle(s, MAPPER_CYCLE_S[tag])
        return s

    def centre_err(s):
        """Largest unaligned camera-centre distance to the JAX run's."""
        T = s.trajectory_poses()[1]
        n = min(len(T), len(ex["T"]))
        return float(np.linalg.norm(
            evaluation.trajectory_xyz(T[:n])
            - evaluation.trajectory_xyz(ex["T"][:n]), axis=1).max())

    fresh().run_sequence(left[:12], **{k: v[:12] for k, v in kw.items()})
    # the gated run: deterministic algorithms, the mapper cycle pinned
    slam = fresh()
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    with DeterministicAlgorithms() as det:
        slam.run_sequence(left, **kw)
        torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    # timed runs, as phase 4: plain, the System built before the clock
    fps, c_errs = [], []
    for rep_i in range(DEPTH_TIMED_RUNS):
        s = fresh()
        probe = BackendProbe() if rep_i == DEPTH_TIMED_RUNS - 1 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if probe is not None:
            with probe:
                s.run_sequence(left, **kw)
        else:
            s.run_sequence(left, **kw)
        torch.cuda.synchronize()
        fps.append(DEPTH_FRAMES / (time.perf_counter() - t0))
        c_errs.append(centre_err(s))
    insert_ms = probe.ms()
    probe_inserted = sum(1 for st in s.stats if st.get("keyframe"))

    ids, T = slam.trajectory_poses()
    lost = sum(1 for st in slam.stats if st.get("lost"))
    inserted = sum(1 for st in slam.stats if st.get("keyframe"))
    made, j_made = inserted + 1, len(ex["kf_frames"]) + 1
    n_kf = int(slam.map.kf_valid.sum())
    j_kf = int(ex["n_keyframes"])
    check(lost == 0, f"{tag}: {lost} lost frames")
    check(int(ids[0]) == int(ex["frame_ids"][0]),
          f"{tag}: initialised at frame {ids[0]}, JAX run at "
          f"{ex['frame_ids'][0]}")
    check(list(ids) == list(ex["frame_ids"]), f"{tag}: tracked frames {ids}")
    check(abs(made - j_made) <= max(1, 0.1 * j_made),
          f"{tag}: {made} keyframes made, JAX run {j_made}")
    check(bool(np.isfinite(T).all()), f"{tag}: non-finite poses")
    ate = evaluation.ate_rmse(evaluation.trajectory_xyz(T),
                              evaluation.trajectory_xyz(poses[ids]),
                              with_scale=False)
    check(ate <= float(ex["ate"]) + 0.01,
          f"{tag}: metric ATE {ate} vs JAX {float(ex['ate'])}")
    c_err = centre_err(slam)
    check(c_err <= DEPTH_CENTRE_BAR,
          f"{tag}: camera centres off by {c_err} m")
    k1_per_frame = 2 if sensor == "stereo" else 1
    check(launches["fast_score_nms"] >= k1_per_frame * DEPTH_FRAMES,
          f"{tag}: K1 launched {launches['fast_score_nms']} times in "
          f"{DEPTH_FRAMES} frames")
    check(launches["masked_match"] > 0 and launches["pose_opt_lm"] > 0,
          f"{tag}: launches {launches}")
    check(len(probe.k2) == probe_inserted > 0
          and all(k >= 2 for k in probe.k2),
          f"{tag}: K2 launches per backend insert {probe.k2}")
    info = slam.shutdown()
    print(f"[{tag}] {frame0}", flush=True)
    print(f"[{tag}] {DEPTH_FRAMES} frames at {cfg.camera.width}x"
          f"{cfg.camera.height}, {cfg.extractor.n_features} features: "
          f"initialised at frame {ids[0]} (JAX {ex['frame_ids'][0]}), "
          f"{len(ids)} tracked, lost {lost}, keyframes made {made} (JAX "
          f"{j_made}), valid after culling {n_kf} (JAX {j_kf}), points "
          f"{int(slam.map.pt_valid.sum())} (JAX {int(ex['n_points'])}), "
          f"loops {slam.n_loops_closed} (JAX {int(ex['n_loops'])}); metric "
          f"ATE {ate:.5f} (JAX {float(ex['ate']):.5f}); unaligned centre err "
          f"vs JAX max {c_err:.2e} m (bar {DEPTH_CENTRE_BAR}; the "
          f"timed runs, not pinned to one outcome: "
          f"{', '.join(f'{e:.2e}' for e in c_errs)}); mapper cycle pinned "
          f"at {MAPPER_CYCLE_S[tag]} s, deterministic algorithms (reported "
          f"without: {sorted(det.ops) or 'none'}); chunk "
          f"discard rate {info['chunk_discard_rate']} (JAX "
          f"{float(ex['chunk_discard_rate'])}); launches {launches}",
          flush=True)
    print(f"[{tag}] {np.median(fps):.2f} frames/s, median of "
          f"{DEPTH_TIMED_RUNS} plain runs "
          f"(min {min(fps):.2f}, max {max(fps):.2f}; {card}); backend insert "
          f"{np.mean(insert_ms):.3f} ms per keyframe (CUDA events, "
          f"{len(insert_ms)} inserts, min {min(insert_ms):.3f} max "
          f"{max(insert_ms):.3f}); K2 launches per insert {probe.k2}",
          flush=True)
    return launches


def phase_vocab(card: str):
    """Phase 9: online vocabulary training on the card."""
    from coslam_tpu_torch.config import LoopConfig
    from coslam_tpu_torch.models.system import System
    from coslam_tpu_torch.ops import bow
    from coslam_tpu_torch.ops import cuda_kernels as ck

    ex = np.load(os.path.join(ASSETS, "smoke_vocab_expected.npz"))
    K, N = int(ex["K"]), int(ex["N"])
    desc = np.zeros((K, N, 8), np.uint32)
    ok = np.zeros((K, N), bool)
    desc[ex["kf"]] = ex["desc"]
    ok[ex["kf"]] = ex["kp_valid"]
    d = torch.from_numpy(desc.view(np.int32)).to(DEV)
    v = torch.from_numpy(ok).to(DEV)
    W = int(ex["words"].shape[0])
    perm = ex["perm"].astype(np.int64)

    def train():
        return bow.train_vocabulary_device(d.reshape(K * N, 8),
                                           v.reshape(-1), W, 6, perm=perm)

    words = train()
    check(np.array_equal(words.cpu().numpy().view(np.uint32), ex["words"]),
          "vocab: trained words differ from the JAX run's")
    rows = bow.bow_rows(d, v, words, W).cpu().numpy()[ex["row_kf"]]
    err = float(np.abs(rows - ex["rows"]).max())
    check(err <= 1e-6, f"vocab: bow_rows off by {err}")
    train_ms = time_cuda(train, reps=5, warmup=1)
    rows_ms = time_cuda(lambda: bow.bow_rows(d, v, words, W), reps=5,
                        warmup=1)
    print(f"[vocab] (a) {int(ok.sum())} descriptors of {len(ex['kf'])} "
          f"keyframes in a pool of {K * N}, {W} words, 6 iterations: words "
          f"bit-equal to the JAX run's, bow_rows max err {err:.1e}; "
          f"train_vocabulary_device {train_ms:.3f} ms, bow_rows over "
          f"{K} keyframes {rows_ms:.3f} ms (CUDA events; {card})",
          flush=True)

    cfg = depth_config("rgbd", LoopConfig(vocab_pretrained=False))
    left, aux, _ = depth_frames(cfg, VOCAB_FRAMES)
    s = System(cfg, device=DEV, enable_loop_closing=False)
    pin_mapper_cycle(s, MAPPER_CYCLE_S["rgbd"])
    s.db.retrain_perms = {m: perm for m in cfg.loop.vocab_retrain_at}
    inner = s.db.maybe_retrain
    retrains = []

    def recording(m):
        before = s.db._version
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        inner(m)
        stop.record()
        if s.db._version == before:
            return
        okm = m.kf_kp_valid & m.kf_valid[:, None]
        want = bow.bow_rows(m.kf_desc, okm, s.db.vocab, s.db.n_words) \
            .cpu().numpy()
        upd = s.db.has & m.kf_valid.cpu().numpy()
        e = float(np.abs(s.db.bows[upd] - want[upd]).max())
        retrains.append((s.db._n_added, start, stop, e))

    s.db.maybe_retrain = recording
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    s.run_sequence(left, depths=aux)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    milestones = [r[0] for r in retrains]
    j_milestones = [int(x) for x in ex["milestones"]]
    check(milestones == j_milestones,
          f"vocab: retrained at {milestones}, JAX run at {j_milestones}")
    check(all(r[3] <= 1e-6 for r in retrains),
          f"vocab: database rows off by {[r[3] for r in retrains]}")
    check(not any(st.get("lost") for st in s.stats), "vocab: lost frames")
    ms = [a.elapsed_time(b) for _, a, b, _ in retrains]
    print(f"[vocab] (b) RGB-D, {VOCAB_FRAMES} frames, no pretrained "
          f"vocabulary: retrained at {milestones} added keyframes (JAX "
          f"{j_milestones}), rows max err "
          f"{max(r[3] for r in retrains):.1e}; ms per retrain "
          f"{[round(x, 3) for x in ms]} (CUDA events; {card}); keyframes "
          f"{int(s.map.kf_valid.sum())} (JAX {int(ex['n_keyframes'])}); "
          f"launches {launches}", flush=True)
    return launches


def preflight() -> None:
    """Fail at once, naming it, if what the script reads beside itself is
    missing (it was copied out of the repository alone)."""
    missing = [n for n in NEEDS if not os.path.isfile(os.path.join(ROOT, n))]
    check(not missing, f"{len(missing)} files missing beside chip_smoke.py "
          f"in {ROOT}: {', '.join(missing)} — run it from a checkout of the "
          "repository (it needs the coslam_tpu_torch package with its "
          "assets/ and csrc/, and coslam_tpu/assets/vocab.npz)")


def main() -> int:
    preflight()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, ROOT)
    import coslam_tpu_torch  # noqa: F401
    from coslam_tpu_torch.utils import synthetic

    check("jax" not in sys.modules, "jax was imported")
    cfg = smoke_config()
    card = phase_card()
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(360, seed=3)
    lo, hi = LOC_FRAMES
    seq = synthetic.render_sequence(
        cfg.camera, synthetic.Trajectory(traj.poses_cw[lo:hi]), scene)

    clock = [("start", time.perf_counter())]

    def lap(name):
        clock.append((name, time.perf_counter()))

    rows = phase_kernels(cfg)
    lap("kernels")
    loc_launches, _fps = phase_slice(seq, cfg)
    lap("slice")
    mapping_seq = synthetic.render_sequence(
        cfg.camera, synthetic.Trajectory(traj.poses_cw[:MAPPING_FRAMES]),
        scene)
    map_launches, _fps, slam, align = phase_mapping(
        mapping_seq, traj.poses_cw[:MAPPING_FRAMES])
    lap("mapping")
    reloc_launches, n_reloc = phase_reloc(slam, align, mapping_seq)
    del slam
    lap("reloc")
    loop_a = phase_loop_map(card)
    loop_b, loop_c = phase_loop_run(card)
    check(loop_a["masked_match"] > 0 and loop_b["masked_match"] > 0,
          "K2 was not launched on the loop-closing path")
    lap("loop")
    stereo_l = phase_depth("stereo", card)
    lap("stereo")
    rgbd_l = phase_depth("rgbd", card)
    lap("rgbd")
    vocab_l = phase_vocab(card)
    lap("vocab")
    check("jax" not in sys.modules, "jax was imported")
    print("[time] seconds per phase after the card and the build: "
          + ", ".join(f"{b[0]} {b[1] - a[1]:.1f}"
                      for a, b in zip(clock, clock[1:]))
          + f"; {clock[-1][1] - clock[0][1]:.1f} in all", flush=True)
    n_loc = LOC_FRAMES[1] - LOC_FRAMES[0]
    for r in rows:
        r["launches"] = map_launches[r["name"]]
        r["launches_by_path"] = {"localization": loc_launches[r["name"]],
                                 "mapping": map_launches[r["name"]],
                                 "relocalization": reloc_launches[r["name"]],
                                 "loop_closing": loop_c[r["name"]],
                                 "loop_closing_resumed": loop_b[r["name"]],
                                 "loop_closure_on_saved_map":
                                     loop_a[r["name"]],
                                 "stereo": stereo_l[r["name"]],
                                 "rgbd": rgbd_l[r["name"]],
                                 "vocab": vocab_l[r["name"]]}
        # per tracked frame of the localization slice, per input frame of
        # the mapping run (initialisation and backend inserts included) and
        # of the kidnap (grey frames and relocalization attempts included)
        # and of the loop run (loop closing on)
        r["launches_per_frame"] = {
            "localization": loc_launches[r["name"]] / n_loc,
            "mapping": map_launches[r["name"]] / MAPPING_FRAMES,
            "relocalization": reloc_launches[r["name"]] / n_reloc,
            "loop_closing": loop_c[r["name"]] / LOOP_FRAMES,
            "stereo": stereo_l[r["name"]] / DEPTH_FRAMES,
            "rgbd": rgbd_l[r["name"]] / DEPTH_FRAMES}
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Benchmark of the port: tracked frames/s on one GPU, for the full System
and for the tracking hot path (port of bench.py).

    python3 bench_torch.py [--device cuda] [--seed S] [--frames 120]
                           [--repeats 3] [--batch 64]
                           [--mapper-latency-frames -1]

Measurements (bench.py:1-26):

  * full_system — `System.run_sequence` over a rendered sequence at the
    reference's workload (640x480, 1000 features, map capacity 64
    keyframes / 16384 points, loop closing on, the keyframe cadence AUTO
    unless pinned): initialisation, tracking, keyframe inserts, local BA,
    culling, place recognition.  The headline `value` is the median of
    `repeats` fresh Systems, each timed on the host clock ending in
    `torch.cuda.synchronize()`, after a first run that builds the kernels
    and fills the caches; every run is printed, since the host's speed
    drifts within a call.
  * hot_path — `entry.track_step` (ORB extraction: K1; mutual windowed
    matching: K2 twice; motion-only BA: K3) over B frames captured as ONE
    CUDA graph, the counterpart of the reference's `jit(lax.scan)`
    dispatch: a replay times the card's own work per frame, without the
    host's dispatch.  The best of 5 replays, each ended by a synchronize;
    the same frames eager beside it; the graph's outputs must equal the
    eager ones.  Stages from graphs of the step's two nested prefixes
    (`extract_step`, `extract_match_step`).  The kernels' launches per
    frame are those recorded while capturing: a replay launches without
    passing through the wrappers, so it adds no count.

FLOPs: `torch.utils.flop_counter.FlopCounterMode` over one eager step counts
the matmul family only (the pyramid resampling and the descriptor matmuls).
K1, K2 and K3 are launched through ctypes and count zero, as XLA's counter
scored the reference's integer work.  `hot_path_mfu_pct` is null: no FLOP
count covers the three kernels; their roofline shares are `chip_smoke.py`'s
kernel table.

On `--device cpu` nothing is captured: the hot path runs eagerly, with the
kernels' plain twins, and the JSON line's `device` reads "cpu".

Prints earlier lines (the card's name and power limit, the hot path eager
and captured, every System run) and, as its last line, one
JSON object with bench.py's keys.  Exits 1 when a frame was lost or when
the graph's outputs differ from the eager ones.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from coslam_tpu_torch import config as cfg_mod
from coslam_tpu_torch import entry as ent
from coslam_tpu_torch.utils import synthetic
from coslam_tpu_torch.utils.cuda_graph import capture
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

BASELINE_FPS = 30.0     # the reference tracker's real-time rate (bench.py)
KERNELS = ("fast_score_nms", "masked_match", "pose_opt_lm")


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" on
    the CPU."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_seconds(fn: Callable, dev: torch.device, reps: int = 5) -> float:
    """Best of `reps` timed calls of `fn`, each ended by a synchronize,
    after one untimed call (bench.py:80-87)."""
    fn()
    _sync(dev)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def hot_path_frames(seed: int = 0, batch: int = 64) -> np.ndarray:
    """(batch, 480, 640) uint8: the 8 frames of make_trajectory(8, seed)
    over make_scene(800, seed), cycled (bench.py:53-59)."""
    cam = ent.HOT_PATH.camera
    scene = synthetic.make_scene(800, seed=seed)
    traj = synthetic.make_trajectory(8, seed=seed)
    frames = synthetic.render_sequence(cam, traj, scene)
    return np.stack([frames[i % len(frames)] for i in range(batch)])


class HotPath(NamedTuple):
    fps: float                   # B / best replay (eager on the CPU)
    eager_fps: float             # B / best eager loop
    graph: bool                  # captured as a CUDA graph
    equal: bool                  # graph outputs == eager outputs
    stages_ms: Dict[str, float]
    flops_per_frame: Optional[float]
    launches_per_frame: Dict[str, float]
    outputs: tuple               # (T (B, 4, 4), n_inliers (B,), desc (B, N, 8))


def frame_loop(step, imgs, args) -> Callable:
    """A function running `step(imgs[b], *args)` for every frame b of the
    static buffer `imgs`, its outputs stacked along a leading frame axis."""
    def run():
        outs = [step(imgs[b], *args) for b in range(imgs.shape[0])]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(x) for x in zip(*outs))
        return torch.stack(outs)
    return run


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def bench_hot_path(device=DEFAULT_DEVICE, seed: int = 0, batch: int = 64,
                   reps: int = 5) -> HotPath:
    """bench.py:42-124 on the port: B consecutive `track_step`s over a
    static (B, 480, 640) uint8 buffer, as one CUDA graph on the card."""
    dev = resolve_device(device)
    step, example = ent.entry(dev)
    imgs = torch.from_numpy(hot_path_frames(seed, batch)).to(dev)
    args = example[1:]
    loops = {
        "track": frame_loop(step, imgs, args),
        "extract": frame_loop(ent.extract_step, imgs, ()),
        # (prev_uv, prev_desc, prev_valid)
        "extract_match": frame_loop(ent.extract_match_step, imgs, args[:3]),
    }
    eager = loops["track"]()
    seconds, launches, out = {}, {k: 0 for k in KERNELS}, eager
    graph = dev.type == "cuda"
    for name, fn in loops.items():
        if graph:
            g = capture(fn, dev)
            seconds[name] = best_seconds(g.replay, dev, reps)
            if name == "track":
                g.replay()
                _sync(dev)
                out, launches = g.out, g.launches
        else:
            seconds[name] = best_seconds(fn, dev, reps)
    t_eager = best_seconds(loops["track"], dev, reps)
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        step(imgs[0], *args)
    flops = float(fc.get_total_flops()) or None
    t_ex, t_em, t = (seconds[k] for k in ("extract", "extract_match",
                                          "track"))
    stages = {"extract_ms": t_ex / batch * 1e3,
              "match_ms": max(t_em - t_ex, 0.0) / batch * 1e3,
              "pose_opt_ms": max(t - t_em, 0.0) / batch * 1e3}
    return HotPath(
        fps=batch / t, eager_fps=batch / t_eager, graph=graph,
        equal=_equal(out, eager), stages_ms=stages, flops_per_frame=flops,
        launches_per_frame={k: v / batch for k, v in launches.items()},
        outputs=out)


def full_system_config(mapper_latency_frames: int = -1
                       ) -> cfg_mod.SystemConfig:
    """bench.py:140-150: 640x480 at fx 400, 1000 features in 1024 slots,
    64 keyframes / 16384 points; the keyframe cadence AUTO (-1: the busy
    window from the measured backend cost at 30 frames/s) unless pinned."""
    return cfg_mod.SystemConfig(
        camera=cfg_mod.CameraConfig(fx=400, fy=400, cx=320, cy=240,
                                    width=640, height=480),
        extractor=cfg_mod.ExtractorConfig(n_features=1000,
                                          max_keypoints=1024),
        tracker=cfg_mod.TrackerConfig(
            mapper_latency_frames=mapper_latency_frames),
        mapper=cfg_mod.MapperConfig(max_keyframes=64, max_points=16384))


def full_system_frames(cfg: cfg_mod.SystemConfig, n_frames: int,
                       seed: int = 3) -> np.ndarray:
    """The first n_frames of make_trajectory(3 n_frames, seed) over
    make_scene(600, seed): a 30 frames/s-class angular rate
    (bench.py:151-160)."""
    scene = synthetic.make_scene(600, seed=seed)
    traj = synthetic.make_trajectory(3 * n_frames, seed=seed)
    return synthetic.render_sequence(
        cfg.camera, synthetic.Trajectory(traj.poses_cw[:n_frames]), scene)


class SystemRun(NamedTuple):
    fps: float
    keyframes: int
    lost: int
    discard: float
    cadence: int               # mapper latency in frames the run ended at
    initialized: bool
    loops_closed: int


def _run_system(cfg, dev, seq) -> SystemRun:
    from coslam_tpu_torch.models.system import System
    slam = System(cfg, dev)
    _sync(dev)
    t0 = time.perf_counter()
    slam.run_sequence(seq)
    _sync(dev)
    dt = time.perf_counter() - t0
    return SystemRun(
        fps=len(seq) / dt,
        keyframes=int(slam.map.kf_valid.sum()),
        lost=sum(1 for s in slam.stats if s.get("lost")),
        discard=slam.n_frames_discarded / max(slam.n_frames_chunked, 1),
        cadence=int(slam._mapper_latency),
        initialized=slam.state != "NOT_INITIALIZED",
        loops_closed=int(slam.n_loops_closed))


class FullSystem(NamedTuple):
    fps: float                 # median over the timed runs
    median_run: SystemRun      # the run at the median (the lower middle)
    runs: List[SystemRun]      # the timed runs, in order
    first: SystemRun           # the untimed first run (builds, caches)


def bench_full_system(device=DEFAULT_DEVICE, n_frames: int = 120,
                      seed: int = 3, repeats: int = 3,
                      mapper_latency_frames: int = -1) -> FullSystem:
    """bench.py:126-177 on the port: a first run, then `repeats` fresh
    Systems (loop closing on) over the same frames, each timed."""
    dev = resolve_device(device)
    cfg = full_system_config(mapper_latency_frames)
    seq = list(full_system_frames(cfg, n_frames, seed))
    first = _run_system(cfg, dev, seq)
    runs = [_run_system(cfg, dev, seq) for _ in range(repeats)]
    order = sorted(runs, key=lambda r: r.fps)
    return FullSystem(fps=statistics.median(r.fps for r in runs),
                      median_run=order[(len(order) - 1) // 2], runs=runs,
                      first=first)


def result_line(full: FullSystem, hot: HotPath, device_name: str) -> dict:
    """bench.py:190-205's JSON object."""
    run = full.median_run
    return {
        "metric": "full_system_tracked_frames_per_sec_per_chip",
        "value": full.fps,
        "unit": "frames/s",
        "vs_baseline": full.fps / BASELINE_FPS,
        "hot_path_fps": hot.fps,
        "hot_path_vs_baseline": hot.fps / BASELINE_FPS,
        "hot_path_mfu_pct": None,
        "hot_path_gflops_per_frame": (hot.flops_per_frame / 1e9
                                      if hot.flops_per_frame else None),
        "hot_path_stage_ms": hot.stages_ms,
        "keyframes_in_run": run.keyframes,
        "lost_frames": max(r.lost for r in full.runs),
        "chunk_discard_rate": run.discard,
        "device": device_name,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=DEFAULT_DEVICE)
    p.add_argument("--seed", type=int, default=None,
                   help="seed of both workloads (default: the reference "
                        "bench's, 0 for the hot path and 3 for the System)")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--mapper-latency-frames", type=int, default=-1,
                   help="keyframe cadence of the System runs (-1: AUTO)")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    card = card_name(dev)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(card, flush=True)

    hot = bench_hot_path(dev, 0 if a.seed is None else a.seed, a.batch)
    how = ("one CUDA graph of the B-frame loop" if hot.graph else
           "eager (the CPU: nothing captured)")
    print(f"[hot path] B={a.batch} frames, {how}: {hot.fps:.2f} frames/s; "
          f"the same frames eager {hot.eager_fps:.2f} frames/s; graph "
          f"outputs (T, n_inliers, desc) equal to eager: {hot.equal}; "
          f"launches per frame as captured {hot.launches_per_frame}; "
          f"stages ms {hot.stages_ms} | {card}", flush=True)
    print(f"[hot path] FLOPs per frame {hot.flops_per_frame} "
          "(FlopCounterMode over one eager step: the matmul family only; "
          "K1, K2 and K3 count zero); hot_path_mfu_pct null: no FLOP count "
          "covers the three kernels, whose roofline shares are "
          "chip_smoke.py's kernel table", flush=True)

    full = bench_full_system(dev, a.frames, 3 if a.seed is None else a.seed,
                             a.repeats, a.mapper_latency_frames)
    cad = "AUTO" if a.mapper_latency_frames < 0 else "pinned"
    for tag, r in [("first (untimed)", full.first)] + [
            (f"run {i}", r) for i, r in enumerate(full.runs)]:
        print(f"[full system] {tag}: {r.fps:.3f} frames/s, keyframes "
              f"{r.keyframes}, lost {r.lost}, chunk discard {r.discard:.4f}"
              f", cadence {r.cadence} frames ({cad}), initialised "
              f"{r.initialized}, loops closed {r.loops_closed}", flush=True)
    fps = [r.fps for r in full.runs]
    print(f"[full system] {a.frames} frames, loop closing on: median "
          f"{full.fps:.3f} frames/s of {len(fps)} runs, spread "
          f"{min(fps):.3f}-{max(fps):.3f} | {card}", flush=True)
    line = result_line(full, hot, kind)
    print(json.dumps(line))
    return 0 if line["lost_frames"] == 0 and hot.equal else 1

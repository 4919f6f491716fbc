"""Chunk cuts of the chunked driver in both packages, on the CPU.

Runs chip_smoke.py's mapping workload (640x480, 1000 features, K=64 /
P=16384, make_scene(600, seed=3), frames 0-119 of make_trajectory(360,
seed=3), keyframe throttle pinned to 3 frames, loop closing off) through
the JAX package's `System.run_sequence`, recording its initialisation
draws, then through the port's on the CPU with those draws injected, and
prints for each: frames computed by chunks, frames of those re-tracked
(`n_frames_discarded`, the reference's `chunk_discard_rate`), the chunks
cut at a keyframe flag and at a degraded frame, keyframes inserted and
kept.

    JAX_PLATFORMS=cpu python scripts/compare_chunk_cuts.py [--frames N]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import make_torch_smoke_assets as assets  # noqa: E402
from coslam_tpu.models import tracking as jtracking  # noqa: E402
from coslam_tpu.utils import synthetic  # noqa: E402


def counted(mod, name, log):
    """Wrap mod.track_chunk: log each chunk's per-frame flags."""
    inner = getattr(mod, name)

    def fn(*a, **kw):
        out = inner(*a, **kw)
        st = out[1]
        log.append((np.asarray(st.need_kf.cpu() if hasattr(st.need_kf, "cpu")
                               else st.need_kf),
                    np.asarray(st.n_inliers.cpu()
                               if hasattr(st.n_inliers, "cpu")
                               else st.n_inliers),
                    np.asarray(st.ok.cpu() if hasattr(st.ok, "cpu")
                               else st.ok)))
        return out
    setattr(mod, name, fn)


def summary(name, s, log, dt):
    n_kf = int(np.asarray(s.map.kf_valid.cpu() if hasattr(s.map.kf_valid,
                                                          "cpu")
                          else s.map.kf_valid).sum())
    inserted = sum(1 for st in s.stats if st.get("keyframe"))
    flagged = sum(1 for need, _, _ in log if need.any())
    degraded = sum(1 for _, inl, ok in log if ((inl <= 20) | ~ok).any())
    print(f"{name}: {len(log)} chunks, frames chunked {s.n_frames_chunked}, "
          f"re-tracked {s.n_frames_discarded} (chunk_discard_rate "
          f"{s.n_frames_discarded / max(s.n_frames_chunked, 1):.4f}); chunks "
          f"with a keyframe flag {flagged}, with a degraded or lost frame "
          f"{degraded}; keyframes inserted {inserted}, valid {n_kf}; "
          f"initialised at frame {s.trajectory[1][0] if len(s.trajectory) > 1 else None} "
          f"({dt:.1f} s)", flush=True)


def main() -> int:
    frames = int(sys.argv[sys.argv.index("--frames") + 1]) \
        if "--frames" in sys.argv else assets.MAPPING_FRAMES
    cfg = assets.mapping_config()
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(360, seed=3)
    seq = synthetic.render_sequence(
        cfg.camera, synthetic.Trajectory(traj.poses_cw[:frames]), scene)

    jlog = []
    counted(jtracking, "track_chunk", jlog)
    t0 = time.perf_counter()
    js = assets.DrawRecordingSystem(cfg, enable_loop_closing=False)
    js.run_sequence(seq)
    js.shutdown()
    summary("JAX package", js, jlog, time.perf_counter() - t0)
    # the draws of the frames after the reference's initialisation frame,
    # which the port may still attempt (its own is decided by a near-tie)
    ref_id, init_id = js.trajectory[0][0], js.trajectory[1][0]
    assets.later_draws(js, seq, ref_id, range(init_id + 1, init_id + 6))

    import torch
    from coslam_tpu_torch import config as tcfg
    from coslam_tpu_torch.models import system as tsystem
    from coslam_tpu_torch.models import tracking as ttracking
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    tc = tcfg.SystemConfig(
        camera=tcfg.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640,
                                 height=480),
        extractor=tcfg.ExtractorConfig(n_features=1000, max_keypoints=1024),
        tracker=tcfg.TrackerConfig(mapper_latency_frames=3),
        mapper=tcfg.MapperConfig(max_keyframes=64, max_points=16384))
    tlog = []
    counted(ttracking, "track_chunk", tlog)
    t0 = time.perf_counter()
    ts = tsystem.System(tc, device="cpu", enable_loop_closing=False)
    ts.init_draws.update(js.draws)
    ts.run_sequence(seq)
    ts.shutdown()
    summary("port (CPU)", ts, tlog, time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""How the resumed loop run of chip_smoke.py phase 6 (b) follows the mapper
cycle that the InterruptBA window reads.

    python3 scripts/trace_loop_cycle.py [--device cuda|cpu]
                                        [--pins auto,0.1,1.0]
    JAX_PLATFORMS=cpu python3 scripts/trace_loop_cycle.py --jax

`System._mapper_busy_frames` is the fastest backend insert the System
measured on the host's clock, in frame periods (at most 15 here); a
keyframe flagged within that many frames of the previous one gets the
truncated local BA (2 iterations, else 4: the reference's InterruptBA,
LocalMapping.cc:615-631).

The port (default): the phase's resumed run (the JAX run's checkpoint of
frame 69 with its trajectory log, frames 70-114, loop closing on), once
per pin: `auto` measures the cycle on the host's clock, a number fixes it
at that many seconds (as chip_smoke.pin_mapper_cycle does).  Prints per
run the cycle at the end in seconds and frame periods, the inserts with
the truncated and the full BA, the loops closed and the ATE over all 115
poses beside the JAX run's (coslam_tpu_torch/assets/
smoke_loop_expected.npz).

With --jax: the JAX reference run of scripts/make_torch_smoke_assets.py
(`loop_reference`: frames 0-114 in one System on the CPU), with the
measured cycle printed at the checkpoint (after frame 69) and at the end,
the inserts by BA length and its ATE.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LOOP_FRAMES, LOOP_SPLIT, LOOP_SEED = 115, 70, 5


def count_ba_iters(lm) -> list:
    """Record the `ba_iters` of every `lm.backend_insert` call."""
    seen = []
    inner = lm.backend_insert

    def backend_insert(*a, ba_iters=4, **kw):
        seen.append(ba_iters)
        return inner(*a, ba_iters=ba_iters, **kw)

    lm.backend_insert = backend_insert
    return seen


def cycle(s) -> str:
    return (f"cycle {s._insert_cost_s} s = {s._mapper_busy_frames} frame "
            f"periods")


def ate(evaluation, s, traj) -> float:
    ids, T = s.trajectory_poses()
    return evaluation.ate_rmse(
        evaluation.trajectory_xyz(T),
        evaluation.trajectory_xyz(traj.poses_cw[np.asarray(ids)]))


def run_jax() -> None:
    import make_torch_smoke_assets as assets
    from coslam_tpu.models import local_mapping as lm
    from coslam_tpu.models.system import System
    from coslam_tpu.utils import evaluation, synthetic
    cfg = assets.loop_config()
    traj = synthetic.make_loop_trajectory(LOOP_FRAMES, seed=LOOP_SEED,
                                          frac=1.25)
    seq = synthetic.render_sequence(
        cfg.camera, traj, synthetic.make_cylinder_scene(700, seed=LOOP_SEED))
    iters = count_ba_iters(lm)
    s = System(cfg, enable_loop_closing=True)
    s.run_sequence(seq[:LOOP_SPLIT])
    print(f"jax after frame {LOOP_SPLIT - 1}: {cycle(s)}; inserts with BA "
          f"iterations {iters}", flush=True)
    n0 = len(iters)
    s.run_sequence(seq[LOOP_SPLIT:],
                   frame_ids=list(range(LOOP_SPLIT, LOOP_FRAMES)))
    s.shutdown()
    print(f"jax after frame {LOOP_FRAMES - 1}: {cycle(s)}; inserts of "
          f"frames {LOOP_SPLIT}-{LOOP_FRAMES - 1} with BA iterations "
          f"{iters[n0:]}; loops {s.n_loops_closed}; ATE "
          f"{ate(evaluation, s, traj):.5f}", flush=True)


def run_port(device: str, pins) -> None:
    import chip_smoke
    from coslam_tpu_torch.models import local_mapping as lm
    from coslam_tpu_torch.models.system import System
    from coslam_tpu_torch.utils import checkpoint, evaluation, synthetic
    cfg = chip_smoke.loop_config()
    assets = os.path.join(ROOT, "coslam_tpu_torch", "assets")
    ate_jax = float(np.load(os.path.join(
        assets, "smoke_loop_expected.npz"))["ate"])
    resume_path = os.path.join(assets, "smoke_loop_resume.npz")
    with np.load(resume_path) as z:
        resume = {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
    traj = synthetic.make_loop_trajectory(LOOP_FRAMES, seed=LOOP_SEED,
                                          frac=1.25)
    seq = synthetic.render_sequence(
        cfg.camera, traj, synthetic.make_cylinder_scene(700, seed=LOOP_SEED))
    iters = count_ba_iters(lm)
    for pin in pins:
        s = System(cfg, device=device, enable_loop_closing=True)
        checkpoint.load_system(resume_path, s)
        s.trajectory = [(int(f), int(r), T) for f, r, T in zip(
            resume["traj_frame"], resume["traj_ref_kf"],
            resume["traj_T_rel"])]
        s.last_ref_kf = int(resume["last_ref_kf"])
        s.n_frames_tracked = int(resume["n_frames_tracked"])
        if pin != "auto":
            chip_smoke.pin_mapper_cycle(s, float(pin))
        del iters[:]
        t0 = time.perf_counter()
        s.run_sequence(seq[LOOP_SPLIT:],
                       frame_ids=list(range(LOOP_SPLIT, LOOP_FRAMES)))
        s.shutdown()
        print(f"port {device}, mapper cycle {pin}: {cycle(s)}; inserts with "
              f"BA iterations {iters}; loops {s.n_loops_closed}; ATE "
              f"{ate(evaluation, s, traj):.5f} (JAX {ate_jax:.5f}, bar "
              f"{ate_jax + 0.01:.5f}); {time.perf_counter() - t0:.1f} s",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pins", default="auto,0.1,1.0")
    args = ap.parse_args(argv)
    if args.jax:
        sys.path.insert(0, os.path.join(ROOT, "scripts"))
        run_jax()
    else:
        run_port(args.device, args.pins.split(","))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

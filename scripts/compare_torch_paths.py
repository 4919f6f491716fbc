"""Unprofiled frames/s of the port's localization and mapping cells on one
GPU, for this checkout or against another one in turns on the same card.

    python3 scripts/compare_torch_paths.py [--parent DIR]

Each tree runs in a process of its own, from its own root (the two packages
share their module names): one warm-up of each cell, then 4 localization runs
(chip_smoke.py's slice: frames 80-119 on the saved map) and 3 mapping runs
(frames 0-119 from the first frame, loop closing off), host clock around
`run_sequence` ending in a synchronise.  With --parent the order is change,
parent, parent, change, change, parent: the host's speed drifts within a
call, so only neighbours compare.  DIR is an unpacked `git archive` of the
other commit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure() -> None:
    """The cells of the tree in the current directory."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from coslam_tpu_torch.models.system import System
    from coslam_tpu_torch.utils import checkpoint, synthetic

    cfg = cs.smoke_config()
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(360, seed=3)
    lo, hi = cs.LOC_FRAMES
    seq = synthetic.render_sequence(
        cfg.camera, synthetic.Trajectory(traj.poses_cw[lo:hi]), scene)
    mseq = synthetic.render_sequence(
        cfg.camera, synthetic.Trajectory(traj.poses_cw[:cs.MAPPING_FRAMES]),
        scene)
    exp = np.load(os.path.join(cs.ASSETS, "smoke_mapping_expected.npz"))
    draws = {int(f): d.astype(np.int64)
             for f, d in zip(exp["draw_frames"], exp["draws"])}

    def timed(s, frames, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run_sequence(frames, **kw)
        torch.cuda.synchronize()
        return len(frames) / (time.perf_counter() - t0)

    def localization():
        s = System(cfg, device="cuda")
        checkpoint.load_system(os.path.join(cs.ASSETS, "smoke_map.npz"), s)
        s.activate_localization_mode()
        return timed(s, seq, frame_ids=list(range(lo, hi)))

    def mapping():
        s = System(cs.mapping_config(), device="cuda",
                   enable_loop_closing=False)
        s.init_draws = draws
        return timed(s, mseq)

    localization()
    mapping()
    print("localization frames/s",
          [round(localization(), 2) for _ in range(4)], "mapping frames/s",
          [round(mapping(), 2) for _ in range(3)], flush=True)


def main() -> int:
    if "--child" in sys.argv:
        measure()
        return 0
    trees = [ROOT]
    if "--parent" in sys.argv:
        parent = os.path.abspath(sys.argv[sys.argv.index("--parent") + 1])
        trees = [ROOT, parent, parent, ROOT, ROOT, parent]
    for tree in trees:
        print(f"=== tree {tree}", flush=True)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--child"], cwd=tree).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

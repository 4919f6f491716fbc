"""Where the time goes in the port's localization slice on one GPU.

Runs the chip_smoke.py slice (resume coslam_tpu_torch/assets/smoke_map.npz,
localization mode, run_sequence over frames 80-119, 640x480 / 1000
features / P=32768) once to warm up, then once under torch.profiler, and
prints:
  * wall time and frames/s of the profiled run (host clock, synchronised);
  * device busy time (sum of kernel times; one stream, so no overlap) and
    the device idle share of the wall time;
  * the top kernels and operators by device time;
  * the count of host-side sync points the profiler saw (stream
    synchronizations, memcpys, .item() calls).

    python3 scripts/profile_torch_slice.py
"""

from __future__ import annotations

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import ASSETS, LOC_FRAMES, smoke_config  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from coslam_tpu_torch.models.system import System
    from coslam_tpu_torch.utils import checkpoint, synthetic

    cfg = smoke_config()
    lo, hi = LOC_FRAMES
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(360, seed=3)
    seq = synthetic.render_sequence(
        cfg.camera, synthetic.Trajectory(traj.poses_cw[lo:hi]), scene)
    ids = list(range(lo, hi))

    def run():
        s = System(cfg, device="cuda")
        checkpoint.load_system(os.path.join(ASSETS, "smoke_map.npz"), s)
        s.activate_localization_mode()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run_sequence(seq, frame_ids=ids)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()
    plain_wall = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    n = hi - lo
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"unprofiled run: {plain_wall:.4f} s, {n / plain_wall:.2f} frames/s")
    print(f"profiled run: {wall:.4f} s, {n / wall:.2f} frames/s; device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / n:.3f} ms/frame); "
          f"device idle share {1 - busy_us / 1e6 / wall:.4f}")
    syncs = {e.key: e.count for e in events
             if e.key in ("cudaStreamSynchronize", "cudaMemcpyAsync",
                          "cudaDeviceSynchronize", "aten::item",
                          "aten::_local_scalar_dense")}
    print(f"host-side sync points over {n} frames: {syncs}")
    print(events.table(sort_by="self_cuda_time_total", row_limit=25,
                       max_name_column_width=60))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Where two runs of one code on the GPU part, and what fixing the order
costs.

    python3 scripts/trace_run_to_run.py [--frames N]

Runs chip_smoke.py phase 4's mapping workload (640x480, 1000 features,
K=64 / P=16384, the JAX run's initialisation draws injected, loop closing
off, frames 0-119 unless --frames says fewer) and prints:

  * two runs with a checksum of every tensor each ATen op leaves on the
    card (the output's bits summed as integers; uninitialised memory
    zeroed where it is allocated): the first op whose output differs
    between the runs,
    its call site in coslam_tpu_torch and how many ops ran before it, the
    ops that differ after it by name, and the largest pose difference at
    the end;
  * frames/s of plain runs and of runs under
    torch.use_deterministic_algorithms(True), in turns (plain,
    deterministic, deterministic, plain), and whether the two deterministic
    runs give bit-equal poses.

Every op before the first differing one left the same bits in both runs,
so that op is where the order of a reduction first decided a bit.
"""

from __future__ import annotations

import collections
import os
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import ASSETS, MAPPING_FRAMES, mapping_config  # noqa: E402

PKG = os.path.join(ROOT, "coslam_tpu_torch")
# factories whose output is uninitialised memory: their bits are whatever
# the caching allocator hands back, so the trace zeroes them (code that
# reads such memory masks it out) and checksums nothing they return
EMPTY = ("empty", "new_empty", "empty_like", "empty_strided")


def _bits_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of the tensor's bytes read as integers (a 0-d int64 tensor on
    the tensor's device)."""
    flat = torch.empty(t.numel(), dtype=t.dtype, device=t.device)
    b = flat.copy_(t.detach().reshape(-1)).view(torch.uint8)
    for dt, k in ((torch.int64, 8), (torch.int32, 4), (torch.int16, 2)):
        if b.numel() % k == 0:
            return b.view(dt).to(torch.int64).sum()
    return b.to(torch.int64).sum()


def _site() -> str:
    """file:line of the innermost frame inside coslam_tpu_torch."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.startswith(PKG):
            return (f"{os.path.relpath(f.f_code.co_filename, ROOT)}:"
                    f"{f.f_lineno} ({f.f_code.co_name})")
        f = f.f_back
    return "outside coslam_tpu_torch"


class OpChecksums(TorchDispatchMode):
    """Records, for every ATen op that returns tensors on the GPU, its name,
    its call site and one checksum per output tensor."""

    def __init__(self):
        super().__init__()
        self.names, self.sites, self.sums = [], [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in EMPTY:
            return out.zero_()
        if name == "resize_":
            return out
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if isinstance(t, torch.Tensor) and t.is_cuda and t.numel():
                self.names.append(name)
                self.sites.append(_site())
                self.sums.append(_bits_sum(t))
        return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    from coslam_tpu_torch.models.system import System
    from coslam_tpu_torch.utils import synthetic

    n_frames = MAPPING_FRAMES
    if "--frames" in sys.argv:
        n_frames = int(sys.argv[sys.argv.index("--frames") + 1])
    cfg = mapping_config()
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(360, seed=3)
    seq = synthetic.render_sequence(
        cfg.camera, synthetic.Trajectory(traj.poses_cw[:n_frames]), scene)
    exp = np.load(os.path.join(ASSETS, "smoke_mapping_expected.npz"))
    draws = {int(f): d.astype(np.int64)
             for f, d in zip(exp["draw_frames"], exp["draws"])}

    def run(mode=None):
        s = System(cfg, device="cuda", enable_loop_closing=False)
        s.init_draws = draws
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode is None:
            s.run_sequence(seq)
        else:
            with mode:
                s.run_sequence(seq)
        torch.cuda.synchronize()
        return s.trajectory_poses()[1], time.perf_counter() - t0

    run()                                              # warm-up
    card = torch.cuda.get_device_name(0)
    traces, poses = [], []
    for _ in range(2):
        mode = OpChecksums()
        T, _dt = run(mode)
        traces.append((mode.names, mode.sites,
                       torch.stack(mode.sums).cpu().numpy()))
        poses.append(T)
    (na, sites, sa), (nb, _, sb) = traces
    n = min(len(sa), len(sb))
    parted = next((i for i in range(n) if na[i] != nb[i]), None)
    differ = np.nonzero(sa[:n] != sb[:n])[0]
    if poses[0].shape != poses[1].shape:
        pose_diff = f"{len(poses[0])} against {len(poses[1])} poses"
    elif np.array_equal(poses[0], poses[1]):
        pose_diff = "bit-equal"
    else:
        pose_diff = (f"max pose difference "
                     f"{np.abs(poses[0] - poses[1]).max():.3e}")
    print(f"[trace] {n_frames} frames, two runs: {len(sa)} and {len(sb)} "
          f"checksummed op outputs; op sequences part at "
          f"{'no index' if parted is None else parted}; poses {pose_diff} "
          f"({card})", flush=True)
    if len(differ):
        first = int(differ[0])
        counts = collections.Counter(na[i] for i in differ[:200])
        firsts = []
        for i in differ:
            if (na[i], sites[i]) not in firsts:
                firsts.append((na[i], sites[i]))
            if len(firsts) == 6:
                break
        print(f"[trace] first differing output: op #{first} {na[first]} at "
              f"{sites[first]}; outputs differing in all: {len(differ)} of "
              f"{n}; ops among the first 200 that differ: "
              f"{dict(counts.most_common(8))}", flush=True)
        print(f"[trace] the first distinct (op, site) pairs that differ: "
              f"{firsts}", flush=True)
    else:
        print("[trace] every checksummed output equal", flush=True)

    import torch.utils.deterministic as det
    fill = det.fill_uninitialized_memory
    times = {"plain": [], "deterministic": []}
    det_poses = []
    for kind in ("plain", "deterministic", "deterministic", "plain"):
        if kind == "deterministic":
            det.fill_uninitialized_memory = False
            torch.use_deterministic_algorithms(True)
        try:
            T, dt = run()
        finally:
            torch.use_deterministic_algorithms(False)
            det.fill_uninitialized_memory = fill
        times[kind].append(n_frames / dt)
        if kind == "deterministic":
            det_poses.append(T)
    eq = (det_poses[0].shape == det_poses[1].shape
          and np.array_equal(det_poses[0], det_poses[1]))
    print(f"[deterministic] frames/s plain {times['plain']}, under "
          f"use_deterministic_algorithms(True) {times['deterministic']} "
          f"(in turns: plain, det, det, plain; {card}); the two "
          f"deterministic runs' poses {'bit-equal' if eq else 'differ'}",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

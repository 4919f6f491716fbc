"""Scaling benchmark of the port: distributed Schur-LM bundle adjustment as
the mesh's `ba` axis grows (port of bench_scaling.py).

    python3 -m coslam_tpu_torch.bench_scaling [--device cuda]
        [--cpu-ranks N] [--n-kf 96] [--n-pt 12000] [--iters 8]
        [--pcg-iters 30] [--obs-per-kf 0]

One synthetic problem (`make_problem`: the reference's numpy draws in its
order) goes through `optim/ba.solve` on one device, then through
`parallel/sharded_ba.solve_sharded` (observations split over the ranks) and
`solve_partitioned` (points and camera block-rows split) at every world
size D = 1, 2, 4, ... up to W, each result held against `ba.solve`'s.  W is:

  * on the card, `torch.cuda.device_count()` ranks, one card each, their BA
    collectives over NCCL.  World size 1 runs in this process (a gloo world
    of one, the mesh's NCCL group beside it); larger worlds are ranks
    spawned by `parallel/mesh.launch`;
  * with `--cpu-ranks N` (the reference's `--virtual N`), N gloo ranks on
    the CPU, spawned by `parallel/mesh.launch`.  Like the reference's
    virtual devices they share one host, so they validate the path and
    not the numbers.

One JSON line per configuration, with the reference's keys (:146-187), but
for `hlo_collective_census`, which becomes `collective_census`: the
collectives `parallel/mesh` counts (`CALLS`, `PAYLOAD_BYTES`) in one LM
iteration on rank 0 — a solve of one LM iteration less a solve of none —
as {op: {"calls": n, "bytes": b}}; the port compiles no HLO to read them
from.  `modeled_collective_bytes_per_LM_iter_per_dev` is
`sharded_ba.collective_bytes_per_iter`.  Every timing is the mean of 3
solves after one untimed solve and ends in a synchronize.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from coslam_tpu_torch.config import CameraConfig
from coslam_tpu_torch.optim import ba
from coslam_tpu_torch.parallel import mesh as mesh_lib
from coslam_tpu_torch.parallel import sharded_ba
from coslam_tpu_torch.utils import geometry as geo
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

CAM = CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                   width=640, height=480)
MODES = (("obs-sharded", sharded_ba.solve_sharded),
         ("partitioned", sharded_ba.solve_partitioned))


def _exp_se3(xi: np.ndarray) -> np.ndarray:
    return geo.exp_se3(torch.from_numpy(xi)).numpy()


def make_problem(n_kf: int = 96, n_pt: int = 12000, obs_per_kf: int = 0,
                 cam: CameraConfig = CAM) -> ba.BAProblem:
    """The reference's synthetic BA problem (bench_scaling.py:64-102), from
    default_rng(0) in its order: a forward-moving trajectory observing a
    point cloud (~n_kf * n_pt / 3 observations, or `obs_per_kf` per
    keyframe), 0.4 px noise on the observations, the poses after the first
    two and every point perturbed.  CPU tensors."""
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-6, 6, n_pt), rng.uniform(-4, 4, n_pt),
                    rng.uniform(5, 30, n_pt)], 1).astype(np.float32)
    poses = np.stack([_exp_se3(np.array(
        [0.15 * k, 0.02 * k, 0.0, 0.0, 0.01 * k, 0.0], np.float32))
        for k in range(n_kf)])
    obs_kf, obs_pt, obs_uv = [], [], []
    for k in range(n_kf):
        pc = pts @ poses[k][:3, :3].T + poses[k][:3, 3]
        uv = np.stack([pc[:, 0] / pc[:, 2] * cam.fx + cam.cx,
                       pc[:, 1] / pc[:, 2] * cam.fy + cam.cy], 1)
        vis = (pc[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < cam.width) \
            & (uv[:, 1] > 0) & (uv[:, 1] < cam.height)
        idx = np.nonzero(vis)[0]
        if obs_per_kf and idx.size > obs_per_kf:
            idx = rng.choice(idx, obs_per_kf, replace=False)
        obs_kf.append(np.full(idx.size, k, np.int32))
        obs_pt.append(idx.astype(np.int32))
        obs_uv.append(uv[idx] + rng.normal(0, 0.4, (idx.size, 2)))
    obs_kf = np.concatenate(obs_kf)
    obs_pt = np.concatenate(obs_pt)
    obs_uv = np.concatenate(obs_uv).astype(np.float32)
    poses_init = poses.copy()
    for k in range(2, n_kf):
        poses_init[k] = _exp_se3(
            rng.normal(0, 0.005, 6).astype(np.float32)) @ poses[k]
    points = pts + rng.normal(0, 0.03, pts.shape).astype(np.float32)
    return ba.BAProblem(*(torch.from_numpy(np.asarray(a)) for a in (
        poses_init, points, obs_kf, obs_pt, obs_uv,
        np.ones(obs_kf.size, np.float32), np.ones(obs_kf.size, bool),
        np.arange(n_kf) < 2)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev: torch.device, reps: int = 3):
    """(mean seconds of `reps` calls after one untimed call, last result)."""
    out = fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps, out


class Spec(NamedTuple):
    cam: CameraConfig
    prob: ba.BAProblem         # CPU tensors; each rank takes its part
    device: str                # "cuda" (rank r on card r) or "cpu"
    iters: int
    pcg_iters: int


def census(fn) -> dict:
    """Collectives of one LM iteration on this rank: `fn(1)` less `fn(0)`,
    as counted by parallel/mesh."""
    counts = []
    for iters in (0, 1):
        mesh_lib.reset_counts()
        fn(iters)
        counts.append((dict(mesh_lib.CALLS), dict(mesh_lib.PAYLOAD_BYTES)))
    (c0, b0), (c1, b1) = counts
    return {op: {"calls": c1[(op, ax)] - c0.get((op, ax), 0),
                 "bytes": b1[(op, ax)] - b0.get((op, ax), 0)}
            for op, ax in c1 if c1[(op, ax)] - c0.get((op, ax), 0)}


def solve_rank(rank: int, world: int, spec: Spec) -> dict:
    """Both distributed solvers of `spec.prob` on a (1, world) mesh: per
    mode its mean seconds, its poses (CPU) and its collective census."""
    dev = torch.device(spec.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    mesh = mesh_lib.make_mesh(1, world, dev)
    out = {}
    for mode, fn in MODES:
        def solve(iters, fn=fn):
            return fn(spec.cam, spec.prob, mesh, iters=iters,
                      pcg_iters=spec.pcg_iters)
        t, res = timed(lambda: solve(spec.iters), dev)
        out[mode] = dict(t=t, poses=res.poses.detach().cpu(),
                         census=census(solve))
    return out


def solve_world(world: int, spec: Spec) -> dict:
    """`solve_rank` on `world` ranks; rank 0's result.  A world of one runs
    in this process."""
    if world > 1:
        return mesh_lib.launch(solve_rank, world, (spec,))[0]
    if dist.is_initialized():
        raise RuntimeError("solve_world(1) runs its own world of one: "
                           "torch.distributed is already initialized")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory(prefix="coslam_scaling_") as d:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=600))
        try:
            return solve_rank(0, 1, spec)
        finally:
            dist.destroy_process_group()


def scaling_rows(spec: Spec, max_world: int) -> list:
    """The JSON rows: `ba.solve` at devices 1, then both modes at every
    world size 1, 2, 4, ... <= max_world."""
    dev = torch.device(spec.device)
    prob = ba.BAProblem(*(x.to(dev) for x in spec.prob))
    t1, ref = timed(lambda: ba.solve(spec.cam, prob, iters=spec.iters,
                                     pcg_iters=spec.pcg_iters), dev)
    ref_poses = ref.poses.detach().cpu()
    rows = [{"devices": 1, "t_solve_s": t1, "speedup_vs_1": 1.0,
             "max_pose_diff": 0.0}]
    d = 1
    while d <= max_world:
        r = solve_world(d, spec)
        for mode, _ in MODES:
            t = r[mode]["t"]
            row = {"devices": d, "mode": mode, "t_solve_s": t,
                   "speedup_vs_1": t1 / t,
                   "max_pose_diff": float((r[mode]["poses"] - ref_poses)
                                          .abs().max()),
                   "collective_census": r[mode]["census"]}
            if mode == "partitioned":
                row.update({
                    "t_per_LM_iter_ms": t / spec.iters * 1e3,
                    "modeled_collective_bytes_per_LM_iter_per_dev":
                        sharded_ba.collective_bytes_per_iter(
                            int(spec.prob.poses.shape[0]), d,
                            spec.pcg_iters),
                    "hbm_points_frac_per_dev": 1.0 / d})
            rows.append(row)
        d *= 2
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=DEFAULT_DEVICE)
    p.add_argument("--cpu-ranks", type=int, default=0,
                   help="N gloo ranks on the CPU (validates the path, not "
                        "the numbers)")
    p.add_argument("--n-kf", type=int, default=96)
    p.add_argument("--n-pt", type=int, default=12000)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--pcg-iters", type=int, default=30)
    p.add_argument("--obs-per-kf", type=int, default=0,
                   help="subsample visible observations per keyframe "
                        "(0 = keep all)")
    a = p.parse_args(argv)
    if a.cpu_ranks:
        dev, world = torch.device("cpu"), a.cpu_ranks
    else:
        dev = resolve_device(a.device)
        world = torch.cuda.device_count() if dev.type == "cuda" else 1
    prob = make_problem(a.n_kf, a.n_pt, a.obs_per_kf)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"# problem: {a.n_kf} keyframes, {a.n_pt} points, "
          f"{prob.obs_kf.numel()} observations, platform={dev.type} "
          f"({where}), {world} rank(s)", flush=True)
    spec = Spec(CAM, prob, dev.type, a.iters, a.pcg_iters)
    rows = scaling_rows(spec, world)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Command-line driver (port of coslam_tpu/cli.py) — the analogue of the
reference's ROS nodes (Examples/ROS/ORB_SLAM2/src/ros_{mono,stereo,rgbd}.cc
main()).

    python -m coslam_tpu_torch.cli mono   --dataset tum   --root <dir> --out traj.txt
    python -m coslam_tpu_torch.cli rgbd   --dataset tum   --root <dir>
    python -m coslam_tpu_torch.cli stereo --dataset kitti --root <dir> --seq 00
    python -m coslam_tpu_torch.cli mono   --dataset euroc --root <dir> --viz out/
    python -m coslam_tpu_torch.cli synthetic --frames 60
    python -m coslam_tpu_torch.cli coop --frames 90 --transport memory
    python -m coslam_tpu_torch.cli coop --role sender      # and, in another
    python -m coslam_tpu_torch.cli coop --role receiver    # process
    ... --device cpu                                       # without a GPU

Everything runs on the GPU unless `--device cpu` is given.  The dataset
modes read a TUM RGB-D, KITTI odometry or EuRoC directory (utils/io.py),
run the pipeline over it, report per-stage timing and (where the dataset
has ground truth) ATE RMSE, and export the trajectory in TUM or KITTI
format (reference System::SaveTrajectoryTUM / KITTI, System.cc:325/422).
`--viz DIR` writes frame and map renderings (viz/), the headless analogue
of the reference's Pangolin viewer.

`coop` is the analogue of the reference's sender / receiver node pair
(ORB_SLAM2.1 "Mono2" publishing keyframe batches over LCM UDP multicast,
ORB_SLAM2 "Mono" reconstructing them into its own map): two agents track
overlapping arcs of one scene, the sender publishes keyframe packets over a
bus (in memory, or the native UDP-multicast bus that replaces LCM), and
the receiver wire-reconstructs them, place-recognizes the overlap, aligns
the foreign sub-map by a Sim3 and fuses it.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np

from coslam_tpu_torch import config as cfg_mod
from coslam_tpu_torch.models.system import System
from coslam_tpu_torch.utils import evaluation, io as cio, profiling, synthetic
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE

DATASET_PRESETS = {"tum": cfg_mod.tum_fr1_config,
                   "kitti": cfg_mod.kitti_config,
                   "euroc": cfg_mod.euroc_config}


class _LazyImages:
    """List-like lazy loader so the chunked driver can consume dataset
    frames without materializing the whole sequence in RAM.  It keeps the
    last frame only (the JAX CLI's policy), so a frame the driver tracks
    again after a chunk cut is decoded again: `decodes` counts the loads
    and `decode_s` their host seconds."""

    def __init__(self, paths, loader):
        self.paths = paths
        self.loader = loader
        self._cache = (None, None)
        self.decodes = 0
        self.decode_s = 0.0

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        if self._cache[0] != i:
            t0 = time.perf_counter()
            self._cache = (i, self.loader(self.paths[i]))
            self.decode_s += time.perf_counter() - t0
            self.decodes += 1
        return self._cache[1]


def _run(slam: System, frames, mode: str, depth_factor: float,
         timer: profiling.StageTimer, limit: int, viewer=None,
         per_frame: bool = False):
    """Track `frames` (utils/io.SequenceFrame, the first `limit` where it
    is set) in `mode`: per frame when a viewer needs every frame's state or
    `per_frame` asks for it, else through the chunked driver
    (System.run_sequence).  Returns the timestamps and the lazy image
    sequences it read (left images first)."""
    frames = frames[:limit] if limit else frames
    timestamps = [fr.timestamp for fr in frames]
    imgs = _LazyImages([fr.rgb_path for fr in frames], cio.load_image)
    depths = rights = None
    if mode == "rgbd":
        depths = _LazyImages([fr.depth_path for fr in frames],
                             lambda p: cio.load_depth(p, depth_factor))
    elif mode == "stereo":
        rights = _LazyImages([fr.right_path for fr in frames],
                             cio.load_image)
    loaded = [x for x in (imgs, depths, rights) if x is not None]

    if viewer is not None or per_frame:
        for i, fr in enumerate(frames):
            img = imgs[i]
            with timer("track"):
                if mode == "mono":
                    slam.track_mono(img, i, timestamp=fr.timestamp)
                elif mode == "rgbd":
                    slam.track_rgbd(img, depths[i], i,
                                    timestamp=fr.timestamp)
                else:
                    slam.track_stereo(img, rights[i], i,
                                      timestamp=fr.timestamp)
            if viewer is not None and slam.state != "NOT_INITIALIZED":
                viewer.update(slam, img, slam.last_frame, i)
        return timestamps, loaded

    with timer("track"):
        slam.run_sequence(imgs, timestamps=timestamps, depths=depths,
                          right_images=rights)
    return timestamps, loaded


def run_dataset(mode: str, dataset: str, root: str, sequence: str = "00",
                limit: int = 0, out=None, fmt: str = "tum",
                per_frame: bool = False, viz=None, viz_every: int = 10,
                timer: profiling.StageTimer = None, device=DEFAULT_DEVICE,
                prepare=None) -> dict:
    """SLAM in `mode` (mono | rgbd | stereo) over a `dataset` (tum | kitti
    | euroc) directory: the dataset's preset configuration, its own camera
    where it has one (EuRoC's sensor.yaml), the report lines, the ATE
    against its ground truth, and the trajectory written to `out` in
    `fmt` (tum | kitti).  `prepare(slam)` is called on the new System
    before the first frame.  Returns the System, the timestamps, the
    tracked frame ids and poses, the ATE (or None) and the decode counts."""
    timer = timer or profiling.StageTimer(device=device)
    if dataset == "tum":
        seq = cio.load_tum_rgbd(root)
    elif dataset == "kitti":
        seq = cio.load_kitti(root, sequence)
    else:
        seq = cio.load_euroc(root)
    cfg = DATASET_PRESETS[dataset]()
    if seq.camera is not None:
        cfg = cfg.replace(camera=seq.camera)  # dataset-provided calibration
    cfg = cfg.replace(sensor=mode)

    viewer = None
    if viz:
        from coslam_tpu_torch.viz import Viewer
        viewer = Viewer(viz, every=viz_every)
    slam = System(cfg, device=device)
    if prepare is not None:
        prepare(slam)
    timestamps, loaded = _run(slam, seq.frames, mode, seq.depth_factor,
                              timer, limit, viewer, per_frame=per_frame)
    ids, poses = slam.trajectory_poses()
    print(timer.report())
    print(f"frames tracked: {len(ids)} / {len(timestamps)}"
          f"  keyframes: {int(slam.map.n_kf)}"
          f"  map points: {int(slam.map.pt_valid.sum())}")
    ate = None
    if seq.gt_poses_wc is not None and len(ids) > 10:
        # ground truth matched by the nearest timestamp
        ts = np.asarray([timestamps[i] for i in ids])
        gt_idx = np.argmin(np.abs(seq.gt_timestamps[None, :]
                                  - ts[:, None]), axis=1)
        ate = evaluation.ate_rmse(evaluation.trajectory_xyz(poses),
                                  seq.gt_poses_wc[gt_idx][:, :3, 3],
                                  with_scale=(mode == "mono"))
        print(f"ATE RMSE: {ate * 100:.2f} cm")
    if out:
        ts = [timestamps[i] for i in ids]
        if fmt == "tum":
            cio.save_trajectory_tum(out, ts, poses)
        else:
            cio.save_trajectory_kitti(out, poses)
        print(f"trajectory written to {out}")
    return {"slam": slam, "timestamps": timestamps, "ids": ids,
            "poses": poses, "ate": ate,
            "decodes": sum(x.decodes for x in loaded),
            "decode_s": sum(x.decode_s for x in loaded)}


def _coop_setup(frames: int, seed: int, camera=None, extractor=None):
    """Scene, trajectory and configuration shared by the cooperating agents
    — both processes of a two-process run derive identical inputs from the
    seed.  `camera` / `extractor` replace the defaults (320x240, 400
    features), which are the JAX package's CLI's.  Returns (cfg,
    trajectory, frames, receiver's last frame + 1, sender's first
    frame)."""
    cfg = cfg_mod.SystemConfig(
        camera=camera or cfg_mod.CameraConfig(fx=300, fy=300, cx=160,
                                              cy=120, width=320, height=240),
        extractor=extractor or cfg_mod.ExtractorConfig(n_features=400,
                                                       max_keypoints=512),
        mapper=cfg_mod.MapperConfig(max_keyframes=128, max_points=32768),
        # merge verification at genuine-overlap strength: true cross-agent
        # pairs carry 80+ matched landmarks, while descriptor aliasing on
        # repetitive texture can scrape past ~12-15 — loose gates let a
        # spurious Sim3 commit before the arcs overlap
        loop=cfg_mod.LoopConfig(min_kfs_between_loops=15,
                                sim3_min_bow_matches=25, sim3_min_inliers=20),
        tracker=cfg_mod.TrackerConfig(init_min_matches=60, init_min_good=35))
    scene = synthetic.make_cylinder_scene(700, seed=seed)
    traj = synthetic.make_loop_trajectory(frames, seed=seed, frac=0.72)
    seq = synthetic.render_sequence(cfg.camera, traj, scene)
    # overlapping arcs: the receiver covers the first half, the sender the
    # last ~2/3
    split0 = max(int(frames * 0.50), 12)
    start1 = max(int(frames * 0.33), 8)
    return cfg, traj, seq, split0, start1


def _coop_report(a0, traj, timer) -> dict:
    from coslam_tpu_torch.models import map_state as ms

    m = a0.map
    K = int(m.n_kf)
    valid = m.kf_valid[:K].cpu().numpy()
    fid = m.kf_frame_id[:K].cpu().numpy()
    agent = np.asarray(a0.kf_agent[:K])
    centers = ms.kf_centers(m).cpu().numpy()[:K]
    gt = evaluation.trajectory_xyz(traj.poses_cw[fid])
    res = {
        "merges": a0.n_merges,
        "kf_own": int((valid & (agent == a0.agent_id)).sum()),
        "kf_foreign": int((valid & (agent != a0.agent_id)
                           & (agent >= 0)).sum()),
        "map_points": int(m.pt_valid.sum()),
    }
    if valid.sum() > 3:
        res["ate_joint_m"] = float(
            evaluation.ate_rmse(centers[valid], gt[valid]))
    print(timer.report())
    print(f"agent{a0.agent_id}: merges={res['merges']}  "
          f"own KFs={res['kf_own']}  foreign KFs={res['kf_foreign']}  "
          f"map points={res['map_points']}")
    if "ate_joint_m" in res:
        print(f"joint map ATE RMSE: {res['ate_joint_m'] * 100:.2f} cm")
    return res


def run_coop_role(role: str, frames: int = 90, publish_every: int = 8,
                  max_batch: int = 10, seed: int = 5, linger: float = 60.0,
                  timer: profiling.StageTimer = None,
                  device=DEFAULT_DEVICE, bus_port: int = 7667,
                  bus_channel: str = "KeyFrameexample") -> dict:
    """One HALF of the cooperative pair over the native UDP-multicast bus —
    run `coop --role sender` and `coop --role receiver` as two processes,
    like the reference's Mono2 / Mono node pair, on one `bus_port` and
    `bus_channel`.  The receiver keeps polling the bus for up to `linger`
    seconds after its own arc ends, to integrate keyframes the sender
    publishes late (the analogue of the receiver's blocking lcm.handle()
    loop, ros_mono.cc:607-609)."""
    from coslam_tpu_torch.models.cooperative import CoopAgent, UdpBus

    if role not in ("sender", "receiver"):
        raise ValueError(f"role {role!r}: 'sender' or 'receiver'")
    timer = timer or profiling.StageTimer(device=device)
    # bind before rendering: a sender publishing into a group that the
    # receiver has not joined yet loses those packets without an error
    bus = UdpBus(port=bus_port, channel=bus_channel)
    print(f"{role}: listening on the bus", flush=True)
    try:
        cfg, traj, seq, split0, start1 = _coop_setup(frames, seed)
        if role == "sender":
            a1 = CoopAgent(cfg, 1, device=device, enable_loop_closing=False)
            for i, f in enumerate(range(start1, frames)):
                with timer("track"):
                    a1.track_mono(seq[f], f)
                if i and i % publish_every == 0:
                    with timer("publish"):
                        bus.publish(1, a1.drain_packets(max_batch=max_batch))
            bus.publish(1, a1.drain_packets(max_batch=1000))
            print(timer.report())
            res = {"kf_published": a1._published_kfs, "state": a1.state}
            print(f"sender: published {res['kf_published']} keyframes "
                  f"(state {res['state']})")
            return res

        a0 = CoopAgent(cfg, 0, device=device, enable_loop_closing=False)
        # packets that arrive before the local map is initialised are
        # buffered, not dropped (the reference's Map_KFV staging map,
        # ros_mono.cc:178,540)
        pending = []
        received = [0]

        def drain_into(timeout_ms=50):
            pending.extend(bus.drain(0, timeout_ms=timeout_ms))
            n = 0
            if a0.state == "OK":
                while pending:
                    with timer("integrate"):
                        a0.receive_packet(pending.pop(0))
                    n += 1
            received[0] += n
            return n

        for f in range(split0):
            with timer("track"):
                a0.track_mono(seq[f], f)
            drain_into()
        # linger: the sender may still be tracking / publishing
        deadline = time.monotonic() + linger
        idle_since = None
        while time.monotonic() < deadline:
            got = drain_into(timeout_ms=300)
            now = time.monotonic()
            if got:
                idle_since = None
            else:
                idle_since = idle_since or now
                if a0.n_merges and now - idle_since > 5.0:
                    break  # merged and the bus has gone quiet
        res = _coop_report(a0, traj, timer)
        res.update(kf_received=received[0], state=a0.state)
        print(f"receiver: integrated {received[0]} foreign keyframes "
              f"(state {a0.state})")
        return res
    finally:
        bus.close()


def drive_coop(a0, a1, seq, split0: int, start1: int, bus,
               publish_every: int = 8, max_batch: int = 10,
               bidirectional: bool = False, timer=None,
               drain_kw=None) -> None:
    """The in-process two-agent loop of `run_coop`: agent 0 tracks frames
    0 .. split0 - 1, agent 1 frames start1 .. len(seq) - 1, side by side;
    every `publish_every` steps, and twice at the end, agent 1 publishes up
    to `max_batch` keyframes and agent 0 integrates what it has received."""
    timer = timer or profiling.StageTimer(sync=False, device="cpu")
    drain_kw = drain_kw or {}
    frames = len(seq)
    # packets that arrive before a receiver's map initialises are buffered,
    # not dropped (the reference's Map_KFV staging map, ros_mono.cc:178,540)
    pending = {0: [], 1: []}

    def publish(sender, agent):
        with profiling.span("coop.publish") as sp:
            pkts = agent.drain_packets(max_batch=max_batch)
            bus.publish(sender, pkts, subscribers=[0, 1])
            sp.set(packets=len(pkts))

    def drain(agent_id):
        with profiling.span("coop.drain") as sp:
            got = bus.drain(agent_id, **drain_kw)
            sp.set(packets=len(got))
        pending[agent_id].extend(got)

    def pump():
        with timer("exchange"):
            publish(1, a1)
            if bidirectional:
                publish(0, a0)
                drain(1)
                if a1.state == "OK":
                    while pending[1]:
                        a1.receive_packet(pending[1].pop(0))
            drain(0)
            if a0.state == "OK":
                while pending[0]:
                    a0.receive_packet(pending[0].pop(0))

    for i in range(max(split0, frames - start1)):
        f0, f1 = i, start1 + i
        if f0 < split0:
            with timer("track.agent0"):
                a0.track_mono(seq[f0], f0)
        if f1 < frames:
            with timer("track.agent1"):
                a1.track_mono(seq[f1], f1)
        if i and i % publish_every == 0:
            pump()
    pump()
    pump()  # second round: packets published before the receiver was ready


def run_coop(frames: int = 90, transport: str = "memory",
             publish_every: int = 8, max_batch: int = 10,
             bidirectional: bool = False, seed: int = 5,
             timer: profiling.StageTimer = None,
             device=DEFAULT_DEVICE) -> dict:
    """Two cooperating agents on overlapping arcs of one scene, in-process.

    Agent 1 plays the reference's sender (ORB_SLAM2.1: batches of <= 10
    keyframes published periodically, ros_mono.cc:1915-2399); agent 0 the
    receiver (ORB_SLAM2: wire reconstruction + back-end integration,
    ros_mono.cc:2108-2192).  Returns a result dict (also printed)."""
    from coslam_tpu_torch.models.cooperative import (CoopAgent, InMemoryBus,
                                                     UdpBus)

    timer = timer or profiling.StageTimer(device=device)
    cfg, traj, seq, split0, start1 = _coop_setup(frames, seed)
    a0 = CoopAgent(cfg, 0, device=device, enable_loop_closing=False)
    a1 = CoopAgent(cfg, 1, device=device, enable_loop_closing=False)
    bus = UdpBus() if transport == "udp" else InMemoryBus()
    try:
        drive_coop(a0, a1, seq, split0, start1, bus, publish_every,
                   max_batch, bidirectional, timer,
                   {"timeout_ms": 50} if transport == "udp" else None)
        return _coop_report(a0, traj, timer)
    finally:
        if transport == "udp":
            bus.close()


def run_synthetic(frames: int, timer: profiling.StageTimer,
                  device=DEFAULT_DEVICE, per_frame: bool = False,
                  out=None, viewer=None) -> dict:
    """Monocular SLAM over a rendered sequence (640x480, 500 features);
    per frame when `per_frame` is set or a `viewer` draws every frame."""
    cfg = cfg_mod.SystemConfig(
        camera=cfg_mod.CameraConfig(fx=400, fy=400, cx=320, cy=240,
                                    width=640, height=480),
        extractor=cfg_mod.ExtractorConfig(n_features=500, max_keypoints=512),
        mapper=cfg_mod.MapperConfig(max_keyframes=64, max_points=8192))
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(frames, seed=3)
    seq_imgs = synthetic.render_sequence(cfg.camera, traj, scene)
    slam = System(cfg, device=device)
    if viewer is not None or per_frame:
        for i, img in enumerate(seq_imgs):
            with timer("track"):
                slam.track_mono(img, i)
            if viewer is not None and slam.state != "NOT_INITIALIZED":
                viewer.update(slam, img, slam.last_frame, i)
    else:
        with timer("track"):
            slam.run_sequence(list(seq_imgs))
    ids, poses = slam.trajectory_poses()
    ate = evaluation.ate_rmse(evaluation.trajectory_xyz(poses),
                              evaluation.trajectory_xyz(traj.poses_cw[ids]))
    print(timer.report())
    print(f"frames tracked: {len(ids)}  keyframes: {int(slam.map.n_kf)}"
          f"  map points: {int(slam.map.pt_valid.sum())}")
    print(f"ATE RMSE: {ate * 100:.2f} cm")
    if out:
        cio.save_trajectory_tum(out, list(range(len(ids))), poses)
    return {"frames": len(ids), "ate_m": float(ate)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode",
                   choices=["mono", "rgbd", "stereo", "synthetic", "coop"])
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device: the GPU unless `cpu` is given")
    p.add_argument("--dataset", choices=["tum", "kitti", "euroc"],
                   default="tum")
    p.add_argument("--root", help="dataset root directory")
    p.add_argument("--seq", default="00", help="KITTI sequence")
    p.add_argument("--out", default=None, help="trajectory output path")
    p.add_argument("--format", choices=["tum", "kitti"], default="tum")
    p.add_argument("--limit", type=int, default=0, help="max frames")
    p.add_argument("--frames", type=int, default=60,
                   help="synthetic sequence length")
    p.add_argument("--viz", default=None, metavar="DIR",
                   help="write frame/map renderings to DIR (the headless "
                        "analogue of the reference's Pangolin viewer)")
    p.add_argument("--viz-every", type=int, default=10)
    p.add_argument("--transport", choices=["memory", "udp"], default="memory",
                   help="coop mode: in-memory bus or native UDP multicast "
                        "(the LCM replacement)")
    p.add_argument("--publish-every", type=int, default=8,
                   help="coop mode: frames between keyframe-batch publishes "
                        "(reference cadence: every 500 viewer ticks)")
    p.add_argument("--bidirectional", action="store_true",
                   help="coop mode: both agents publish AND receive")
    p.add_argument("--role", choices=["both", "sender", "receiver"],
                   default="both",
                   help="coop mode: run both agents in-process, or one half "
                        "of a two-process pair over UDP multicast")
    p.add_argument("--bus-port", type=int, default=7667,
                   help="coop --role: the UDP port of the multicast bus")
    p.add_argument("--bus-channel", default="KeyFrameexample",
                   help="coop --role: the bus channel both halves use "
                        "(the reference's LCM channel by default)")
    p.add_argument("--linger", type=float, default=60.0,
                   help="coop receiver: seconds to keep polling the bus "
                        "after its own arc ends")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="record the run with torch.profiler into "
                        "DIR/trace.json (utils/profiling.trace)")
    p.add_argument("--per-frame", action="store_true",
                   help="drive tracking one frame per call instead of the "
                        "chunked driver (System.run_sequence)")
    p.add_argument("--no-warmup", action="store_true",
                   help="accepted for the JAX CLI's command lines and "
                        "ignored: the port compiles nothing ahead of time "
                        "and builds its CUDA kernels at first use")
    args = p.parse_args(argv)
    if args.mode in ("mono", "rgbd", "stereo") and not args.root:
        p.error("--root required for dataset modes")

    with contextlib.ExitStack() as stack:
        if args.profile:
            stack.enter_context(profiling.trace(args.profile))
        timer = profiling.StageTimer(device=args.device)
        if args.mode == "coop":
            if args.role != "both":
                run_coop_role(args.role, frames=args.frames,
                              publish_every=args.publish_every,
                              linger=args.linger, timer=timer,
                              device=args.device, bus_port=args.bus_port,
                              bus_channel=args.bus_channel)
            else:
                run_coop(frames=args.frames, transport=args.transport,
                         publish_every=args.publish_every,
                         bidirectional=args.bidirectional, timer=timer,
                         device=args.device)
        elif args.mode == "synthetic":
            viewer = None
            if args.viz:
                from coslam_tpu_torch.viz import Viewer
                viewer = Viewer(args.viz, every=args.viz_every)
            run_synthetic(args.frames, timer, args.device, args.per_frame,
                          args.out, viewer)
        else:
            run_dataset(args.mode, args.dataset, args.root, args.seq,
                        args.limit, args.out, args.format, args.per_frame,
                        args.viz, args.viz_every, timer, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

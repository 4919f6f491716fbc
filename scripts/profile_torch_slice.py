"""Where the time goes in the port's smoke paths on one GPU.

Default: the chip_smoke.py localization slice (resume
coslam_tpu_torch/assets/smoke_map.npz, localization mode, run_sequence over
frames 80-119, 640x480 / 1000 features / P=32768).  With --mapping: the
chip_smoke.py mapping run (frames 0-119 from the first frame, K=64 /
P=16384, the JAX run's initialisation draws injected), plus a split of the
wall time into initialisation attempts, backend inserts and the rest
(synchronised host clock around each stage) and the Python lines where the
run blocks on the device (CUDA sync debug mode).  With --loop: the
chip_smoke.py loop run (115 frames round the cylinder scene from the first
frame, K=96 / P=16384, loop closing on), plus a split of the wall time into
the loop closer's stages (`on_keyframe` with `correct_loop` inside it,
`global_ba`; synchronised host clock around each) and a profile of the
closing call alone on the saved map (smoke_loop_map.npz): device busy
against the call's wall time, i.e. how much of a closure is host dispatch,
and its kernel count.  The whole loop run is not put under the profiler: its
million kernel events take the profiler longer than a quarter of an hour.
With --stereo / --rgbd: chip_smoke.py's phase 7 / 8 run (60 frames, KITTI
stereo at 1241x376 / RGB-D at 640x480, 1000 features, K=64 / P=16384),
with the device time of the stereo functions (`match_stereo` with
`_sad_subpixel` inside it, `rgbd_depth`), each under a
torch.profiler.record_function range.  With --coop: chip_smoke.py's phase
10 (b) workload (two agents on the cylinder scene, 640x480 / 1000
features, K=128 / P=32768, packets carried as their wire bytes), plus a
profile of the call that merges the two maps (`CoopAgent._try_merge`) and
of the first `receive_packet` after the merge: device busy against the
call's wall time and its kernel count.  With --hot-path: the bench's hot
path (`coslam_tpu_torch/bench.py`: 64 `track_step`s over the bench's
frames captured as one CUDA graph), one replay of the graph.

Each path runs once to warm up, once unprofiled, then once under
torch.profiler, and the script prints:
  * wall time and frames/s of the profiled run (host clock, synchronised);
  * device busy time (sum of kernel times; one stream, so no overlap) and
    the device idle share of the wall time;
  * the port's three kernels' device time, launches and launches per frame,
    and the top kernels and operators by device time;
  * the count of host-side sync points the profiler saw (stream
    synchronizations, memcpys, .item() calls).

    python3 scripts/profile_torch_slice.py [--mapping | --loop | --stereo |
                                            --rgbd | --coop | --hot-path]
"""

from __future__ import annotations

import collections
import os
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (ASSETS, COOP_FRAMES, DEPTH_FRAMES,  # noqa: E402
                        LOC_FRAMES, LOOP_FRAMES, LOOP_SEED, MAPPING_FRAMES,
                        WireBus, coop_setup, depth_config, depth_frames,
                        loop_config, mapping_config, saved_map_closer,
                        smoke_config)

STEREO_RANGES = ("match_stereo", "_sad_subpixel", "rgbd_depth")


def depth_runner(sensor: str):
    """run() for the stereo / RGB-D path, its stereo functions wrapped in
    profiler ranges."""
    from torch.profiler import record_function

    from coslam_tpu_torch.models.system import System
    from coslam_tpu_torch.ops import stereo

    for name in STEREO_RANGES:
        def ranged(*a, _fn=getattr(stereo, name), _name=name, **kw):
            with record_function(_name):
                return _fn(*a, **kw)
        setattr(stereo, name, ranged)
    cfg = depth_config(sensor)
    left, aux, _ = depth_frames(cfg, DEPTH_FRAMES)
    kw = {"right_images" if sensor == "stereo" else "depths": aux}

    def run():
        s = System(cfg, device="cuda",
                   enable_loop_closing=sensor == "stereo")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run_sequence(left, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return run, None, DEPTH_FRAMES


def mapping_runner(scene, traj):
    """run() for the mapping path, and the split / sync-site report."""
    from coslam_tpu_torch.models import local_mapping as lm
    from coslam_tpu_torch.models import system as sysmod
    from coslam_tpu_torch.utils import synthetic

    cfg = mapping_config()
    seq = synthetic.render_sequence(
        cfg.camera, synthetic.Trajectory(traj.poses_cw[:MAPPING_FRAMES]),
        scene)
    exp = np.load(os.path.join(ASSETS, "smoke_mapping_expected.npz"))
    draws = {int(f): d.astype(np.int64)
             for f, d in zip(exp["draw_frames"], exp["draws"])}

    def run():
        s = sysmod.System(cfg, device="cuda", enable_loop_closing=False)
        s.init_draws = draws
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run_sequence(seq)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def split():
        spent = collections.Counter()
        calls = collections.Counter()
        inner = {"init": sysmod._init_attempt, "insert": lm.backend_insert}

        def timed(name):
            def fn(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner[name](*a, **kw)
                torch.cuda.synchronize()
                spent[name] += time.perf_counter() - t0
                calls[name] += 1
                return out
            return fn

        sysmod._init_attempt = timed("init")
        lm.backend_insert = timed("insert")
        try:
            wall = run()
        finally:
            sysmod._init_attempt = inner["init"]
            lm.backend_insert = inner["insert"]
        rest = wall - spent["init"] - spent["insert"]
        print(f"split run (synchronised around each stage): {wall:.4f} s; "
              f"initialisation {spent['init']:.4f} s over {calls['init']} "
              f"attempts ({1e3 * spent['init'] / max(calls['init'], 1):.2f} "
              f"ms each); backend inserts {spent['insert']:.4f} s over "
              f"{calls['insert']} ({1e3 * spent['insert'] / max(calls['insert'], 1):.2f} "
              f"ms each); tracking and driver {rest:.4f} s")
        sites = collections.Counter()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for w in caught:
            if "synchroniz" in str(w.message):
                sites[f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"] += 1
        print(f"host syncs seen by CUDA sync debug mode: "
              f"{sum(sites.values())}; by line: {sites.most_common(12)}")

    return run, split, MAPPING_FRAMES


def loop_runner():
    """run() for the loop path, and the split of a closure's time."""
    from torch.profiler import ProfilerActivity, profile

    from coslam_tpu_torch.models import loop_closing as lc
    from coslam_tpu_torch.models.system import System
    from coslam_tpu_torch.utils import checkpoint, synthetic

    cfg = loop_config()
    exp = np.load(os.path.join(ASSETS, "smoke_loop_expected.npz"))
    draws = {int(f): d.astype(np.int64)
             for f, d in zip(exp["draw_frames"], exp["draws"])}
    scene = synthetic.make_cylinder_scene(700, seed=LOOP_SEED)
    traj = synthetic.make_loop_trajectory(LOOP_FRAMES, seed=LOOP_SEED,
                                          frac=1.25)
    seq = synthetic.render_sequence(cfg.camera, traj, scene)

    def run():
        s = System(cfg, device="cuda", enable_loop_closing=True)
        s.init_draws = draws
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run_sequence(seq)
        s.shutdown()
        return time.perf_counter() - t0

    def split():
        spent = collections.Counter()
        calls = collections.Counter()
        inner = {"on_keyframe": lc.LoopCloser.on_keyframe,
                 "correct_loop": lc.correct_loop, "global_ba": lc.global_ba}

        def timed(name):
            def fn(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner[name](*a, **kw)
                torch.cuda.synchronize()
                spent[name] += time.perf_counter() - t0
                calls[name] += 1
                return out
            return fn

        lc.LoopCloser.on_keyframe = timed("on_keyframe")
        lc.correct_loop = timed("correct_loop")
        lc.global_ba = timed("global_ba")
        try:
            wall = run()
        finally:
            lc.LoopCloser.on_keyframe = inner["on_keyframe"]
            lc.correct_loop = inner["correct_loop"]
            lc.global_ba = inner["global_ba"]
        print(f"split run (synchronised around each stage): {wall:.4f} s; "
              + "; ".join(f"{k} {spent[k]:.4f} s over {calls[k]} calls "
                          f"({1e3 * spent[k] / max(calls[k], 1):.2f} ms each)"
                          for k in inner)
              + " (correct_loop is inside on_keyframe)")

        # the closing call alone, on the saved map
        m, ex = checkpoint.load_map(os.path.join(ASSETS,
                                                 "smoke_loop_map.npz"),
                                    device="cuda")

        def closure():
            c = saved_map_closer(cfg, ex)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m2, closed = c.on_keyframe(m, int(ex["kf_id"]),
                                       covis_row=ex["covis_row"])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            c.maybe_run_gba(m2)
            torch.cuda.synchronize()
            assert closed
            return t1 - t0, time.perf_counter() - t1

        closure()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t_close, t_gba = closure()
        ev = prof.key_averages()
        busy = sum(e.self_device_time_total for e in ev
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        n_k = sum(e.count for e in ev
                  if e.device_type == torch.autograd.DeviceType.CUDA)
        print(f"closing call on the saved map (profiled): on_keyframe "
              f"{1e3 * t_close:.2f} ms + global_ba {1e3 * t_gba:.2f} ms wall; "
              f"device busy {busy / 1e3:.3f} ms in {n_k} kernels "
              f"({busy / max(n_k, 1):.2f} us each): device idle share "
              f"{1 - busy / 1e6 / (t_close + t_gba):.4f}")
        print(ev.table(sort_by="self_cuda_time_total", row_limit=12,
                       max_name_column_width=60))

    return run, split, LOOP_FRAMES


def hot_path_runner(batch: int = 64):
    """One replay of the bench's hot path graph: `batch` track_steps."""
    from coslam_tpu_torch import bench, entry
    dev = torch.device("cuda")
    step, example = entry.entry(dev)
    imgs = torch.from_numpy(bench.hot_path_frames(0, batch)).to(dev)
    g = bench.capture(bench.frame_loop(step, imgs, example[1:]), dev)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.replay()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return run, None, batch


def _device_summary(prof, wall_s: float) -> str:
    """Device busy time, idle share of `wall_s`, kernel count and the
    port's three kernels of one profiled region."""
    ev = prof.key_averages()
    cuda = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in cuda)
    n_k = sum(e.count for e in cuda)
    mine = []
    for tag in ("fast_score_nms", "masked_match", "pose_opt_lm"):
        sel = [e for e in cuda if tag in e.key]
        us = sum(e.self_device_time_total for e in sel)
        mine.append(f"{tag} {sum(e.count for e in sel)} launches "
                    f"{us / 1e3:.3f} ms")
    return (f"{1e3 * wall_s:.2f} ms wall; device busy {busy / 1e3:.3f} ms in "
            f"{n_k} kernels ({busy / max(n_k, 1):.2f} us each): device idle "
            f"share {1 - busy / 1e6 / wall_s:.4f}; {', '.join(mine)}")


def coop_runner():
    """run() for chip_smoke.py's phase 10 (b) workload, and a profile of
    its merging call and of the first packet integrated after the merge."""
    from torch.profiler import ProfilerActivity, profile

    from coslam_tpu_torch import cli
    from coslam_tpu_torch.models.cooperative import CoopAgent

    cfg, _traj, seq, split0, start1 = coop_setup()
    exp = np.load(os.path.join(ASSETS, "smoke_coop_expected.npz"))

    def agents():
        out = []
        for aid, tag in ((0, "r"), (1, "s")):
            a = CoopAgent(cfg, aid, device="cuda", enable_loop_closing=False)
            a.init_draws = {int(f): d.astype(np.int64) for f, d in zip(
                exp[f"{tag}_draw_frames"], exp[f"{tag}_draws"])}
            out.append(a)
        return out

    def run():
        a0, a1 = agents()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.drive_coop(a0, a1, seq, split0, start1, WireBus())
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def profiled(fn, *a):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return out, prof, wall

    def split():
        a0, a1 = agents()
        kept = {}
        inner_merge = a0._try_merge

        def merge(fk, aid):
            if a0.n_merges:
                return inner_merge(fk, aid)
            ok, prof, wall = profiled(inner_merge, fk, aid)
            if ok:
                kept["merge"] = (prof, wall, fk)
            return ok

        inner_receive = a0.receive_packet

        def receive(pkt):
            if a0.n_merges and "after" not in kept:
                out, prof, wall = profiled(inner_receive, pkt)
                kept["after"] = (prof, wall, pkt.frame_id)
                return out
            return inner_receive(pkt)

        a0._try_merge, a0.receive_packet = merge, receive
        cli.drive_coop(a0, a1, seq, split0, start1, WireBus())
        if "merge" in kept:
            prof, wall, fk = kept["merge"]
            print(f"the merging call (_try_merge of foreign keyframe {fk}, "
                  f"profiled): {_device_summary(prof, wall)}")
            print(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=12,
                max_name_column_width=60))
        if "after" in kept:
            prof, wall, f = kept["after"]
            print(f"the first receive_packet after the merge (sender frame "
                  f"{f}, profiled): {_device_summary(prof, wall)}")
            print(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=12,
                max_name_column_width=60))

    return run, split, split0 + COOP_FRAMES - start1


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

    n = hi - lo
    split = None
    if "--mapping" in sys.argv:
        run, split, n = mapping_runner(scene, traj)
    elif "--loop" in sys.argv:
        run, split, n = loop_runner()
    elif "--stereo" in sys.argv or "--rgbd" in sys.argv:
        run, split, n = depth_runner(
            "stereo" if "--stereo" in sys.argv else "rgbd")
    elif "--coop" in sys.argv:
        run, split, n = coop_runner()
    elif "--hot-path" in sys.argv:
        run, split, n = hot_path_runner()
    run()
    plain_wall = run()
    if split is not None:
        split()
    if "--loop" in sys.argv or "--coop" in sys.argv:
        print(f"unprofiled run: {plain_wall:.4f} s, {n / plain_wall:.2f} "
              "frames/s")
        return 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
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
    for tag in ("fast_score_nms", "masked_match", "pose_opt_lm"):
        mine = [e for e in events if tag in e.key
                and e.device_type == torch.autograd.DeviceType.CUDA]
        us, count = (sum(e.self_device_time_total for e in mine),
                     sum(e.count for e in mine))
        print(f"kernel {tag}: {us / 1e3:.3f} ms in {count} launches "
              f"({us / max(count, 1):.2f} us each, {count / n:.2f} per frame)")
    for e in events:
        if e.key in STEREO_RANGES:
            dev = getattr(e, "device_time_total", None)
            if dev is None:
                dev = e.cuda_time_total
            per = dev / max(e.count, 1) / 1e3
            if e.cpu_time_total > 0:
                # the host-side range: the device time of its kernels
                print(f"range {e.key}: {e.count} calls, kernels {dev / 1e3:.3f}"
                      f" ms of device time ({per:.4f} ms a call), host "
                      f"{e.cpu_time_total / 1e3:.3f} ms "
                      f"({e.cpu_time_total / max(e.count, 1) / 1e3:.4f} ms "
                      f"a call)")
            else:
                # its annotation on the device timeline: first kernel's
                # start to last kernel's end, idle gaps included
                print(f"range {e.key}: {e.count} calls, span on the device "
                      f"timeline {dev / 1e3:.3f} ms ({per:.4f} ms a call, "
                      f"idle gaps included)")
    print(events.table(sort_by="self_cuda_time_total", row_limit=25,
                       max_name_column_width=60))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

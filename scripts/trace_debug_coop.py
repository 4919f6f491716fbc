"""Where the two-agent repro of scripts/debug_coop.py parts ways between the
JAX package and the port.

    python3 scripts/trace_debug_coop.py [--jax] [--device cuda|cpu]
                                        [--frames N] [--draws FILE]
                                        [--jax-key N]

Runs debug_coop's schedule (agent 0 maps frames 0-37, agent 1 tracks
frames 30-79 and publishes every 8 frames into agent 0) in the port on
--device (default cuda) or, with --jax, in the JAX package on the CPU,
and prints what decides where the first cross-agent merge happens:

  * every monocular initialisation attempt (reference frame, frame,
    success, matches, good points, keypoints: `_init_attempt`'s scalars);
  * after every frame, each agent's state, tracked inliers, the reference
    keyframe's matches, frames since its last keyframe and keyframe count:
    the inputs of the mono keyframe test (`System._need_keyframe`, c2:
    inliers < 0.9 of the reference's matches; debug_coop's config pins the
    mapper latency at 0 frames, so the host's clock plays no part);
  * at every publish, the keyframes agent 1 sent, and for each packet
    agent 0 received whether it merged, with the stages of the cross-agent
    place recognition it ran (`_find_cross_sim3`): the BoW shortlist's
    keypoint match counts, the landmark pairs of the best three against
    `sim3_min_bow_matches`, the Sim3 RANSAC's inliers and scale, and the
    refined inliers and scale against `sim3_min_inliers`;
  * the final merges, events and joint ATE (debug_coop's `final:` line).

The two packages draw their RANSAC samples from different generators.
With --jax --draws FILE the JAX run saves the sample indices of every
initialisation attempt (`jax.random.choice` with the key of
models/system.py:355, as scripts/make_torch_smoke_assets.py records them);
a port run with --draws FILE injects them (`System.init_draws`), so that
both start from the same hypotheses.  --jax --jax-key N draws the JAX
agents' initialisation samples from PRNGKey(N) instead of the package's
PRNGKey(0): the JAX package against itself with other draws.  --frames
cuts agent 1's run short (default: to frame 79, the script's).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def load_package(use_jax: bool):
    """(debug_coop module, InMemoryBus, synthetic) of one package."""
    if use_jax:
        spec = importlib.util.spec_from_file_location(
            "jax_debug_coop", os.path.join(ROOT, "scripts", "debug_coop.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        from coslam_tpu.models.cooperative import InMemoryBus
        from coslam_tpu.utils import synthetic
    else:
        from coslam_tpu_torch.models.cooperative import InMemoryBus
        from coslam_tpu_torch.scripts import debug_coop as mod
        from coslam_tpu_torch.utils import synthetic
    return mod, InMemoryBus, synthetic


def trace_init_attempts(use_jax: bool) -> None:
    """Print the scalars of every `_init_attempt` of the package."""
    if use_jax:
        from coslam_tpu.models import system as sysmod
    else:
        from coslam_tpu_torch.models import system as sysmod
    inner = sysmod._init_attempt

    def attempt(cfg, m, f0, f1, fid0, fid1, *a, **kw):
        out = inner(cfg, m, f0, f1, fid0, fid1, *a, **kw)
        ok, n_m, n_pts, n_kp = (int(v) for v in out[2])
        print(f"  init attempt {int(fid0)} -> {int(fid1)}: success={ok} "
              f"matches={n_m} good={n_pts} keypoints={n_kp}", flush=True)
        return out

    sysmod._init_attempt = attempt


def trace_cross_stages(use_jax: bool, on: list) -> None:
    """Print the stages of `_find_cross_sim3` while on[0] is true."""
    if use_jax:
        from coslam_tpu.models import loop_closing as lc
    else:
        from coslam_tpu_torch.models import loop_closing as lc

    def wrap(name, show):
        inner = getattr(lc, name)

        def f(*a, **kw):
            out = inner(*a, **kw)
            if on[0]:
                print(f"    {name}: {show(a, out)}", flush=True)
            return out
        setattr(lc, name, f)

    def ints(x):
        return np.asarray(x.cpu() if hasattr(x, "cpu") else x).tolist()

    def sim3(a, res):
        return (f"kf {int(a[2])} vs {int(a[3])}: inliers "
                f"{int(ints(res.n_inliers))} s {float(ints(res.s)):.4f}")

    wrap("match_counts_subset",
         lambda a, out: f"kf {int(a[2])} vs {ints(a[3])}: {ints(out)}")
    wrap("match_pair_points",
         lambda a, out: f"kf {int(a[2])} vs {int(a[3])}: "
                        f"{int(ints(out[3].sum()))} landmark pairs")
    wrap("sim3_between", sim3)
    wrap("sim3_refine_pairs", sim3)


def record_jax_draws(agent, draws: dict) -> None:
    """Record the JAX agent's initialisation draws into
    draws["<agent>_<frame>"] (as scripts/make_torch_smoke_assets.
    DrawRecordingSystem records them)."""
    import jax
    import jax.numpy as jnp
    from coslam_tpu.models import system as jsystem
    inner = agent._try_initialize

    def try_initialize(frame, frame_id):
        if agent.ref_frame is not None:
            mm = jsystem._match_for_init(agent.cfg, agent.ref_frame, frame)
            p = mm.valid.astype(jnp.float32)
            p = p / (p.sum() + 1e-9)
            key = jax.random.fold_in(agent._init_key, frame_id)
            draws[f"{agent.agent_id}_{frame_id}"] = np.asarray(
                jax.random.choice(key, frame.uv.shape[0],
                                  (agent.cfg.tracker.ransac_iters, 8),
                                  replace=True, p=p), np.int32)
        return inner(frame, frame_id)

    agent._try_initialize = try_initialize


def frame_line(agent, i) -> str:
    inl = agent.stats[-1]["inliers"] if agent.stats else "-"
    return (f"a{agent.agent_id} frame {i}: state={agent.state} "
            f"inliers={inl} ref_matches={agent.ref_kf_matches} "
            f"since_kf={agent.frames_since_kf} n_kf={agent._host_n_kf}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--draws", default=None)
    ap.add_argument("--jax-key", type=int, default=None)
    args = ap.parse_args(argv)
    dc, InMemoryBus, synthetic = load_package(args.jax)
    trace_init_attempts(args.jax)
    receiving = [False]
    trace_cross_stages(args.jax, receiving)
    kw = {} if args.jax else {"device": args.device}
    cfg = dc.CFG
    scene = synthetic.make_cylinder_scene(700, seed=5)
    traj = synthetic.make_loop_trajectory(90, seed=5, frac=0.72)
    seq = synthetic.render_sequence(cfg.camera, traj, scene)

    a0 = dc.CoopAgent(cfg, 0, enable_loop_closing=True, **kw)
    a1 = dc.CoopAgent(cfg, 1, enable_loop_closing=False, **kw)
    if args.jax and args.jax_key is not None:
        import jax
        a0._init_key = a1._init_key = jax.random.PRNGKey(args.jax_key)
    draws = {}
    if args.draws and args.jax:
        record_jax_draws(a0, draws)
        record_jax_draws(a1, draws)
    elif args.draws:
        with np.load(args.draws) as z:
            for name in z.files:
                agent, fid = (int(v) for v in name.split("_"))
                (a0, a1)[agent].init_draws[fid] = z[name]
    source = ("the JAX run's" if args.draws and not args.jax else
              f"PRNGKey({args.jax_key or 0})" if args.jax else "own")
    print(f"package: {'jax (cpu)' if args.jax else 'port ' + args.device}; "
          f"initialisation draws: {source}", flush=True)

    def init_note(agent, i, seen):
        if agent.state == "OK" and not seen:
            print(f"  agent {agent.agent_id} initialised at frame {i}",
                  flush=True)
            return True
        return seen

    t0 = time.perf_counter()
    seen0 = seen1 = False
    for i in range(0, 38):
        a0.track_mono(seq[i], i)
        seen0 = init_note(a0, i, seen0)
        print(frame_line(a0, i), flush=True)
    print(f"a0 init: state={a0.state} n_kf={a0._host_n_kf} "
          f"ate={dc.joint_ate(a0, traj):.4f}", flush=True)

    bus = InMemoryBus()
    events = []
    for i in range(30, args.frames):
        a1.track_mono(seq[i], i)
        seen1 = init_note(a1, i, seen1)
        print(frame_line(a1, i), flush=True)
        if i % 8 == 0 or i == args.frames - 1:
            pkts = a1.drain_packets(max_batch=10)
            print(f"[i={i}] a1 sends the keyframes of frames "
                  f"{[int(p.frame_id) for p in pkts]}", flush=True)
            bus.publish(1, pkts, subscribers=[0, 1])
            for p in bus.drain(0):
                before = a0.n_merges
                receiving[0] = True
                got = a0.receive_packet(p)
                receiving[0] = False
                k = a0._host_n_kf - 1
                print(f"  a0 receives the keyframe of frame "
                      f"{int(p.frame_id)} as kf {k}: merges "
                      f"{before}->{a0.n_merges}", flush=True)
                if got:
                    events.append((i, k))
    if args.draws and args.jax:
        np.savez(args.draws, **draws)
    ate = dc.joint_ate(a0, traj)
    print(f"final: merges={a0.n_merges} events={events} ate={ate:.4f} "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

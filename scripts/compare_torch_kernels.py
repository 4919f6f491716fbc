"""Times kernels K1 `fast_score_nms`, K2 `masked_match` and K3 `pose_opt_lm`
of coslam_tpu_torch on the GPU, for one checkout or for two checkouts in turns on the same card.

    python3 scripts/compare_torch_kernels.py                  # this checkout
    python3 scripts/compare_torch_kernels.py --parent DIR     # DIR vs this one

With --parent the order is parent, change, change, parent, each in a process
of its own (each builds its kernels with nvcc), and a table of the medians
follows.  DIR is a checkout of the other commit, e.g.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent

Per checkout it checks every shape against the plain twin (best / second
exact, idx where a match exists; K3 pose within 1e-3), then prints device
time per launch (the kernels' durations from torch.profiler over 50
launches after a warm-up; a fold kernel counts with its matcher) and the
wrapper's host time per call (host clock around 1000 calls with one
synchronise at the end), as one JSON object on the last line.  The inputs are
those of coslam_tpu_torch/utils/kernel_cases.py, which chip_smoke.py times
too:

  * K1: the 8-level pyramid of a rendered 640x480 frame with the
    extractor's 19-px border (one launch; a checkout from before the
    pyramid entry scores it in 8 launches and masks outside the kernel, and
    its 8 kernels are what is timed);
  * K2 dense: 1024x1024, 32768x1024, 1024x32768, 16384x1024, 1024x16384
    (90% of either side valid, octave gate and per-target radii on);
  * K2 map-like: a point table of 32768 slots with the first 361 valid, and
    of 16384 with the first 319, as queries (forward pass) and as targets
    (reverse pass) against 1024 keypoints;
  * K3 (4 x 10 LM steps) at N = 1024 with 90% and with 215 of the
    observations carrying information, at N = 200 and at N = 3000.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_cases():
    """This checkout's kernel_cases module, by path: with --parent the
    package on sys.path is the other checkout's, which need not have it, and
    both checkouts are to be timed on the same inputs."""
    spec = importlib.util.spec_from_file_location(
        "kernel_cases", os.path.join(HERE, "coslam_tpu_torch", "utils",
                                     "kernel_cases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_ms(fn, tag, reps=50, warmup=5):
    """Mean device milliseconds per call of the kernels whose name holds
    `tag` (profiler kernel durations: back-to-back calls are host-bound, so
    CUDA events around them would time the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if tag in e.key
             and e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise SystemExit(f"the profiler saw no kernel named *{tag}*")
    return us / reps / 1e3


def host_us(fn, reps=1000):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def measure() -> dict:
    import torch
    sys.path.insert(0, os.getcwd())
    from coslam_tpu_torch.ops import cuda_kernels as ck
    kc = load_cases()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    log = ck.library_path().with_suffix(".log")     # ptxas -v, if kept
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1][-60:]
            elif "registers" in line or "stack frame" in line:
                print(f"ptxas {entry}: {line.strip()}", flush=True)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "k1_ms": {}, "k2_ms": {}, "k3_ms": {}}

    levels = kc.fast_inputs(dev)
    name = f"{len(levels)}-level pyramid of 480x640, margin {kc.FAST_MARGIN}"
    if hasattr(ck, "fast_score_nms_pyramid"):
        def k1():
            return ck.fast_score_nms_pyramid(levels, kc.FAST_MARGIN)
    else:
        def k1():
            return [ck.fast_score_nms(l) for l in levels]
    kept = np.s_[kc.FAST_MARGIN:-kc.FAST_MARGIN,
                 kc.FAST_MARGIN:-kc.FAST_MARGIN]
    before = ck.LAUNCHES["fast_score_nms"]
    got = k1()
    launches = ck.LAUNCHES["fast_score_nms"] - before
    err = max(float((g[kept] - ck.fast_score_nms_plain(l)[kept]).abs().max())
              for g, l in zip(got, levels))
    assert err <= 1e-5, f"K1: differs from the twin by {err}"
    out["k1_ms"][name] = device_ms(k1, "fast_score_nms")
    out["k1_host_us"] = host_us(k1)
    print(f"K1 {name}: max err {err:g} in the kept region, {launches} "
          f"launches, {out['k1_ms'][name] * 1e3:.2f} us", flush=True)

    for name, n, m, nvq, nvt in kc.MATCH_CASES:
        args, kw = kc.match_inputs(rng, dev, n, m, nvq, nvt)
        got = ck.masked_match(*args, **kw)
        ref = kc.match_plain(ck, args, kw)
        has = ref[0] < ck.INF_I32
        assert torch.equal(got[0], ref[0]), f"K2 {name}: best differs"
        assert torch.equal(got[1], ref[1]), f"K2 {name}: second differs"
        assert torch.equal(got[2][has], ref[2][has]), f"K2 {name}: idx"
        assert bool((got[2][~has] == -1).all()), f"K2 {name}: idx not -1"
        out["k2_ms"][name] = device_ms(
            lambda: ck.masked_match(*args, **kw), "masked_match")
        if name == "1024x1024":
            out["k2_host_us"] = host_us(lambda: ck.masked_match(*args, **kw))
        print(f"K2 {name}: equal to the twin, {int(has.sum())} matched, "
              f"{out['k2_ms'][name] * 1e3:.2f} us", flush=True)

    for name, n, n_live in kc.POSE_CASES:
        args, kw, Tgt = kc.pose_inputs(rng, dev, n, n_live)
        Tk, ik = ck.pose_opt_lm(*args, **kw)
        Tp, ip = ck.pose_opt_lm_plain(*args, **kw)
        err = float((Tk - Tp).abs().max())
        n_diff = int((ik != ip).sum())
        assert err <= 1e-3, f"K3 {name}: T differs by {err}"
        assert n_diff <= 5, f"K3 {name}: {n_diff} inlier flags differ"
        assert float(np.abs(Tk.cpu().numpy() - Tgt).max()) < 2e-2
        out["k3_ms"][name] = device_ms(
            lambda: ck.pose_opt_lm(*args, **kw), "pose_opt_lm")
        if name == "N=1024":
            out["k3_host_us"] = host_us(lambda: ck.pose_opt_lm(*args, **kw),
                                        200)
        print(f"K3 {name}: T err {err:.2e}, {n_diff} flags differ, "
              f"{out['k3_ms'][name] * 1e3:.2f} us", flush=True)
    return out


def run_checkout(root: str) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--measure"], cwd=root, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{root} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="checkout of the commit to compare with")
    ap.add_argument("--measure", action="store_true",
                    help="measure the checkout in the current directory")
    a = ap.parse_args()
    if a.measure:
        print(json.dumps(measure()))
        return 0
    if not a.parent:
        os.chdir(HERE)
        print(json.dumps(measure(), indent=1))
        return 0
    runs = [("parent", run_checkout(a.parent)), ("change", run_checkout(HERE)),
            ("change", run_checkout(HERE)), ("parent", run_checkout(a.parent))]
    print(runs[0][1]["card"])
    rows = []
    for key in ("k1_ms", "k2_ms", "k3_ms"):
        for name in runs[0][1][key]:
            p = [r[key][name] * 1e3 for w, r in runs if w == "parent"]
            c = [r[key][name] * 1e3 for w, r in runs if w == "change"]
            rows.append((f"{key[:2].upper()} {name}", p, c))
    for key in ("k1_host_us", "k2_host_us", "k3_host_us"):
        rows.append((f"{key[:2].upper()} wrapper host us per call"
                     + (" (a pyramid)" if key == "k1_host_us" else ""),
                     [r[key] for w, r in runs if w == "parent"],
                     [r[key] for w, r in runs if w == "change"]))
    print(f"{'case (device us per launch)':58s} {'parent':>17s} "
          f"{'change':>17s}")
    for name, p, c in rows:
        print(f"{name:58s} {p[0]:8.2f} {p[1]:8.2f} {c[0]:8.2f} {c[1]:8.2f}")
    print(json.dumps({"card": runs[0][1]["card"], "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

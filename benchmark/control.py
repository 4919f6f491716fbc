"""The control of the correctness check: the plain reference put in the
program's place one precision below the configuration's float32
(bfloat16), on what a short window of the cell really sampled, next to
the program's own readings.  A limit lies between the two.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...] \
        [--seconds 20] [--fault <name>]

Prints one JSON line per seed: `program` (the compared numbers of the
run) and `control` (the same numbers, the median call where the check
takes one, with the bfloat16 reference's answers in place of the
program's):
  frame_mismatch_pct  the bfloat16 extractor (pyramid and descriptor
                      contractions) against the float32 reference;
  k3_gap_px           the bfloat16 pose optimisation against float64;
  ba_cost_excess_pct  the bfloat16 local BA against float64;
  sim3_gap_px         the bfloat16 Sim3 polish against float64;
  map_reproj_px       (a reading, not compared) each session's map
                      rounded to bfloat16.
`k2_rows_differ` is an exact comparison (limit 0); `ate_m` has no control
reading, its upper one comes from a fault (`--fault ba_unchanged`).  With `--fault` the run has that fault of
benchmark/faults.py planted, and `program` is the fault's reading.
The benchmark's own runs never run this."""

import argparse
import json
import os
import sys
import time


def control_numbers(cell, samples, out) -> dict:
    import numpy as np
    import torch

    from benchmark.harness import checks
    from benchmark.reference import ba, mapcheck, orb, pose, sim3

    ex = cell.config["system"]["extractor"]
    camera = cell.config["system"]["camera"]
    res = {}
    calls = samples.kept["extract"]
    if calls:
        bad = total = 0
        for c in calls:
            img = c["args"][0]
            ref = orb.extract(img, ex)
            low = orb.extract(img, ex, dtype=torch.bfloat16)
            b, _ = orb.mismatch(low, ref)
            bad, total = bad + b, total + int(ref["valid"].sum())
        res["frame_mismatch_pct"] = 100.0 * bad / max(total, 1)
    calls = samples.kept["pose_opt_lm"]
    if calls:
        gaps = []
        for c in calls:
            T_init, X, uv, isg = c["args"][:4]
            T_low, _ = pose.optimize(T_init, X, uv, isg, dtype=torch.bfloat16,
                                     **c["kw"])
            gaps.append(pose.gap_px(c, against=T_low))
        res["k3_gap_px"] = float(np.median(gaps))
    calls = samples.kept["solve_dense"]
    if calls:
        res["ba_cost_excess_pct"] = float(np.median([
            ba.cost_excess_pct(c, against=ba.solve(
                *c["args"][:2], dtype=torch.bfloat16, **c["kw"]))
            for c in calls]))
    gaps = [sim3.gap_px(c, against=sim3.refine(**sim3._kw(c),
                                               dtype=torch.bfloat16)[:3])
            for c in checks.gated_sim3(cell, samples)]
    gaps = [g for g in gaps if g is not None]
    if gaps:
        res["sim3_gap_px"] = float(np.median(gaps))
    reproj = [mapcheck.reprojection_px(s["map_arrays"], camera,
                                       dtype="bfloat16")
              for s in out.sessions
              if int(s["map_arrays"]["kf_valid"].sum()) >= 3]
    reproj = [r for r in reproj if np.isfinite(r)]
    if reproj:
        res["map_reproj_px"] = max(reproj)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark.faults import FAULTS
    from benchmark.harness import checks, main as hmain, spec

    if args.fault is not None and args.fault not in FAULTS:
        p.error(f"--fault: one of {sorted(FAULTS)}")
    hmain.cache_environment()
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        keep = {}
        res = hmain.run(cell, seed, args.seconds, False, time.perf_counter(),
                        keep=keep, faults=FAULTS.get(args.fault))
        got = checks.numbers(cell, keep["outcome"], keep["samples"])
        ctl = ({} if args.fault else
               control_numbers(cell, keep["samples"], keep["outcome"]))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "fault": args.fault,
                          "correct": res["correct"], "program": got,
                          "control": ctl,
                          "per_session": res["window"]["per_session"],
                          "counters": res["window"]["counters"],
                          "limits": checks.limits(cell),
                          "samples": res["window"]["samples"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

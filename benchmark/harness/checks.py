"""How `correct` is decided: what the window's timed path produced,
compared with the plain reference (benchmark/reference), each number
against its limit.

  ate_m               the worst session's trajectory (every posed frame)
                      against the renderer's ground truth after a Sim3
                      alignment
  frame_mismatch_pct  sampled frames: keypoints whose pixel, octave or
                      descriptor differ from the reference extractor's
  k2_rows_differ      sampled K2 calls: queries whose best or second
                      distance, or unique best target, differ; exact
  k3_gap_px           sampled K3 calls: largest pixel distance between the
                      program's pose and the float64 reference's, the
                      median call
  ba_cost_excess_pct  sampled windowed local BAs of the keyframe backend:
                      how far (percent) the robust cost of the program's
                      solution lies above that of the float64 reference's
                      from the same start, the median call

The three solvers' numbers (K3, the local BA, the Sim3 polish) compare the
median sampled call and print the worst as a reading: on a few calls the
float32 LM and the float64 one part ways (a step kept by one cost test and
not the other, an inlier near the chi2 gate), and the worst call then
swings as far as the bfloat16 control (PERF.md).
  sim3_gap_px         sampled Sim3 polishes (loop closing's) that
                      kept enough pairs to pass the acceptance gate: largest
                      pixel distance between where the program's Sim3 and
                      the float64 reference's map the pairs, the median
                      call

Every number has its limit in benchmark/limits/<workload>.json; a number
the limit file lists under `_may_be_absent` is judged only in a window
that has something for it (a replay window may hold no Sim3 polish that
passes the gate).  `readings` adds what is
printed and not compared: the worst session's median reprojection error
of its map (`map_reproj_px`, the keyframe backend's triangulation and
local BA judged by geometry), which the control does not separate from
sound runs (PERF.md)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark.reference import ba, mapcheck, matcher, orb, pose, sim3
from benchmark.reference import trajectory

MIN_POSED = 10           # a session's trajectory is judged from 10 poses on


def session_ate(sess: dict) -> Optional[float]:
    gt = sess["gt"]
    ids, T = sess["trajectory"]
    if len(ids) < MIN_POSED:
        return None
    return trajectory.ate_rmse(trajectory.centres(T),
                               trajectory.centres(gt[ids]))


def numbers(cell, out, samples) -> Dict[str, float]:
    """The compared numbers of this run (a number with nothing to compare
    is absent)."""
    ex = cell.config["system"]["extractor"]
    got: Dict[str, float] = {}
    ates = [a for a in (session_ate(s) for s in out.sessions) if a is not None]
    if ates:
        got["ate_m"] = max(ates)
    if samples.kept["extract"]:
        bad = total = 0
        for call in samples.kept["extract"]:
            img = call["args"][0]
            ref = orb.extract(img, ex)
            b, t = orb.mismatch(call["out"], ref)
            bad, total = bad + b, total + t
        got["frame_mismatch_pct"] = 100.0 * bad / max(total, 1)
    if samples.kept["masked_match"]:
        got["k2_rows_differ"] = float(sum(
            matcher.rows_differ(c) for c in samples.kept["masked_match"]))
    if samples.kept["pose_opt_lm"]:
        got["k3_gap_px"] = float(np.median(
            [_once(c, pose.gap_px) for c in samples.kept["pose_opt_lm"]]))
    if samples.kept["solve_dense"]:
        got["ba_cost_excess_pct"] = float(np.median(
            [_once(c, ba.cost_excess_pct)
             for c in samples.kept["solve_dense"]]))
    gaps = _sim3_gaps(cell, samples)
    if gaps:
        got["sim3_gap_px"] = float(np.median(gaps))
    return got


def _once(call: dict, judge):
    """`judge(call)` of a sampled call, worked out once."""
    done = call.setdefault("judged", {})
    if judge.__module__ + judge.__name__ not in done:
        done[judge.__module__ + judge.__name__] = judge(call)
    return done[judge.__module__ + judge.__name__]


def _sim3_gaps(cell, samples) -> List[float]:
    gaps = [_once(c, sim3.gap_px) for c in gated_sim3(cell, samples)]
    return [g for g in gaps if g is not None]


def gated_sim3(cell, samples) -> List[dict]:
    """The sampled Sim3 polishes that kept at least the configuration's
    `sim3_min_inliers` pairs: the ones that can close a loop."""
    least = int(cell.config["system"]["loop"].get("sim3_min_inliers", 20))
    return [c for c in samples.kept["refine_sim3"]
            if sim3.inliers(c) >= least]


def readings(cell, out, samples) -> Dict[str, float]:
    """Printed beside the compared numbers, with no limit: the worst call
    of each solver compared by its median call, and the worst session's
    map judged by its median reprojection error (`map_reproj_px`)."""
    camera = cell.config["system"]["camera"]
    res = {}
    reproj = [mapcheck.reprojection_px(s["map_arrays"], camera)
              for s in out.sessions
              if int(s["map_arrays"]["kf_valid"].sum()) >= 3]
    reproj = [r for r in reproj if np.isfinite(r)]
    if reproj:
        res["map_reproj_px"] = max(reproj)
    if samples.kept["pose_opt_lm"]:
        res["k3_gap_worst_px"] = max(
            _once(c, pose.gap_px) for c in samples.kept["pose_opt_lm"])
    if samples.kept["solve_dense"]:
        res["ba_cost_excess_worst_pct"] = max(
            _once(c, ba.cost_excess_pct) for c in samples.kept["solve_dense"])
    gaps = _sim3_gaps(cell, samples)
    if gaps:
        res["sim3_gap_worst_px"] = max(gaps)
    return res


def limits(cell) -> Dict[str, float]:
    return {k: float(v) for k, v in cell.limits.items()
            if not k.startswith("_")}


def judge(cell, got: Dict[str, float]) -> Tuple[bool, List[list]]:
    """(correct, [[name, value, limit], ...]).  Every number the cell has a
    limit for must have been compared, unless its limit file lets it be
    absent, and be at or under its limit."""
    lim = limits(cell)
    optional = set(cell.limits.get("_may_be_absent", []))
    rows, ok = [], True
    for name, limit in lim.items():
        value = got.get(name)
        rows.append([name, value, limit])
        if value is None:
            ok = ok and name in optional
        elif not np.isfinite(value) or value > limit:
            ok = False
    return ok, rows

"""Where a benchmark cell's window goes, by the program's own spans
(coslam_tpu_torch/utils/profiling.py), on one GPU.

    python3 scripts/span_breakdown.py --workload tum-fr1-mono.replay \
        --seed 7300007 --seconds 51 [--out spans.json]
    python3 scripts/span_breakdown.py --cost

The first form makes one traced run of the cell through the benchmark's
own harness (benchmark/harness/main.run, `--trace 1`: torch.profiler with
CUDA activity only) and prints, as one JSON object (also written to
`--out`):

  * the run's result line (its per-layer metrics, the four read from the
    spans among them), frames/s of the traced window and spans per frame;
    below, spans are cut at the window's ends (the readers instead keep
    only the spans inside it);
  * `on_keyframe`: LoopCloser.on_keyframe's wall per call split by the
    innermost span (self times of loop.detect / loop.shortlist /
    loop.verify / loop.correct / sync.loop / on_keyframe's own), and the
    inclusive wall of each step per call;
  * `wall_by_top_span`: the window's wall by top-level span (session.new,
    session.run, session.shutdown, none), under session.run by its
    children, and by the innermost span;
  * `idle_by_span`: the device-idle time of the window (no kernel, copy or
    memset running) by the innermost program span open over it, and the
    share under a span more specific than session.run;
  * `idle_gaps`: the longest idle gaps, named by that span;
  * `sim3_polish`: the calls into `sim3.refine_sim3` over the whole run
    (set-up and warm-up included) and the K4 launches meanwhile.

`--cost` times a span on this host: with no profiler (the check alone),
and with the benchmark's CUDA-only profiler running (record and
record_function range), in nanoseconds per span.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

T_PROCESS = time.perf_counter()
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = ("loop.detect", "loop.shortlist", "loop.verify", "loop.correct",
         "sync.loop")


def self_segments(recs, idx):
    """(start, end, name) pieces of the spans `idx` where no child of
    theirs is open: with nested spans these tile the time under them."""
    keep = set(idx)
    children = collections.defaultdict(list)
    for i in idx:
        p = recs[i].parent
        if p in keep:
            children[p].append((recs[i].start_ns, recs[i].end_ns))
    out = []
    for i in idx:
        r = recs[i]
        t = r.start_ns
        for a, b in sorted(children[i]):
            if a > t:
                out.append((t, a, r.name))
            t = max(t, b)
        if r.end_ns > t:
            out.append((t, r.end_ns, r.name))
    out.sort()
    return out


def idle_intervals(busy, t0, t1):
    gaps, prev = [], t0
    for a, b in busy:
        if b <= t0 or a >= t1:
            continue
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    return gaps


def attribute(gaps, segs):
    """ns of `gaps` under each segment's name, the rest under None; and
    per gap its largest owner."""
    per = collections.Counter()
    owner = []
    j = 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k, t, mine = j, a, collections.Counter()
        while k < len(segs) and segs[k][0] < b:
            s0, s1, name = segs[k]
            lo, hi = max(s0, a), min(s1, b)
            if lo > t:
                mine[None] += lo - t
            if hi > lo:
                mine[name] += hi - lo
            t = max(t, hi)
            k += 1
        if b > t:
            mine[None] += b - t
        per.update(mine)
        owner.append((b - a, mine.most_common(1)[0][0]))
    return per, owner


def clipped(recs, t0, t1):
    """Copies of the records cut to [t0, t1] (a span still open ends at
    t1), and the indices of those that overlap it."""
    from coslam_tpu_torch.utils import profiling

    out, idx = [], []
    for i, r in enumerate(recs):
        c = profiling.Span(r.name, r.parent, r.ids)
        end = t1 if r.end_ns is None else r.end_ns
        c.start_ns, c.end_ns = max(r.start_ns, t0), min(end, t1)
        if c.end_ns > c.start_ns:
            idx.append(i)
        else:
            c.start_ns, c.end_ns = r.start_ns, end
        out.append(c)
    return out, idx


def analyse(td, recs, res) -> dict:
    from coslam_tpu_torch.utils import profiling

    # spans cut at the window's ends: the session that the window's end
    # interrupts counts up to it
    recs, idx = clipped(recs, td.t0_ns, td.t1_ns)
    window = td.t1_ns - td.t0_ns
    frames = td.frames
    names = collections.Counter(recs[i].name for i in idx)
    segs = self_segments(recs, idx)

    # on_keyframe split
    okf = [i for i in idx if recs[i].name == "loop.on_keyframe"]
    under = collections.defaultdict(list)
    for i in idx:
        j = recs[i].parent
        while j >= 0:
            if recs[j].name == "loop.on_keyframe":
                under[j].append(i)
                break
            j = recs[j].parent
    split, incl = collections.Counter(), collections.Counter()
    for o in okf:
        mine = [o] + under[o]
        for i, s in zip(mine, profiling.self_ns(recs, mine)):
            split[recs[i].name] += s
        for i in under[o]:
            if recs[recs[i].parent].name not in STEPS:
                incl[recs[i].name] += recs[i].end_ns - recs[i].start_ns
    n_okf = max(len(okf), 1)
    okf_wall = sum(recs[o].end_ns - recs[o].start_ns for o in okf)
    verify = [recs[i] for i in idx if recs[i].name == "loop.verify"]

    # wall by top-level span and by session.run's children
    top = collections.Counter()
    run_children = collections.Counter()
    for i in idx:
        r = recs[i]
        if r.parent < 0:
            top[r.name] += r.end_ns - r.start_ns
        elif recs[r.parent].name == "session.run":
            run_children[r.name] += r.end_ns - r.start_ns
    top["(no span)"] = window - sum(top.values())
    runs = sum(recs[i].end_ns - recs[i].start_ns for i in idx
               if recs[i].name == "session.run")
    run_children["(session.run itself)"] = runs - sum(run_children.values())

    # the window's wall by the innermost span
    inner = collections.Counter()
    for a, b, name in segs:
        inner[name] += b - a
    inner["(no span)"] = window - sum(inner.values())

    # device idle by the innermost span
    gaps = idle_intervals(td.busy, td.t0_ns, td.t1_ns)
    idle = sum(b - a for a, b in gaps)
    per, owner = attribute(gaps, segs)
    specific = sum(v for k, v in per.items()
                   if k is not None and k != "session.run")
    owner.sort(key=lambda x: -x[0])

    def ms(v):
        return v / 1e6

    return {
        "metrics": {k: v["value"] for k, v in res["metrics"].items()},
        "device": res["device"],
        "correct": res["correct"],
        "window_s": window / 1e9,
        "posed": frames,
        "frames_per_s_traced": frames / (window / 1e9),
        "spans": len(idx),
        "spans_per_frame": len(idx) / max(frames, 1),
        "spans_by_name": dict(names.most_common()),
        "on_keyframe": {
            "calls": len(okf),
            "wall_ms_per_call": ms(okf_wall) / n_okf,
            "self_ms_per_call": {k: ms(v) / n_okf
                                 for k, v in split.most_common()},
            "inclusive_ms_per_call": {k: ms(v) / n_okf
                                      for k, v in incl.most_common()},
            "verify_calls": len(verify),
            "verify_inliers": [r.ids.get("inliers") for r in verify],
        },
        "wall_by_top_span_s": {k: v / 1e9 for k, v in top.most_common()},
        "wall_under_session_run_s": {k: v / 1e9 for k, v
                                     in run_children.most_common()},
        "wall_by_innermost_span_s": {k: v / 1e9
                                     for k, v in inner.most_common()},
        "idle_s": idle / 1e9,
        "idle_by_span_s": {str(k): v / 1e9 for k, v in per.most_common()},
        "idle_share_more_specific_than_session_run":
            specific / idle if idle else None,
        "idle_gaps": [[str(n), d / 1e9] for d, n in owner[:12]],
    }


def cost() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from coslam_tpu_torch.utils import profiling

    def per_span(n):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("cost", kf=1):
                pass
        return (time.perf_counter_ns() - t0) / n

    def empty(n):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            pass
        return (time.perf_counter_ns() - t0) / n

    out = {"off_ns": min(per_span(200_000) for _ in range(5)),
           "loop_ns": min(empty(200_000) for _ in range(5))}
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")
        acts = [ProfilerActivity.CUDA]
    else:
        acts = [ProfilerActivity.CPU]
    with profile(activities=acts):
        on = [per_span(20_000) for _ in range(5)]
    profiling.clear_spans()
    out["on_ns"] = min(on)
    out["activities"] = [str(a) for a in acts]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="tum-fr1-mono.replay")
    p.add_argument("--seed", type=int, default=7300007)
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--out", default=None)
    p.add_argument("--cost", action="store_true")
    a = p.parse_args(argv)
    if a.cost:
        print(json.dumps(cost()))
        return 0

    from benchmark.harness import main as hmain
    from benchmark.harness import spec, trace

    hmain.cache_environment()
    cell = spec.cell(a.workload)
    kept = {}
    inner = trace.breakdown

    def breakdown(td, top=10):
        kept["td"] = td
        return inner(td, top)

    trace.breakdown = breakdown
    from coslam_tpu_torch.ops import cuda_kernels as ck
    from coslam_tpu_torch.ops import sim3
    polish, calls = sim3.refine_sim3, [0]

    def counted(*args, **kw):
        calls[0] += 1
        return polish(*args, **kw)

    sim3.refine_sim3 = counted
    k4 = ck.LAUNCHES["sim3_refine_lm"]
    try:
        res = hmain.run(cell, a.seed, a.seconds, True, T_PROCESS)
    finally:
        trace.breakdown = inner
        sim3.refine_sim3 = polish
    k4 = ck.LAUNCHES["sim3_refine_lm"] - k4
    from coslam_tpu_torch.utils import profiling
    out = analyse(kept["td"], profiling.spans(), res)
    out.update(workload=a.workload, seed=a.seed,
               sim3_polish={"calls": calls[0], "k4_launches": k4})
    line = json.dumps(out)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

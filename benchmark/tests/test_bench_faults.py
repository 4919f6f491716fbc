"""A whole run without the card (the harness's look for a chip skipped,
the cell cut to a size the CPU runs, the program on the CPU with its
kernels' plain twins), with the timed path broken underneath: `correct`
comes out false, on the number each fault is for, where the same run
unbroken passes that number.  Faults: a step that returns its state
unchanged (K3, the local BA), half of a batch left out, and an answer
altered where it is produced (K3's pose, the Sim3).  The cell runs on one
chip, so it has no exchange between chips to leave out."""

import time

import pytest
import torch

from benchmark.tests.bench_common import small_cell
from benchmark import faults
from benchmark.harness import main

SECONDS = {"tum-fr1-mono.replay": 8.0}


def _run(workload, faults=None):
    torch.manual_seed(0)
    return main.run(small_cell(workload), 2**31 + 5, SECONDS[workload], False,
                    time.perf_counter(), device="cpu", workers=2,
                    faults=faults)


def _row(res, name):
    return next(r for r in res["checks"] if r[0] == name)


FAULTS = [("tum-fr1-mono.replay", faults.pose_unchanged, "k3_gap_px"),
          ("tum-fr1-mono.replay", faults.half_batch, "k2_rows_differ"),
          ("tum-fr1-mono.replay", faults.pose_altered, "k3_gap_px"),
          ("tum-fr1-mono.replay", faults.ba_unchanged,
           "ba_cost_excess_pct")]


@pytest.fixture(scope="module")
def sound():
    return {}


@pytest.mark.parametrize("workload,fault,number", FAULTS,
                         ids=[f.__name__ for _w, f, _n in FAULTS])
def test_a_broken_path_is_not_correct(sound, workload, fault, number):
    if workload not in sound:
        sound[workload] = _run(workload)
    _n, value, limit = _row(sound[workload], number)
    assert value is not None and value <= limit
    res = _run(workload, fault)
    _n, value, limit = _row(res, number)
    assert res["correct"] is False
    assert value is not None and value > limit


class _Kept:
    def __init__(self, **kept):
        self.kept = {k: kept.get(k, []) for k in
                     ("extract", "masked_match", "pose_opt_lm", "solve_dense",
                      "refine_sim3")}


def test_a_sim3_altered_where_produced_is_not_correct():
    """A window whose only Sim3 polish was turned by 0.02 rad: a polish
    that passes the gate needs a loop of the card's size, so the fault is
    judged here on the answer itself."""
    from benchmark.harness import checks, outcome
    from benchmark.reference import sim3
    from benchmark.tests.test_bench_control import _sim3_call

    cell = small_cell("tum-fr1-mono.replay")
    call = _sim3_call(1)
    s, R, t, ok = sim3.refine(**sim3._kw(call), dtype=torch.float32)
    call["out"] = (s, R, t, ok)
    got = checks.numbers(cell, outcome.Outcome(), _Kept(refine_sim3=[call]))
    assert got["sim3_gap_px"] <= checks.limits(cell)["sim3_gap_px"]
    call = dict(_sim3_call(1), out=(s, faults._turned(R, 0.02), t, ok))
    got = checks.numbers(cell, outcome.Outcome(), _Kept(refine_sim3=[call]))
    assert got["sim3_gap_px"] > checks.limits(cell)["sim3_gap_px"]
    assert checks.judge(cell, got)[0] is False

"""coslam_tpu_torch/bench_scaling.py against the reference's bench_scaling.py.

`make_problem` equals the reference's problem: bench_scaling.main is run
with `coslam_tpu.optim.ba.solve` patched inside this test to record its
argument and stop.  Then `--cpu-ranks 2` at a small size prints rows for
world sizes 1 and 2 in both modes, each within 1e-4 of `ba.solve`
(tests/test_sharded_ba.py's pose bar), each collective census equal to the
per-iteration counts of `parallel/mesh.CALLS` in the tests' own solves."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import bench_scaling as jbench_scaling
from coslam_tpu.optim import ba as jba
from coslam_tpu_torch import bench_scaling

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402

torch.set_num_threads(1)
SMALL = ["--n-kf", "6", "--n-pt", "300", "--iters", "3", "--pcg-iters", "10"]


class _Recorded(Exception):
    pass


def _jax_problem(monkeypatch, argv):
    seen = {}

    def record(cam, prob, **kw):
        seen["prob"] = prob
        raise _Recorded

    monkeypatch.setattr(jba, "solve", record)
    monkeypatch.setattr(sys, "argv", ["bench_scaling.py"] + argv)
    with pytest.raises(_Recorded):
        jbench_scaling.main()
    return [np.asarray(x) for x in seen["prob"]]


@pytest.mark.parametrize("argv,kw", [
    (SMALL[:4], dict(n_kf=6, n_pt=300)),
    (["--n-kf", "5", "--n-pt", "400", "--obs-per-kf", "40"],
     dict(n_kf=5, n_pt=400, obs_per_kf=40)),
])
def test_make_problem_equals_reference(monkeypatch, argv, kw):
    ref = _jax_problem(monkeypatch, argv)
    got = bench_scaling.make_problem(**kw)
    assert got._fields == jba.BAProblem._fields
    for name, a, b in zip(got._fields, got, ref):
        a = a.numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_cpu_ranks_rows(capsys):
    assert bench_scaling.main(["--cpu-ranks", "2"] + SMALL) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# problem: 6 keyframes, 300 points")
    rows = [json.loads(ln) for ln in lines[1:]]
    assert [(r["devices"], r.get("mode")) for r in rows] == [
        (1, None), (1, "obs-sharded"), (1, "partitioned"),
        (2, "obs-sharded"), (2, "partitioned")]
    assert rows[0]["max_pose_diff"] == 0.0
    for r in rows[1:]:
        assert r["max_pose_diff"] <= 1e-4, r
        assert r["t_solve_s"] > 0
    part = rows[2]
    assert set(part) == {
        "devices", "mode", "t_solve_s", "t_per_LM_iter_ms", "speedup_vs_1",
        "max_pose_diff", "modeled_collective_bytes_per_LM_iter_per_dev",
        "collective_census", "hbm_points_frac_per_dev"}
    assert rows[4]["modeled_collective_bytes_per_LM_iter_per_dev"] \
        == bench_scaling.sharded_ba.collective_bytes_per_iter(6, 2, 10)
    # the census against the tests' own count of mesh.CALLS per iteration
    prob = bench_scaling.make_problem(6, 300)
    out = bench_scaling.mesh_lib.launch(
        ranks.solves, 2, (bench_scaling.CAM, prob, [(0, 10), (1, 10)]))[0]
    for r in rows[1:]:
        name = "sharded" if r["mode"] == "obs-sharded" else "partitioned"
        c0, c1 = out["runs"][0][name][1], out["runs"][1][name][1]
        calls = {op: c1[(op, ax)] - c0.get((op, ax), 0)
                 for op, ax in c1 if c1[(op, ax)] - c0.get((op, ax), 0)}
        assert {op: v["calls"] for op, v in
                r["collective_census"].items()} == calls, r

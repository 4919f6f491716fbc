"""coslam_tpu_torch.scripts.run_results: `run_one` runs the port's dataset
CLI in a subprocess with `--device cpu` on a small TUM proxy (RGB-D, 11
frames: the CLI reports an ATE from 11 tracked frames), its report lines are
parsed and the table row is written; the rows' failure rule is the JAX
script's (a non-zero exit, or an ATE over the bound, in any repetition)."""

import os

import pytest

from coslam_tpu_torch.scripts import make_proxy_datasets as mpd
from coslam_tpu_torch.scripts import run_results as rr

FRAMES = 11
SPEC = rr.RUNS[1]                  # TUM-layout RGB-D


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_results")
    mpd.make_all(str(root), FRAMES, 11, "tum", "cpu")
    out = root / "results"
    out.mkdir()
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"      # one thread, as the tests run
    try:
        return rr.run_one(SPEC, str(root), str(out), device="cpu")
    finally:
        if env is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = env


def test_run_one_on_the_cpu(run):
    assert run["rc"] == 0, run.get("stderr_tail")
    assert run["cmd"].split()[-2:] == ["--device", "cpu"]
    assert "coslam_tpu_torch.cli rgbd --dataset tum" in run["cmd"]
    assert run["tracked"].startswith(f"frames tracked: {FRAMES} / {FRAMES}")
    assert 0 <= run["ate_cm"] < SPEC["bound_cm"]
    with open(run["traj"]) as f:
        assert len(f.read().splitlines()) == FRAMES


def test_the_table_row(run, tmp_path):
    row = rr.combine([run])
    lines = rr.table_lines([row], "cpu")
    assert lines[1] == "**Device:** cpu.\n"
    mine = [ln for ln in lines if ln.startswith(f"| {SPEC['name']} |")]
    assert len(mine) == 1
    cells = [c.strip() for c in mine[0].split("|")[1:-1]]
    assert cells[1] == f"{run['ate_cm']:.2f} cm"
    assert cells[2] == f"{run['ate_cm']:.2f}..{run['ate_cm']:.2f} cm (1 reps)"
    assert cells[3] == "< 5 cm" and cells[5] == run["tracked"]
    assert cells[7] == rr.JAX_CPU[SPEC["name"]]
    assert rr.failed([row]) == []
    cmd = [ln for ln in lines if "coslam_tpu_torch.cli" in ln]
    assert cmd == ["    python -m coslam_tpu_torch.cli rgbd --dataset tum "
                   f"--root {run['cmd'].split('--root ')[1].split()[0]} "
                   f"--out {run['traj']} --device cpu"]


def test_failure_rule():
    ok = dict(spec=SPEC, rc=0, ate_cm=1.0, wall_s=1.0, cmd="")
    over = dict(ok, ate_cm=6.0)
    crashed = dict(spec=SPEC, rc=1, wall_s=1.0, cmd="")
    assert rr.failed([rr.combine([ok, ok])]) == []
    assert len(rr.failed([rr.combine([ok, over])])) == 1
    assert len(rr.failed([rr.combine([ok, crashed])])) == 1
    assert len(rr.failed([rr.combine([crashed])])) == 1
    assert any("| FAILED (rc=1) | — |" in ln for ln in
               rr.table_lines([rr.combine([crashed])], "cpu"))

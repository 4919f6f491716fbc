"""coslam_tpu_torch/bench.py (`python3 bench_torch.py`) on the CPU.

`bench_hot_path(device="cpu", batch=2)` runs the hot path eagerly (nothing
is captured on the CPU) and its per-frame outputs equal `entry.track_step`
called frame by frame; `bench_full_system(device="cpu")` runs two frames
with repeats=1; the JSON line's keys equal those bench.py:190-205 prints
(its `main` run here with its two measurements stubbed) and its `device`
reads "cpu".  `main()` without `--device` raises where there is no GPU.
The card's numbers come from `python3 bench_torch.py` on the GPU."""

import json
import sys

import pytest
import torch

import bench as jbench
from coslam_tpu_torch import bench, entry

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hot():
    return bench.bench_hot_path(device="cpu", batch=2, reps=1)


@pytest.fixture(scope="module")
def full():
    return bench.bench_full_system(device="cpu", n_frames=2, repeats=1)


def _reference_keys(monkeypatch, capsys):
    monkeypatch.setattr(jbench, "bench_hot_path",
                        lambda: (1.0, 1e9, {"extract_ms": 1.0}))
    monkeypatch.setattr(jbench, "bench_full_system",
                        lambda: (1.0, 2, 0, 0.0))
    jbench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_hot_path_on_cpu(hot):
    assert not hot.graph and hot.equal
    assert set(hot.stages_ms) == {"extract_ms", "match_ms", "pose_opt_ms"}
    assert all(v >= 0 for v in hot.stages_ms.values())
    assert hot.fps > 0 and hot.eager_fps > 0
    # the pyramid and descriptor matmuls; the kernels' twins add only the
    # pose solve's small products
    assert 2e10 < hot.flops_per_frame < 3e10
    # the kernels' plain twins run on the CPU: nothing is launched
    assert hot.launches_per_frame == {k: 0.0 for k in bench.KERNELS}
    T, n, desc = hot.outputs
    assert T.shape == (2, 4, 4) and n.shape == (2,) \
        and desc.shape == (2, 1024, 8)
    step, example = entry.entry("cpu")
    imgs = torch.from_numpy(bench.hot_path_frames(0, 2))
    for b in range(2):
        Tb, nb, db = step(imgs[b], *example[1:])
        assert torch.equal(T[b], Tb) and torch.equal(n[b], nb) \
            and torch.equal(desc[b], db)


def test_result_line_keys_equal_reference(hot, full, monkeypatch, capsys):
    ref = _reference_keys(monkeypatch, capsys)
    line = bench.result_line(full, hot, "cpu")
    assert set(line) == set(ref)
    assert line["device"] == "cpu" and line["hot_path_mfu_pct"] is None
    assert line["metric"] == ref["metric"] and line["unit"] == ref["unit"]
    assert set(line["hot_path_stage_ms"]) == {"extract_ms", "match_ms",
                                              "pose_opt_ms"}
    assert line["lost_frames"] == 0
    assert len(full.runs) == 1 and line["value"] == full.runs[0].fps
    assert line["vs_baseline"] == line["value"] / 30.0


def test_main_on_cpu(hot, full, monkeypatch, capsys):
    """main's lines with the measurements already taken above."""
    monkeypatch.setattr(bench, "bench_hot_path", lambda *a, **k: hot)
    monkeypatch.setattr(bench, "bench_full_system", lambda *a, **k: full)
    assert bench.main(["--device", "cpu", "--batch", "2", "--frames", "2",
                       "--repeats", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"
    assert any(ln.startswith("[hot path]") for ln in lines)
    assert any(ln.startswith("[full system] run 0") for ln in lines)
    last = json.loads(lines[-1])
    assert last == json.loads(json.dumps(bench.result_line(full, hot,
                                                           "cpu")))


def test_main_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["bench_torch.py"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench.main([])

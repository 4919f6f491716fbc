"""The dataset modes of coslam_tpu_torch.cli against coslam_tpu.cli.

Both CLIs' `main` run on the same small TUM / KITTI / EuRoC directories
with `cli.System` replaced in each by the same recording stub that returns
a fixed trajectory: the configuration each was given (camera, sensor), the
frames, timestamps and depth / right arrays it was fed, the report lines
and the `--out` files must be identical.  Then the port's dataset path,
with a real System on the CPU, must equal its `System.run_sequence` on the
same arrays held in memory."""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from coslam_tpu import cli as jcli
from coslam_tpu_torch import cli as tcli
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.utils import io as tio
from coslam_tpu_torch.utils import synthetic

# The test run splits the cores among its xdist workers.
torch.set_num_threads(1)

N = 14


def _rot(axis: int, quarter_turns: int) -> np.ndarray:
    """An axis-aligned rotation: its quaternion is computed exactly by both
    packages' float32 `rot_to_quat` (on general rotations ~0.7% of the
    quaternions still differ by 1-2 ulp between XLA's CPU and the port,
    which can move a printed component by one unit of its last digit:
    tests/test_torch_io.py holds those within that unit)."""
    c, s = [(1, 0), (0, 1), (-1, 0), (0, -1)][quarter_turns % 4]
    R = np.eye(3)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R


def _fixed_trajectory(n):
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for k in range(n):
        T[k, :3, :3] = _rot(k % 3, k // 3)
        T[k, :3, 3] = [0.25 * k, -0.5 + 0.125 * k, 1.0 - 0.0625 * k]
    return T


def stub_class(log: list):
    """A System stand-in: records its configuration and what the driver
    feeds it; tracks frames 2.. with a fixed trajectory."""

    class Stub:
        def __init__(self, cfg, device=None, **kw):
            self.cfg, self.n, self.fed = cfg, 0, []
            self.state = "OK"
            self.map = types.SimpleNamespace(n_kf=np.int32(5),
                                             pt_valid=np.ones(42, bool))
            log.append(self)

        def run_sequence(self, images, timestamps=None, depths=None,
                         right_images=None, **kw):
            for i in range(len(images)):
                self.fed.append(("chunked", i, timestamps[i],
                                 np.array(images[i]),
                                 None if depths is None
                                 else np.array(depths[i]),
                                 None if right_images is None
                                 else np.array(right_images[i])))
            self.n = len(images)

        def _frame(self, kind, img, aux, i, timestamp):
            self.fed.append((kind, i, timestamp, np.array(img),
                             None if aux is None else np.array(aux)))
            self.n = i + 1

        def track_mono(self, img, i, timestamp=None):
            self._frame("mono", img, None, i, timestamp)

        def track_rgbd(self, img, depth, i, timestamp=None):
            self._frame("rgbd", img, depth, i, timestamp)

        def track_stereo(self, img, right, i, timestamp=None):
            self._frame("stereo", img, right, i, timestamp)

        def trajectory_poses(self):
            ids = list(range(2, self.n))
            return ids, _fixed_trajectory(self.n)[2:]

    return Stub


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """TUM (RGB with R = G = B, 16-bit depth with jittered stamps), KITTI
    stereo and EuRoC (cam0, cam1 and sensor.yaml) directories of N frames
    at 32x24, each with ground truth."""
    root = tmp_path_factory.mktemp("datasets")
    rng = np.random.default_rng(11)
    gray = rng.integers(0, 256, (N, 24, 32), dtype=np.uint8)
    T_wc = np.linalg.inv(_fixed_trajectory(N)).astype(np.float64)
    T_wc[:, :3, 3] += rng.normal(0, 0.01, (N, 3))
    ts = [float(f"{1305031102.175304 + 0.0333 * i:.6f}") for i in range(N)]
    dts = [float(f"{t + rng.uniform(-0.005, 0.005):.6f}") for t in ts]
    tio.write_tum_rgbd(str(root / "tum"), ts,
                       np.repeat(gray[..., None], 3, axis=3),
                       rng.integers(1, 60000, (N, 24, 32)).astype(np.uint16),
                       dts, T_wc)
    tio.write_kitti(str(root / "kitti"), [0.1 * i for i in range(N)], gray,
                    gray[:, :, ::-1], T_wc, sequence="03")
    cam = dataclasses.replace(tcfg.euroc_config().camera, width=32,
                              height=24, cx=16.5, cy=12.25)
    tio.write_euroc(str(root / "euroc"),
                    [1403636579763555584 + 50_000_000 * i for i in range(N)],
                    gray, gray[::-1], cam, T_wc)
    return root


CASES = [
    ("mono", "tum", ["--format", "tum"]),
    ("rgbd", "tum", ["--format", "kitti", "--limit", "12"]),
    ("stereo", "kitti", ["--seq", "03", "--format", "kitti"]),
    ("mono", "euroc", ["--format", "tum", "--per-frame"]),
    ("rgbd", "tum", ["--format", "tum", "--per-frame"]),
    ("stereo", "kitti", ["--seq", "03", "--per-frame"]),
]


@pytest.mark.parametrize("mode,dataset,extra", CASES)
def test_both_clis_feed_and_report_the_same(datasets, tmp_path, monkeypatch,
                                            capsys, mode, dataset, extra):
    logs = {"jax": [], "torch": []}
    monkeypatch.setattr(jcli, "System", stub_class(logs["jax"]))
    monkeypatch.setattr(tcli, "System", stub_class(logs["torch"]))
    outs, lines = {}, {}
    for name, cli, more in (("jax", jcli, []),
                            ("torch", tcli, ["--device", "cpu"])):
        outs[name] = str(tmp_path / f"{name}.txt")
        assert cli.main([mode, "--dataset", dataset, "--root",
                         str(datasets / dataset), "--out", outs[name],
                         "--no-warmup"] + extra + more) == 0
        printed = capsys.readouterr().out.replace(outs[name], "<out>")
        lines[name] = [ln for ln in printed.splitlines() if ln.startswith(
            ("frames tracked", "ATE RMSE", "trajectory written"))]
    (j,), (t,) = logs["jax"], logs["torch"]
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    assert t.cfg.sensor == mode
    if dataset == "euroc":
        assert t.cfg.camera.width == 32          # the sensor.yaml camera
    assert len(t.fed) == len(j.fed) == (12 if "--limit" in extra else N)
    for a, b in zip(t.fed, j.fed):
        assert a[:3] == b[:3]
        for x, y in zip(a[3:], b[3:]):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    assert lines["torch"] == lines["jax"]
    # the ATE line needs more than 10 tracked frames (12 of --limit 12 give
    # 10: no ATE in either)
    with_ate = len(t.fed) - 2 > 10
    assert len(lines["torch"]) == 2 + with_ate
    assert ("ATE RMSE" in lines["torch"][1]) == with_ate
    with open(outs["torch"]) as a, open(outs["jax"]) as b:
        assert a.read() == b.read()


def test_dataset_modes_need_a_root(capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(["stereo", "--device", "cpu"])
    assert e.value.code == 2
    assert "--root required" in capsys.readouterr().err


def _small_cfg(mod):
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=300, fy=300, cx=160, cy=120, width=320,
                                height=240, bf=36.0),
        extractor=mod.ExtractorConfig(n_features=300, max_keypoints=384),
        tracker=mod.TrackerConfig(mapper_latency_frames=3),
        mapper=mod.MapperConfig(max_keyframes=16, max_points=2048))


def test_dataset_path_equals_the_in_memory_run(tmp_path, monkeypatch):
    """RGB-D over 12 rendered frames at 320x240 written as a TUM directory:
    the CLI's dataset function (the chunked driver reading the files)
    against `System.run_sequence` on the decoded arrays in memory, both
    with the mapper cycle pinned, are bit-equal in poses and keyframes;
    frames tracked again after a chunk cut are decoded again."""
    cfg = _small_cfg(tcfg)
    scene = synthetic.make_scene(600, seed=3)
    poses = synthetic.make_trajectory(60, seed=3).poses_cw[:12]
    imgs = synthetic.render_sequence(cfg.camera,
                                     synthetic.Trajectory(poses), scene)
    raw = [np.clip(np.round(synthetic.render_depth(cfg.camera, T, scene)
                            * 5000.0), 0, 65535).astype(np.uint16)
           for T in poses]
    ts = [float(f"{100.0 + i / 30:.6f}") for i in range(len(imgs))]
    root = str(tmp_path / "tum")
    tio.write_tum_rgbd(root, ts, imgs, raw, ts, np.linalg.inv(poses))
    monkeypatch.setattr(tcli, "DATASET_PRESETS", {"tum": lambda: cfg})

    def pin(slam):
        slam._insert_cost_s = 1.0
        slam._note_insert_cost = lambda dt: None

    res = tcli.run_dataset("rgbd", "tum", root, out=str(tmp_path / "t.txt"),
                           device="cpu", prepare=pin)
    mem = tcli.System(cfg.replace(sensor="rgbd"), device="cpu")
    pin(mem)
    mem.run_sequence(imgs, timestamps=ts,
                     depths=[d.astype(np.float32) / 5000.0 for d in raw])
    ids, T = mem.trajectory_poses()
    assert res["ids"] == ids and len(ids) == len(imgs)
    np.testing.assert_array_equal(res["poses"], T)
    assert int(res["slam"].map.n_kf) == int(mem.map.n_kf)
    # rgb and depth once each, and again for every re-tracked frame
    assert res["decodes"] >= 2 * (len(imgs) + mem.n_frames_discarded)
    assert res["ate"] is not None and res["ate"] < 0.05
    saved_ts, saved = tio.load_trajectory_tum(str(tmp_path / "t.txt"))
    np.testing.assert_array_equal(saved_ts, ts)
    assert os.path.getsize(str(tmp_path / "t.txt")) > 0
    np.testing.assert_allclose(saved, T, atol=1e-5)

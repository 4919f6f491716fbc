"""The port's dataset loaders (utils/io.py) against coslam_tpu's on
directories the tests write: the Sequence fields equal (paths, timestamps,
the depth association, absent parts), ground truth within 1e-6; image and
depth reads bit-equal to the reference's on PNGs that Pillow writes and on
one written by hand whose rows carry every PNG row filter (0-4);
`load_trajectory_tum` and the layout writers' round trips."""

import dataclasses
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from coslam_tpu.utils import io as jio
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.utils import io as tio


def _poses_wc(rng, n):
    """n camera-to-world poses with random rotations."""
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.uniform(-3, 3, (n, 3))
    return T


def _same_sequence(t, j):
    assert [dataclasses.asdict(f) for f in t.frames] == \
        [dataclasses.asdict(f) for f in j.frames]
    assert t.depth_factor == j.depth_factor
    for a, b in ((t.gt_timestamps, j.gt_timestamps),
                 (t.gt_poses_wc, j.gt_poses_wc)):
        assert (a is None) == (b is None)
    if t.gt_poses_wc is not None:
        np.testing.assert_array_equal(t.gt_timestamps, j.gt_timestamps)
        assert t.gt_poses_wc.dtype == j.gt_poses_wc.dtype == np.float32
        np.testing.assert_allclose(t.gt_poses_wc, j.gt_poses_wc, atol=1e-6,
                                   rtol=0)
    assert (t.camera is None) == (j.camera is None)
    if t.camera is not None:
        assert dataclasses.asdict(t.camera) == dataclasses.asdict(j.camera)


@pytest.mark.parametrize("with_depth,with_gt", [(True, True), (True, False),
                                                (False, True)])
def test_tum_loader_matches_reference(tmp_path, rng, with_depth, with_gt):
    """Depth stamps jittered within +-5 ms, one depth frame 30 ms away
    (beyond max_dt: no association), and two depth stamps equally near one
    rgb stamp (the first wins, as np.argmin)."""
    n = 7
    ts = [float(f"{1305031102.175304 + 0.0333 * i:.6f}") for i in range(n)]
    dts = [float(f"{t + rng.uniform(-0.005, 0.005):.6f}") for t in ts]
    dts[3] = float(f"{ts[3] + 0.030:.6f}")
    dts[5] = float(f"{ts[5] - 0.004:.6f}")
    dts.insert(6, float(f"{ts[5] + 0.004:.6f}"))
    imgs = rng.integers(0, 256, (n, 24, 32), dtype=np.uint8)
    depths = rng.integers(0, 60000, (len(dts), 24, 32)).astype(np.uint16)
    root = str(tmp_path / "tum")
    tio.write_tum_rgbd(root, ts, imgs, depths if with_depth else None,
                       dts if with_depth else None,
                       _poses_wc(rng, n) if with_gt else None)
    j, t = jio.load_tum_rgbd(root), tio.load_tum_rgbd(root)
    _same_sequence(t, j)
    assert [f.timestamp for f in t.frames] == ts
    if with_depth:
        assert t.frames[3].depth_path is None
        assert t.frames[5].depth_path.endswith(f"{dts[5]:.6f}.png")
        assert sum(f.depth_path is None for f in t.frames) == 1


def test_tum_ground_truth_values(tmp_path, rng):
    n = 5
    T = _poses_wc(rng, n)
    ts = [100.0 + 0.05 * i for i in range(n)]
    root = str(tmp_path / "tum")
    tio.write_tum_rgbd(root, ts, np.zeros((n, 8, 8), np.uint8), poses_wc=T)
    seq = tio.load_tum_rgbd(root)
    np.testing.assert_allclose(seq.gt_poses_wc, T, atol=1e-6)
    np.testing.assert_array_equal(seq.gt_timestamps, ts)


@pytest.mark.parametrize("right,poses", [(True, True), (False, False)])
def test_kitti_loader_matches_reference(tmp_path, rng, right, poses):
    n = 6
    left = rng.integers(0, 256, (n, 20, 41), dtype=np.uint8)
    root = str(tmp_path / "kitti")
    T = _poses_wc(rng, n - 2) if poses else None   # fewer poses than frames
    tio.write_kitti(root, [0.103 * i for i in range(n)], left,
                    left[::-1] if right else None, T)
    j, t = jio.load_kitti(root, "00"), tio.load_kitti(root, "00")
    _same_sequence(t, j)
    assert len(t.frames) == n
    if poses:
        np.testing.assert_allclose(t.gt_poses_wc, T, atol=1e-6)
        assert len(t.gt_timestamps) == n - 2


@pytest.mark.parametrize("right,yaml,gt", [(True, True, True),
                                           (False, False, False)])
def test_euroc_loader_matches_reference(tmp_path, rng, right, yaml, gt):
    """cam1 holds every image but the third (its frame gets no right
    path); sensor.yaml carries the preset camera and parses back equal."""
    n = 5
    ns = [1403636579763555584 + 50_000_000 * i for i in range(n)]
    left = rng.integers(0, 256, (n, 16, 24), dtype=np.uint8)
    cam = tcfg.euroc_config().camera
    T = _poses_wc(rng, n)
    root = str(tmp_path / "euroc")
    tio.write_euroc(root, ns, left, left if right else None,
                    cam if yaml else None, T if gt else None)
    if right:
        os.remove(os.path.join(root, "mav0", "cam1", "data", f"{ns[2]}.png"))
    j, t = jio.load_euroc(root), tio.load_euroc(root)
    _same_sequence(t, j)
    assert [f.timestamp for f in t.frames] == [x * 1e-9 for x in ns]
    if right:
        assert [f.right_path is None for f in t.frames] == \
            [False, False, True, False, False]
    if yaml:
        assert t.camera == cam
    if gt:
        np.testing.assert_allclose(t.gt_poses_wc, T, atol=1e-6)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _write_png_all_filters(path, arr: np.ndarray) -> None:
    """A PNG of `arr` (uint8 gray / RGB / RGBA, or uint16 gray) whose row
    r carries filter r % 5 (None, Sub, Up, Average, Paeth)."""
    color = {1: 0, 3: 2, 4: 6}[1 if arr.ndim == 2 else arr.shape[2]]
    depth = 16 if arr.dtype == np.uint16 else 8
    H, W = arr.shape[:2]
    raw = arr.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1)
    rows = raw.view(np.uint8).reshape(H, -1).astype(int)
    bpp = (1 if arr.ndim == 2 else arr.shape[2]) * depth // 8
    out = bytearray()
    for r in range(H):
        ftype = r % 5
        cur = rows[r]
        prev = rows[r - 1] if r else np.zeros_like(cur)
        out.append(ftype)
        for i in range(len(cur)):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
            out.append((cur[i] - pred) & 0xFF)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(bytes(out)))
                + _png_chunk(b"IEND", b""))


def _gray(rgb: np.ndarray) -> np.ndarray:
    """Pillow's convert("L") of 8-bit RGB: ITU-R 601-2 in fixed point."""
    r, g, b = (rgb[..., k].astype(np.uint32) for k in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


@pytest.mark.parametrize("kind", ["L", "RGB", "RGBA", "I16"])
@pytest.mark.parametrize("writer", ["pillow", "all_filters"])
def test_image_reads_bit_equal(tmp_path, rng, kind, writer):
    shape = {"L": (23, 37), "RGB": (23, 37, 3), "RGBA": (23, 37, 4),
             "I16": (23, 37)}[kind]
    if kind == "I16":
        arr = rng.integers(0, 65536, shape).astype(np.uint16)
        arr[0, :4] = [0, 1, 255, 65535]
    else:
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / f"{kind}.png")
    if writer == "pillow":
        tio.save_image(path, arr)
    else:
        _write_png_all_filters(path, arr)
    if kind == "I16":
        t = tio.load_depth(path, 5000.0)
        np.testing.assert_array_equal(t, jio.load_depth(path, 5000.0))
        np.testing.assert_array_equal(t, arr.astype(np.float32) / 5000.0)
        assert t.dtype == np.float32
        return
    t = tio.load_image(path)
    np.testing.assert_array_equal(t, jio.load_image(path))
    expect = arr if kind == "L" else _gray(arr[..., :3]) if kind == "RGB" \
        else np.asarray(Image.fromarray(arr).convert("L"))
    np.testing.assert_array_equal(t, expect)
    assert t.dtype == np.uint8 and t.shape == shape[:2]


def test_gray_conversion_formula_is_pillows(rng):
    rgb = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        _gray(rgb), np.asarray(Image.fromarray(rgb).convert("L")))


def test_trajectory_tum_matches_reference(tmp_path, rng):
    T = np.linalg.inv(_poses_wc(rng, 12)).astype(np.float32)
    ts = 1305031102.175304 + np.arange(12) * 0.0333
    path = str(tmp_path / "traj.txt")
    tio.save_trajectory_tum(path, ts, T)
    tts, tposes = tio.load_trajectory_tum(path)
    jts, jposes = jio.load_trajectory_tum(path)
    np.testing.assert_array_equal(tts, jts)
    # float32 rotations: translations of a few metres within 1e-6 relative
    np.testing.assert_allclose(tposes, jposes, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tposes, T, atol=1e-5)
    # the written files: timestamps and positions identical; quaternions
    # within one unit of their 7th decimal (XLA's CPU sums rot_to_quat's
    # norm with fused multiply-adds, which geometry._norm4 copies; ~0.7% of
    # general rotations still differ by 1-2 ulp, so a printed component
    # can differ in the last digit)
    jpath = str(tmp_path / "jtraj.txt")
    jio.save_trajectory_tum(jpath, ts, T)
    with open(path) as a, open(jpath) as b:
        ta = [line.split() for line in a]
        ja = [line.split() for line in b]
    assert [r[:4] for r in ta] == [r[:4] for r in ja]
    np.testing.assert_allclose(np.asarray([r[4:] for r in ta], float),
                               np.asarray([r[4:] for r in ja], float),
                               atol=1.01e-7, rtol=0)


def test_smoke_layouts_match_the_reference_hashes(tmp_path):
    """chip_smoke.py phase 12 holds every file it writes to the sha256 the
    JAX package's run read (coslam_tpu_torch/assets/
    smoke_dataset_expected.npz); the first two frames' images, depth maps
    and EuRoC's sensor.yaml written here carry the same bytes."""
    import chip_smoke as cs

    cs.dataset_layouts(str(tmp_path), 2)
    got = cs.dataset_hashes(str(tmp_path))
    ex = np.load(os.path.join(cs.ASSETS, "smoke_dataset_expected.npz"))
    want = dict(zip(ex["files"].tolist(), ex["sha256"].tolist()))
    per_frame = [k for k in got if k.endswith((".png", "sensor.yaml"))]
    assert len(per_frame) == 2 * 5 + 1
    for k in per_frame:
        assert got[k] == want[k], k

"""coslam_tpu_torch.scripts.make_proxy_datasets against the JAX side's
scripts/make_proxy_datasets.py (loaded from its file) at --frames 3: the
same file tree, every text file (lists, ground truth, calibration)
byte-equal — the ground-truth quaternions of both come from their package's
float32 `rot_to_quat` — and every image decoded pixel-equal."""

import os
import sys

import numpy as np
import pytest
from PIL import Image

from coslam_tpu_torch.scripts import make_proxy_datasets as tmp_ds

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_torch_smoke_assets as assets  # noqa: E402

FRAMES, SEED = 3, 11


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("proxies")
    jmp = assets.jax_script("make_proxy_datasets")
    for name, fn in (("tum_proxy", jmp.make_tum),
                     ("kitti_proxy", jmp.make_kitti),
                     ("euroc_proxy", jmp.make_euroc)):
        fn(str(root / "jax" / name), FRAMES, SEED)
    tmp_ds.make_all(str(root / "torch"), FRAMES, SEED, None, "cpu")
    return root / "jax", root / "torch"


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def test_the_same_tree(trees):
    j, t = trees
    names = _files(j)
    assert names == _files(t)
    assert sum(n.endswith(".png") for n in names) == FRAMES * 5
    assert {"tum_proxy/groundtruth.txt", "kitti_proxy/poses/00.txt",
            "euroc_proxy/mav0/cam0/sensor.yaml",
            "euroc_proxy/mav0/state_groundtruth_estimate0/data.csv"} \
        <= set(names)


@pytest.mark.parametrize("kind", ["text", "image"])
def test_files_equal(trees, kind):
    j, t = trees
    for name in _files(j):
        if name.endswith(".png") != (kind == "image"):
            continue
        if kind == "text":
            assert (j / name).read_bytes() == (t / name).read_bytes(), name
        else:
            with Image.open(j / name) as a, Image.open(t / name) as b:
                assert a.mode == b.mode, name
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=name)

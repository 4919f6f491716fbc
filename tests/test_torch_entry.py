"""coslam_tpu_torch/entry.py against __graft_entry__.py: the flagship
tracking step on the CPU.

`entry("cpu")`'s example arguments are bit-equal to the reference's (the
uint32 descriptors as their int32 view).  `track_step` runs on them and on
the tracking case of scripts/make_torch_smoke_assets.bench_case (frame 4 of
the bench's 8 frames, the previous frame's keypoints back-projected at the
rendered depth, the true pose as the prediction), against the reference's
jitted `track_step` on the CPU, its Pallas kernels in interpret mode.
Bars: the frame's valid mask equal and >= 99.9% of the valid keypoints'
descriptor bits equal (tests/test_torch_orb.py's); T within 1e-3;
n_inliers within 5 (tests/test_torch_pose_opt.py's).  The two prefixes'
counts equal those of bench.py's `ex_step` / `em_step` bodies.  The
committed asset coslam_tpu_torch/assets/smoke_bench_expected.npz, which
chip_smoke.py phase 13 holds the card to, equals the reference run made
here."""

import os
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from coslam_tpu_torch import entry
from coslam_tpu_torch.models.frame import build_frame

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import make_torch_smoke_assets as assets  # noqa: E402

torch.set_num_threads(1)
NAMES = ("img", "prev_uv", "prev_desc", "prev_valid", "prev_level",
         "pt_pos", "T_pred")


def _bits(desc: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(desc).view(np.uint8), axis=1)


@pytest.fixture(scope="module")
def reference():
    return assets.bench_reference()


def test_example_args_equal_reference():
    _, j = jentry.entry()
    _, t = entry.entry("cpu")
    assert len(t) == len(j) == 7
    for name, a, b in zip(NAMES, t, j):
        a = a.numpy()
        if name == "prev_desc":
            assert a.dtype == np.int32 and b.dtype == np.uint32
            b = b.view(np.int32)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_config_equals_reference():
    j, t = jentry._cfg(), entry.hot_path_config()
    for part in ("camera", "extractor", "matcher", "tracker"):
        assert vars(getattr(t, part)) == vars(getattr(j, part)), part


@pytest.mark.parametrize("tag", ["ex_", "case_"])
def test_track_step_matches_reference(reference, tag):
    args = [torch.from_numpy(np.array(reference[tag + n]).view(np.int32)
                             if n == "prev_desc" else
                             np.array(reference[tag + n])) for n in NAMES]
    T, n, desc = entry.track_step(*args)
    np.testing.assert_allclose(T.numpy(), reference[tag + "T"], atol=1e-3)
    assert abs(int(n) - int(reference[tag + "n_inliers"])) <= 5
    valid = build_frame(args[0], entry.HOT_PATH).valid.numpy()
    np.testing.assert_array_equal(valid, reference[tag + "valid"])
    ref_desc = reference[tag + "desc"].view(np.int32)
    agree = (_bits(desc.numpy()[valid]) == _bits(ref_desc[valid])).mean()
    assert agree >= 0.999, agree
    assert int(entry.extract_step(args[0])) \
        == int(reference[tag + "valid_count"])
    assert int(entry.extract_match_step(*args[:4])) \
        == int(reference[tag + "match_count"])
    if tag == "case_":       # a real tracking case: hundreds of pairs
        assert int(reference[tag + "match_count"]) > 200
        assert int(reference[tag + "n_inliers"]) > 100


def test_asset_equals_reference_run(reference):
    z = np.load(os.path.join(assets.ASSETS, assets.BENCH_ASSET))
    assert sorted(z.files) == sorted(reference)
    for k in z.files:
        np.testing.assert_array_equal(z[k], reference[k], err_msg=k)

"""Kernel K1's plain twin and the port's FAST ops against coslam_tpu: the
Pallas kernel in interpret mode and the XLA formulation nms3(fast_score).
Integer images make the scores exact; the comparison with the kernel is on
the interior (both references wrap at the border, the CUDA kernel clamps);
the pyramid twin with the extractor's border inside is held to the JAX
extractor's path, kernel then border mask, and is equal wherever either is
non-zero (exact: min, max and differences of the same f32 values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.ops import fast as jfast
from coslam_tpu.ops import pallas_kernels as pk
from coslam_tpu_torch.ops import cuda_kernels as ck
from coslam_tpu_torch.ops import fast as tfast
from coslam_tpu_torch.utils import kernel_cases as kc

INTERIOR = np.s_[8:-8, 8:-8]


@pytest.mark.parametrize("shape", [(64, 128), (67, 93)])
def test_twin_against_pallas_kernel(rng, shape):
    img = rng.integers(0, 255, shape).astype(np.float32)
    ref = np.asarray(pk.fast_score_nms(jnp.asarray(img)))
    out = ck.fast_score_nms(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out[INTERIOR], ref[INTERIOR], atol=1e-5)


def test_pyramid_twin_against_the_extractor_path():
    levels = kc.fast_inputs("cpu", 260, 200)
    assert len(levels) == 8 and min(levels[-1].shape) > 2 * kc.FAST_MARGIN
    out = ck.fast_score_nms_pyramid(levels, kc.FAST_MARGIN)
    assert len(out) == 8
    for img, got in zip(levels, out):
        h, w = img.shape
        ref = np.asarray(pk.fast_score_nms(jnp.asarray(img.numpy()))
                         * jfast.border_mask(h, w, kc.FAST_MARGIN))
        got = got.numpy()
        assert got.shape == ref.shape
        either = (got != 0) | (ref != 0)
        assert either.any()
        np.testing.assert_array_equal(got[either], ref[either])
        m = kc.FAST_MARGIN
        assert not either[:m].any() and not either[:, :m].any() \
            and not either[-m:].any() and not either[:, -m:].any()


def test_one_level_entry_is_the_unmasked_twin(rng):
    img = torch.from_numpy(rng.integers(0, 255, (40, 50)).astype(np.float32))
    assert torch.equal(ck.fast_score_nms(img), ck.fast_score_nms_plain(img))
    assert torch.equal(ck.fast_score_nms_pyramid([img], 0)[0],
                       ck.fast_score_nms_plain(img))
    assert ck.fast_score_nms_pyramid([], 19) == []


def test_twin_against_xla_formulation(rng):
    img = rng.integers(0, 255, (96, 160)).astype(np.float32)
    ref = np.asarray(jfast.nms3(jfast.fast_score(jnp.asarray(img))))
    out = ck.fast_score_nms(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out[INTERIOR], ref[INTERIOR], atol=1e-5)


def test_score_and_nms_equal_everywhere(rng):
    img = (rng.integers(0, 255, (50, 70))
           + rng.uniform(0, 1, (50, 70))).astype(np.float32)
    js = np.asarray(jfast.fast_score(jnp.asarray(img)))
    ts = tfast.fast_score(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(
        tfast.nms3(torch.from_numpy(ts)).numpy(),
        np.asarray(jfast.nms3(jnp.asarray(js))))


def test_border_mask_equal():
    np.testing.assert_array_equal(tfast.border_mask(60, 80, 19),
                                  jfast.border_mask(60, 80, 19))
    assert tfast.CIRCLE == jfast.CIRCLE and tfast.ARC_LEN == jfast.ARC_LEN

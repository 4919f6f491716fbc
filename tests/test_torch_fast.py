"""Kernel K1's plain twin and the port's FAST ops against coslam_tpu: the
Pallas kernel in interpret mode and the XLA formulation nms3(fast_score).
Integer images make the scores exact; the comparison with the kernel is on
the interior (both references wrap at the border, the CUDA kernel clamps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.ops import fast as jfast
from coslam_tpu.ops import pallas_kernels as pk
from coslam_tpu_torch.ops import cuda_kernels as ck
from coslam_tpu_torch.ops import fast as tfast

INTERIOR = np.s_[8:-8, 8:-8]


@pytest.mark.parametrize("shape", [(64, 128), (67, 93)])
def test_twin_against_pallas_kernel(rng, shape):
    img = rng.integers(0, 255, shape).astype(np.float32)
    ref = np.asarray(pk.fast_score_nms(jnp.asarray(img)))
    out = ck.fast_score_nms(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(out[INTERIOR], ref[INTERIOR], atol=1e-5)


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

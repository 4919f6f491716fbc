"""The seeded kernel inputs that chip_smoke.py and
scripts/compare_torch_kernels.py share, at a small size on the CPU."""

import numpy as np
import pytest
import torch

from coslam_tpu_torch.ops import cuda_kernels as ck
from coslam_tpu_torch.utils import kernel_cases as kc


def test_named_cases_exist():
    names = [c[0] for c in kc.MATCH_CASES]
    assert len(set(names)) == len(names)
    assert set(kc.MATCH_MAPPING_PAIR) | set(kc.MATCH_MAPPING_PAIR_DENSE) \
        <= set(names)
    assert kc.POSE_MAIN_PATH in [c[0] for c in kc.POSE_CASES]
    sim3_names = [c[0] for c in kc.SIM3_CASES]
    assert len(set(sim3_names)) == len(sim3_names)
    assert kc.SIM3_MAIN_PATH in sim3_names


def test_fast_inputs_through_the_twin():
    levels = kc.fast_inputs("cpu", 160, 120)
    assert [tuple(l.shape) for l in levels][:2] == [(120, 160), (100, 133)]
    assert len(levels) == 8 and all(l.dtype == torch.float32 for l in levels)
    scores = ck.fast_score_nms_pyramid(levels[:3], kc.FAST_MARGIN)
    for img, s in zip(levels, scores):
        assert s.shape == img.shape
        m = kc.FAST_MARGIN
        assert float(s[:m].abs().max()) == 0 == float(s[:, -m:].abs().max())
    assert float(scores[0].max()) > 0


@pytest.mark.parametrize("n,m,nvq,nvt,any_match", [
    (64, 256, None, None, True), (256, 64, 20, None, True),
    (64, 256, None, 20, True), (64, 256, None, 0, False),
    (256, 64, 0, None, False), (7, 0, None, None, False)])
def test_match_inputs_through_the_twin(n, m, nvq, nvt, any_match):
    args, kw = kc.match_inputs(np.random.default_rng(0), "cpu", n, m, nvq, nvt)
    assert int(args[3].sum()) == (nvq if nvq is not None else args[3].sum())
    assert int(args[6].sum()) == (nvt if nvt is not None else args[6].sum())
    best, _, idx = kc.match_plain(ck, args, kw)
    assert best.shape == idx.shape == (n,)
    assert bool((best < ck.INF_I32).any()) == any_match


@pytest.mark.parametrize("n,n_live", [(256, None), (256, 60)])
def test_pose_inputs_are_solvable(n, n_live):
    args, kw, Tgt = kc.pose_inputs(np.random.default_rng(0), "cpu", n, n_live)
    assert int((args[3] > 0).sum()) == (n_live or n - n // 10)
    T, inl = ck.pose_opt_lm_plain(*args, **kw)
    np.testing.assert_allclose(T.numpy(), Tgt, atol=2e-2)
    assert not bool(inl[args[3] == 0].any())
    assert torch.equal(args[0], torch.eye(4))


@pytest.mark.parametrize("n,n_valid,fix_scale,s_gt", [
    (64, 0, False, 1.4), (64, 20, False, 1.4), (64, 20, True, 1.0),
    (128, 60, False, 0.07)])
def test_sim3_inputs_are_solvable(n, n_valid, fix_scale, s_gt):
    """The polish's plain version recovers the Sim3 the pairs were made
    from (and leaves the start alone with no valid pair); `sim3_gaps` of
    an output against itself is nothing."""
    from coslam_tpu_torch.ops import sim3

    cam, args, kw = kc.sim3_inputs(np.random.default_rng(0), "cpu", n,
                                   n_valid, fix_scale, s_gt)
    assert [tuple(a.shape) for a in args] == [(n, 3), (n, 3), (n, 2),
                                              (n, 2), (), (3, 3), (3,), (n,)]
    assert int(args[7].sum()) == n_valid and args[7].dtype == torch.bool
    assert kw == dict(fix_scale=fix_scale, chi2_th=kc.SIM3_CHI2)
    out = sim3.refine_sim3_plain(cam, *args, **kw)
    assert kc.sim3_gaps(sim3, cam, args, kw, out, out) == (0.0, 0, 0)
    assert not bool(out[3][~args[7]].any())
    if n_valid == 0:
        assert all(torch.equal(o, a) for o, a in zip(out[:3], args[4:7]))
        return
    assert abs(float(out[0]) / s_gt - 1.0) < (1e-6 if fix_scale else 0.02)
    assert int(out[3].sum()) >= 0.7 * n_valid

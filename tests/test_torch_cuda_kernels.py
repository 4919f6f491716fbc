"""The CUDA kernels against their plain twins on the GPU.

Marked `cuda`: every test skips where torch.cuda.is_available() is False.
On a GPU machine (which need not have jax, so skip tests/conftest.py):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from coslam_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture()
def gen():
    return np.random.default_rng(7)


@pytest.mark.parametrize("shape", [(480, 640), (134, 179), (37, 45)])
def test_fast_score_nms(dev, gen, shape):
    img = torch.as_tensor(gen.integers(0, 255, shape).astype(np.float32)
                          + gen.uniform(0, 1, shape).astype(np.float32),
                          device=dev)
    before = ck.LAUNCHES["fast_score_nms"]
    got = ck.fast_score_nms(img)
    assert ck.LAUNCHES["fast_score_nms"] == before + 1
    ref = ck.fast_score_nms_plain(img)
    torch.testing.assert_close(got[8:-8, 8:-8], ref[8:-8, 8:-8], atol=1e-5,
                               rtol=0)


def _match_inputs(gen, dev, n, m):
    dq = gen.integers(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64)
    dt = gen.integers(-2 ** 31, 2 ** 31, (m, 8), dtype=np.int64)
    k = min(n, m) // 2
    dt[:k] = dq[:k] ^ (1 << gen.integers(0, 31, (k, 8)))
    j = max(0, min(10, m - k, n))
    dt[k:k + j] = dq[:j]                # exact duplicates: ties
    uq = gen.uniform(0, 640, (n, 2))
    ut = gen.uniform(0, 640, (m, 2))
    ut[:k] = uq[:k] + gen.normal(0, 4, (k, 2))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return dict(
        desc_q=torch.as_tensor(dq.astype(np.int32), device=dev), uv_q=f(uq),
        r2_q=f(gen.uniform(10, 60, n) ** 2),
        valid_q=torch.as_tensor(gen.uniform(size=n) > 0.1, device=dev),
        desc_t=torch.as_tensor(dt.astype(np.int32), device=dev), uv_t=f(ut),
        valid_t=torch.as_tensor(gen.uniform(size=m) > 0.1, device=dev),
        level_q=f(gen.integers(0, 8, n)), level_t=f(gen.integers(0, 8, m)),
        r2_t=f(gen.uniform(10, 60, m) ** 2))


@pytest.mark.parametrize("n,m", [(1024, 1024), (32768, 1024), (1024, 32768),
                                 (16384, 1024), (1024, 16384),
                                 (100, 3000), (7, 0)])
def test_masked_match(dev, gen, n, m):
    a = _match_inputs(gen, dev, n, m)
    before = ck.LAUNCHES["masked_match"]
    got = ck.masked_match(**a, level_lo=-1, level_hi=1)
    assert ck.LAUNCHES["masked_match"] == before + 1
    ref = ck.masked_match_plain(
        a["desc_q"], a["uv_q"], a["r2_q"], a["valid_q"], a["level_q"],
        a["desc_t"], a["uv_t"], a["valid_t"], a["r2_t"], a["level_t"],
        True, -1.0, 1.0)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    has = ref[0] < ck.INF_I32
    assert torch.equal(got[2][has], ref[2][has])
    assert bool((got[2][~has] == -1).all())


def test_masked_match_rejects_bad_inputs(dev, gen):
    a = _match_inputs(gen, dev, 64, 64)
    with pytest.raises(TypeError):
        ck.masked_match(**{**a, "desc_q": a["desc_q"].to(torch.int64)})
    with pytest.raises(ValueError):
        ck.masked_match(**{**a, "uv_t": a["uv_t"].cpu()})


def test_pose_opt_lm(dev, gen):
    n = 1024
    X = np.stack([gen.uniform(-2, 2, n), gen.uniform(-2, 2, n),
                  gen.uniform(4, 10, n)], 1)
    t = np.array([0.1, -0.05, 0.08])
    pc = X + t
    uv = np.stack([pc[:, 0] / pc[:, 2] * 400 + 320,
                   pc[:, 1] / pc[:, 2] * 400 + 240], 1)
    uv += gen.normal(0, 0.5, uv.shape)
    out = gen.choice(n, 100, replace=False)
    uv[out] += gen.uniform(20, 80, (100, 2))
    isg = np.where(gen.uniform(size=n) > 0.1, 1.0, 0.0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    args = (torch.eye(4, device=dev), f(X), f(uv), f(isg))
    kw = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, rounds=4, iters=10,
              chi2_th=5.991)
    before = ck.LAUNCHES["pose_opt_lm"]
    Tk, ik = ck.pose_opt_lm(*args, **kw)
    assert ck.LAUNCHES["pose_opt_lm"] == before + 1
    Tp, ip = ck.pose_opt_lm_plain(*args, **kw)
    torch.testing.assert_close(Tk, Tp, atol=1e-3, rtol=0)
    assert int((ik != ip).sum()) <= 5
    assert not bool(ik[torch.as_tensor(out, device=dev)].any())
    np.testing.assert_allclose(Tk[:3, 3].cpu().numpy(), t, atol=5e-3)

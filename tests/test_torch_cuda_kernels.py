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
from coslam_tpu_torch.utils import kernel_cases as kc

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture()
def gen():
    return np.random.default_rng(7)


def _image(gen, dev, shape):
    return torch.as_tensor(gen.integers(0, 255, shape).astype(np.float32)
                           + gen.uniform(0, 1, shape).astype(np.float32),
                           device=dev)


@pytest.mark.parametrize("shape", [(480, 640), (134, 179), (37, 45)])
def test_fast_score_nms(dev, gen, shape):
    """The one-level entry, no border mask: equal to the twin away from the
    image border, where the twin wraps and the kernel clamps."""
    img = _image(gen, dev, shape)
    before = ck.LAUNCHES["fast_score_nms"]
    got = ck.fast_score_nms(img)
    assert ck.LAUNCHES["fast_score_nms"] == before + 1
    ref = ck.fast_score_nms_plain(img)
    torch.testing.assert_close(got[8:-8, 8:-8], ref[8:-8, 8:-8], atol=1e-5,
                               rtol=0)
    # 4 px inside is enough: 3 for the circle, 1 for the NMS window
    assert torch.equal(got[4:-4, 4:-4], ref[4:-4, 4:-4])


@pytest.mark.parametrize("shapes,margin", [
    ([(480, 640), (400, 533), (333, 444), (278, 370), (231, 309), (193, 257),
      (161, 214), (134, 179)], 19),                # the path's pyramid
    ([(480, 640), (400, 533), (333, 444), (278, 370), (231, 309), (193, 257),
      (161, 214), (134, 179)], 0),
    ([(400, 533), (134, 179)], 19),                # odd widths, two levels
    ([(480, 640)], 19),
    ([(9, 11), (14, 62), (15, 63)], 0),            # under and around one tile
    ([(50, 70), (40, 41), (38, 100)], 19),         # a kept region of 0-2 px
    ([(60, 200)], 4), ([(60, 200)], 33)])
def test_fast_score_nms_pyramid(dev, gen, shapes, margin):
    """One launch for all levels, the border mask inside: every level equal
    to the twin (everywhere for margin >= 4, else 4 px inside)."""
    levels = [_image(gen, dev, s) for s in shapes]
    before = ck.LAUNCHES["fast_score_nms"]
    got = ck.fast_score_nms_pyramid(levels, margin)
    assert ck.LAUNCHES["fast_score_nms"] == before + 1
    ref = ck.fast_score_nms_pyramid_plain(levels, margin)
    assert len(got) == len(levels)
    for g, r, img in zip(got, ref, levels):
        assert g.shape == img.shape and g.is_contiguous()
        if margin >= 4:
            torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
            assert torch.equal(g, r)
        elif min(img.shape) > 8:
            assert torch.equal(g[4:-4, 4:-4], r[4:-4, 4:-4])
        assert bool(torch.isfinite(g).all())


def test_fast_score_nms_pyramid_more_levels_than_a_launch_takes(dev, gen):
    levels = [_image(gen, dev, (40 + i, 50 + i)) for i in range(10)]
    before = ck.LAUNCHES["fast_score_nms"]
    got = ck.fast_score_nms_pyramid(levels, 5)
    assert ck.LAUNCHES["fast_score_nms"] == before + 2
    for g, r in zip(got, ck.fast_score_nms_pyramid_plain(levels, 5)):
        assert torch.equal(g, r)


def test_fast_score_nms_rejects_bad_inputs(dev, gen):
    img = _image(gen, dev, (40, 50))
    with pytest.raises(TypeError):
        ck.fast_score_nms_pyramid([img.to(torch.float64)], 19)
    with pytest.raises(ValueError):
        ck.fast_score_nms_pyramid([img, img.cpu()], 19)
    with pytest.raises(ValueError):
        ck.fast_score_nms_pyramid([img], -1)


def _match_inputs(gen, dev, n, m, n_valid_q=None, n_valid_t=None):
    """n_valid_*: only the first so many rows of that side are valid (a map
    table whose tail is empty), else 90% at random."""
    dq = gen.integers(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64)
    dt = gen.integers(-2 ** 31, 2 ** 31, (m, 8), dtype=np.int64)
    k = min(n, m) // 2
    dt[:k] = dq[:k] ^ (1 << gen.integers(0, 31, (k, 8)))
    j = max(0, min(10, m - k, n))
    dt[k:k + j] = dq[:j]                # exact duplicates: ties
    uq = gen.uniform(0, 640, (n, 2))
    ut = gen.uniform(0, 640, (m, 2))
    ut[:k] = uq[:k] + gen.normal(0, 4, (k, 2))
    ut[k:k + j] = uq[:j] + gen.normal(0, 4, (j, 2))
    vq = gen.uniform(size=n) > 0.1 if n_valid_q is None \
        else np.arange(n) < n_valid_q
    vt = gen.uniform(size=m) > 0.1 if n_valid_t is None \
        else np.arange(m) < n_valid_t
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return dict(
        desc_q=torch.as_tensor(dq.astype(np.int32), device=dev), uv_q=f(uq),
        r2_q=f(gen.uniform(10, 60, n) ** 2),
        valid_q=torch.as_tensor(vq, device=dev),
        desc_t=torch.as_tensor(dt.astype(np.int32), device=dev), uv_t=f(ut),
        valid_t=torch.as_tensor(vt, device=dev),
        level_q=f(gen.integers(0, 8, n)), level_t=f(gen.integers(0, 8, m)),
        r2_t=f(gen.uniform(10, 60, m) ** 2))


def _assert_matches_twin(a, **kw):
    before = ck.LAUNCHES["masked_match"]
    got = ck.masked_match(**a, **kw)
    assert ck.LAUNCHES["masked_match"] == before + 1
    n, m = a["desc_q"].shape[0], a["desc_t"].shape[0]
    dev = a["desc_q"].device
    fill = lambda t, size, v: t if t is not None else torch.full(
        (size,), v, dtype=torch.float32, device=dev)
    lo, hi = kw.get("level_lo", -1e9), kw.get("level_hi", 1e9)
    ref = ck.masked_match_plain(
        a["desc_q"], a["uv_q"], fill(a["r2_q"], n, 1e18), a["valid_q"],
        fill(a.get("level_q"), n, 0.0), a["desc_t"], a["uv_t"], a["valid_t"],
        fill(a.get("r2_t"), m, 1e18), fill(a.get("level_t"), m, 0.0),
        lo > -100 or hi < 100, float(lo), float(hi))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    has = ref[0] < ck.INF_I32
    assert torch.equal(got[2][has], ref[2][has])
    assert bool((got[2][~has] == -1).all())
    return int(has.sum())


@pytest.mark.parametrize("n,m", [(1024, 1024), (32768, 1024), (1024, 32768),
                                 (16384, 1024), (1024, 16384),
                                 (100, 3000), (1000, 3001), (5000, 777),
                                 (2049, 130), (7, 0)])
def test_masked_match(dev, gen, n, m):
    n_has = _assert_matches_twin(_match_inputs(gen, dev, n, m),
                                 level_lo=-1, level_hi=1)
    assert (n_has > 0) == (m > 0)


@pytest.mark.parametrize("n,m,n_valid_q,n_valid_t", [
    (32768, 1024, 361, None), (1024, 32768, None, 361),   # a map table, its
    (16384, 1024, 319, None), (1024, 16384, None, 319),   # tail empty
    (4096, 1024, 40, None), (1024, 4096, None, 40),
    (1024, 4096, None, 0), (4096, 1024, None, 0),         # no valid target
    (1024, 4096, 0, None), (4096, 1024, 0, None)])        # no valid query
def test_masked_match_sparse_tables(dev, gen, n, m, n_valid_q, n_valid_t):
    n_has = _assert_matches_twin(
        _match_inputs(gen, dev, n, m, n_valid_q, n_valid_t),
        level_lo=-1, level_hi=1)
    assert (n_has > 0) == (n_valid_q != 0 and n_valid_t != 0)


def test_masked_match_lone_target_in_a_late_tile(dev, gen):
    """Every tile but one is skipped; the one target is still found."""
    a = _match_inputs(gen, dev, 300, 16384)
    m = 16384
    a["valid_t"] = torch.zeros(m, dtype=torch.bool, device=dev)
    a["valid_t"][m - 3] = True
    a["uv_q"][5] = a["uv_t"][m - 3]
    a["valid_q"][5] = True
    a["r2_t"][m - 3] = 1e6
    a["level_q"][5] = a["level_t"][m - 3]
    assert _assert_matches_twin(a, level_lo=-1, level_hi=1) >= 1
    idx = ck.masked_match(**a, level_lo=-1, level_hi=1)[2]
    assert int(idx[5]) == m - 3


@pytest.mark.parametrize("n", [1024, 4096])
def test_masked_match_optional_inputs_absent(dev, gen, n):
    """No query radius (the reverse pass of the mutual check), no target
    radii and no octaves: null pointers in the kernel."""
    a = _match_inputs(gen, dev, n, 2048)
    a.update(r2_q=None, r2_t=None, level_q=None, level_t=None)
    a["uv_t"][:200] = a["uv_q"][:200]
    assert _assert_matches_twin(a) > 0
    a = _match_inputs(gen, dev, n, 2048)
    a.update(r2_q=None, level_q=None)
    assert _assert_matches_twin(a, level_lo=0, level_hi=2) > 0


def test_masked_match_repeated_launches_reuse_scratch(dev, gen):
    """The ticket counters are left zero by every launch."""
    a = _match_inputs(gen, dev, 1024, 16384)
    for _ in range(3):
        _assert_matches_twin(a, level_lo=-1, level_hi=1)


def test_masked_match_rejects_bad_inputs(dev, gen):
    a = _match_inputs(gen, dev, 64, 64)
    with pytest.raises(TypeError):
        ck.masked_match(**{**a, "desc_q": a["desc_q"].to(torch.int64)})
    with pytest.raises(ValueError):
        ck.masked_match(**{**a, "uv_t": a["uv_t"].cpu()})


@pytest.mark.parametrize("n,n_live", [(1024, None), (1024, 215), (200, None),
                                      (3000, None)])
def test_pose_opt_lm(dev, gen, n, n_live):
    """N = 1024 is the main path, where a few hundred of the slots carry
    information (n_live) and the kernel packs them; 200 is below the block
    size; 3000 is above the register path's limit and takes the strided
    loop."""
    X = np.stack([gen.uniform(-2, 2, n), gen.uniform(-2, 2, n),
                  gen.uniform(4, 10, n)], 1)
    t = np.array([0.1, -0.05, 0.08])
    pc = X + t
    uv = np.stack([pc[:, 0] / pc[:, 2] * 400 + 320,
                   pc[:, 1] / pc[:, 2] * 400 + 240], 1)
    uv += gen.normal(0, 0.5, uv.shape)
    n_out = n // 10
    out = gen.choice(n, n_out, replace=False)
    uv[out] += gen.uniform(20, 80, (n_out, 2))
    isg = np.where(gen.uniform(size=n) > 0.1, 1.0, 0.0)
    if n_live is not None:
        isg[:] = 0.0
        isg[gen.choice(n, n_live, replace=False)] = 1.0
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    args = (torch.eye(4, device=dev), f(X), f(uv), f(isg))
    kw = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, rounds=4, iters=10,
              chi2_th=5.991)
    before = ck.LAUNCHES["pose_opt_lm"]
    Tk, ik = ck.pose_opt_lm(*args, **kw)
    assert ck.LAUNCHES["pose_opt_lm"] == before + 1
    assert (n > ck._lib().coslam_pose_opt_lm_register_limit()) == (n == 3000)
    Tp, ip = ck.pose_opt_lm_plain(*args, **kw)
    torch.testing.assert_close(Tk, Tp, atol=1e-3, rtol=0)
    assert int((ik != ip).sum()) <= 5
    assert not bool(ik[torch.as_tensor(out, device=dev)].any())
    assert not bool(ik[torch.as_tensor(isg == 0, device=dev)].any())
    np.testing.assert_allclose(
        Tk[:3, 3].cpu().numpy(), t,
        atol=5e-3 if n >= 1024 and n_live is None else 2e-2)


def test_pose_opt_lm_zero_rounds(dev, gen):
    """No LM round: the pose comes back as given, every observation with
    information counts as an inlier."""
    n = 300
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    isg = np.where(gen.uniform(size=n) > 0.3, 1.0, 0.0)
    T0 = torch.eye(4, device=dev)
    T, inl = ck.pose_opt_lm(T0, f(gen.uniform(1, 5, (n, 3))),
                            f(gen.uniform(0, 600, (n, 2))), f(isg), fx=400.0,
                            fy=400.0, cx=320.0, cy=240.0, rounds=0, iters=10,
                            chi2_th=5.991)
    assert torch.equal(T, T0)
    assert torch.equal(inl.cpu(), torch.as_tensor(isg > 0))


@pytest.mark.parametrize("case", range(len(kc.SIM3_CASES)),
                         ids=[c[0] for c in kc.SIM3_CASES])
def test_sim3_refine_lm(dev, case):
    """K4 against its plain version (`sim3.refine_sim3_plain`) on the card,
    through `sim3.refine_sim3`'s dispatch: one launch, s / R / t within
    1e-4 (float32 sums in another order and the kernel's fast reciprocals
    and roots part the two at ~1e-5 on 1024 pairs; the LM steps stay the
    same), the inlier masks equal except for pairs whose gate error lies
    within 1e-3 px^2 of chi2_th at the plain version's Sim3, where a
    rounding decides."""
    from coslam_tpu_torch.ops import sim3

    name, n, n_valid, fix_scale, s_gt = kc.SIM3_CASES[case]
    rng = np.random.default_rng([kc.SIM3_SEED, case])
    cam, args, kw = kc.sim3_inputs(rng, dev, n, n_valid, fix_scale, s_gt)
    before = ck.LAUNCHES["sim3_refine_lm"]
    got = sim3.refine_sim3(cam, *args, **kw)
    assert ck.LAUNCHES["sim3_refine_lm"] == before + 1
    assert (n > ck._lib().coslam_sim3_refine_lm_register_limit()) \
        == (n == 2048)
    ref = sim3.refine_sim3_plain(cam, *args, **kw)
    assert got[0].shape == ref[0].shape == ()
    assert got[1].shape == (3, 3) and got[2].shape == (3,)
    assert got[3].dtype == torch.bool and got[3].shape == (n,)
    err, far, _ = kc.sim3_gaps(sim3, cam, args, kw, got, ref)
    assert err <= 1e-4, name
    assert far == 0, name
    assert not bool(got[3][~args[7]].any())
    if fix_scale:
        assert float(got[0]) == float(args[4])
    if n_valid == 0:                  # nothing to fit: the start comes back
        for g, a in zip(got[:3], args[4:7]):
            assert torch.equal(g, a)


def test_sim3_refine_lm_repeated_and_rejects_bad_inputs(dev):
    """Back-to-back launches agree bit for bit; a wrong type, a wrong shape
    or mixed devices raise before any launch."""
    cam, args, kw = kc.sim3_inputs(np.random.default_rng(3), dev, 1024, 215)
    kk = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, iters1=5,
              iters2=10, **kw)
    a = ck.sim3_refine_lm(*args, **kk)
    b = ck.sim3_refine_lm(*args, **kk)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    before = ck.LAUNCHES["sim3_refine_lm"]
    with pytest.raises(TypeError):
        ck.sim3_refine_lm(*args[:7], args[7].float(), **kk)
    with pytest.raises(ValueError):
        ck.sim3_refine_lm(args[0][:, :2].contiguous(), *args[1:], **kk)
    with pytest.raises(ValueError):
        ck.sim3_refine_lm(*args[:4], args[4].cpu(), *args[5:], **kk)
    assert ck.LAUNCHES["sim3_refine_lm"] == before


def test_track_step_graph_replay_equals_eager(dev):
    """The hot path captured as one CUDA graph of 4 consecutive
    `track_step`s: a replay's outputs (T, n_inliers, desc) equal the same
    loop's eager outputs, and the capture recorded K1 once, K2 twice and K3
    once a frame; a replay launches through no wrapper, so it adds no
    count."""
    from coslam_tpu_torch import bench
    from coslam_tpu_torch import entry

    step, example = entry.entry(dev)
    imgs = torch.from_numpy(bench.hot_path_frames(0, 4)).to(dev)
    loop = bench.frame_loop(step, imgs, example[1:])
    eager = loop()
    g = bench.capture(loop, dev)
    assert g.launches == {"fast_score_nms": 4, "masked_match": 8,
                          "pose_opt_lm": 4}
    before = dict(ck.LAUNCHES)
    g.replay()
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before
    for a, b in zip(g.out, eager):
        assert torch.equal(a, b)

"""Kernel K2's plain twin and the port's matchers against coslam_tpu.

  * twin vs the Pallas `masked_match` (interpret mode), with level gates and
    per-target radii: best and second exactly equal, idx equal wherever a
    match exists;
  * the port's single-route `match_windowed` (forward pass + reversed
    mutual pass) vs the reference's dense route on the CPU: idx and valid
    exactly equal;
  * dense `match` and the Hamming helpers: exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.ops import hamming as jham
from coslam_tpu.ops import matching as jmatch
from coslam_tpu.ops import pallas_kernels as pk
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.ops import cuda_kernels as ck
from coslam_tpu_torch.ops import hamming as tham
from coslam_tpu_torch.ops import matching as tmatch


def _problem(rng, n, m, n_true=100):
    dq = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    dt = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    k = min(n_true, n, m)
    dt[:k] = dq[:k]
    for i in range(k // 2):
        dt[i, i % 8] ^= np.uint32(1 << (i % 32))
    dt[k:k + 20] = dq[:20]          # duplicates: ties in best / second
    uvq = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    uvt = rng.uniform(0, 300, (m, 2)).astype(np.float32)
    uvt[:k] = uvq[:k] + rng.normal(0, 3, (k, 2))
    uvt[k:k + 20] = uvq[:20] + rng.normal(0, 3, (20, 2))
    return dict(
        dq=dq, dt=dt, uvq=uvq, uvt=uvt,
        r2q=(rng.uniform(5, 40, n) ** 2).astype(np.float32),
        r2t=(rng.uniform(5, 40, m) ** 2).astype(np.float32),
        vq=rng.uniform(size=n) > 0.05, vt=rng.uniform(size=m) > 0.05,
        lq=rng.integers(0, 8, n).astype(np.float32),
        lt=rng.integers(0, 8, m).astype(np.float32))


def _t(a):
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _sparse(p, case):
    """Validity of a map table: only the head of one side holds anything."""
    n, m = len(p["vq"]), len(p["vt"])
    if case == "map_like_targets":
        p["vt"] = np.arange(m) < 40
    elif case == "map_like_queries":
        p["vq"] = np.arange(n) < 40
    elif case == "all_targets_invalid":
        p["vt"] = np.zeros(m, bool)
    elif case == "all_queries_invalid":
        p["vq"] = np.zeros(n, bool)
    return p


@pytest.mark.parametrize("gates", ["window", "levels_r2t", "map_like_targets",
                                   "map_like_queries", "all_targets_invalid",
                                   "all_queries_invalid"])
def test_twin_against_pallas_kernel(rng, gates):
    if gates == "map_like_targets":      # first 40 of 4096 target slots valid
        p = _sparse(_problem(rng, 256, 4096, n_true=40), gates)
    elif gates == "map_like_queries":    # ... and the reverse direction
        p = _sparse(_problem(rng, 4096, 256, n_true=40), gates)
    else:
        p = _sparse(_problem(rng, 256, 512), gates)
    kw_j, kw_t = {}, {}
    if gates != "window":
        kw_j = dict(level_q=jnp.asarray(p["lq"]), level_t=jnp.asarray(p["lt"]),
                    level_lo=-1, level_hi=1, r2_t=jnp.asarray(p["r2t"]))
        kw_t = dict(level_q=_t(p["lq"]), level_t=_t(p["lt"]), level_lo=-1,
                    level_hi=1, r2_t=_t(p["r2t"]))
    jb, js, ji = (np.asarray(a) for a in pk.masked_match(
        jnp.asarray(p["dq"]), jnp.asarray(p["uvq"]), jnp.asarray(p["r2q"]),
        jnp.asarray(p["vq"]), jnp.asarray(p["dt"]), jnp.asarray(p["uvt"]),
        jnp.asarray(p["vt"]), block_n=128, block_m=256, **kw_j))
    tb, ts, ti = (a.numpy() for a in ck.masked_match(
        _t(p["dq"]), _t(p["uvq"]), _t(p["r2q"]), _t(p["vq"]), _t(p["dt"]),
        _t(p["uvt"]), _t(p["vt"]), **kw_t))
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)
    has = jb < int(pk.INF_I32)
    if gates.startswith("all_"):
        assert not has.any()
    elif gates.startswith("map_like"):
        assert 5 < has.sum() <= 40 * (1 if gates == "map_like_queries" else 256)
    else:
        assert has.sum() > 50
    np.testing.assert_array_equal(ti[has], ji[has])
    assert (ti[~has] == -1).all()


@pytest.mark.parametrize("sparse", [False, True])
def test_validity_folded_into_negative_radius(rng, sparse):
    """The CUDA kernel stores an invalid target's squared radius as -1 and
    drops the validity test: no squared distance passes a negative radius,
    so the twin's outputs do not change."""
    p = _problem(rng, 300, 700)
    if sparse:
        p["vt"] = np.arange(700) < 40
    args = [_t(p[k]) for k in ("dq", "uvq", "r2q", "vq", "lq", "dt", "uvt",
                               "vt", "r2t", "lt")]
    ref = ck.masked_match_plain(*args, True, -1.0, 1.0)
    folded = list(args)
    folded[7] = torch.ones(700, dtype=torch.bool)
    folded[8] = torch.where(args[7], args[8], -1.0)
    got = ck.masked_match_plain(*folded, True, -1.0, 1.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    assert int((ref[0] < ck.INF_I32).sum()) > 5


def test_absent_optional_inputs_equal_the_reference_defaults(rng):
    """r2_q=None (the reverse pass of the mutual check), r2_t=None and absent
    octaves mean the reference's 1e18 radii and octave 0."""
    p = _problem(rng, 200, 300)
    n, m = 200, 300
    base = (_t(p["dq"]), _t(p["uvq"]), None, _t(p["vq"]), _t(p["dt"]),
            _t(p["uvt"]), _t(p["vt"]))
    got = ck.masked_match(*base, level_t=_t(p["lt"]), level_lo=0, level_hi=2,
                          r2_t=_t(p["r2t"]))
    ref = ck.masked_match(base[0], base[1], torch.full((n,), 1e18), *base[3:],
                          level_q=torch.zeros(n), level_t=_t(p["lt"]),
                          level_lo=0, level_hi=2, r2_t=_t(p["r2t"]))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    jb, js, ji = (np.asarray(a) for a in pk.masked_match(
        jnp.asarray(p["dq"][:128]), jnp.asarray(p["uvq"][:128]),
        jnp.full(128, 1e18, jnp.float32), jnp.asarray(p["vq"][:128]),
        jnp.asarray(p["dt"][:256]), jnp.asarray(p["uvt"][:256]),
        jnp.asarray(p["vt"][:256]), r2_t=jnp.asarray(p["r2t"][:256]),
        block_n=128, block_m=256))
    tb, ts, ti = (a.numpy() for a in ck.masked_match(
        _t(p["dq"][:128]), _t(p["uvq"][:128]), None, _t(p["vq"][:128]),
        _t(p["dt"][:256]), _t(p["uvt"][:256]), _t(p["vt"][:256]),
        r2_t=_t(p["r2t"][:256])))
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)
    has = jb < int(pk.INF_I32)
    assert has.sum() > 20
    np.testing.assert_array_equal(ti[has], ji[has])


def test_twin_on_empty_target_set(rng):
    """No targets (an empty keyframe or map): every query gets the sentinel
    and idx -1, as the kernel writes them."""
    n = 7
    dq = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32)
    b, s, i = ck.masked_match(
        _t(dq), _t(rng.uniform(0, 300, (n, 2)).astype(np.float32)),
        torch.full((n,), 100.0), torch.ones(n, dtype=torch.bool),
        torch.zeros((0, 8), dtype=torch.int32), f32(0, 2),
        torch.zeros(0, dtype=torch.bool), level_q=f32(n), level_t=f32(0),
        level_lo=-1, level_hi=1, r2_t=f32(0))
    assert (b.numpy() == int(pk.INF_I32)).all()
    assert (s.numpy() == int(pk.INF_I32)).all()
    assert (i.numpy() == -1).all()


@pytest.mark.parametrize("variant", ["motion", "local_map", "plain"])
def test_match_windowed_equals_reference_dense_route(rng, variant):
    N, M = 300, 200
    p = _problem(rng, N, M, n_true=150)
    ang_q = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    ang_t = ang_q[:M] + rng.normal(0, 0.05, M).astype(np.float32)
    radius = (rng.uniform(4, 30, N).astype(np.float32) if variant != "plain"
              else np.float32(25.0))
    kw = dict(max_dist=100, mutual=True)
    if variant == "motion":
        kw.update(level_lo=-1, level_hi=1)
    elif variant == "local_map":
        kw.update(level_lo=-1, level_hi=1, ratio=0.8)
    else:
        kw.update(ratio=0.9)
    lvl = variant != "plain"
    jm = jmatch.match_windowed(
        jnp.asarray(p["dq"]), jnp.asarray(p["uvq"]), jnp.asarray(radius),
        jnp.asarray(p["vq"]), jnp.asarray(p["dt"]), jnp.asarray(p["uvt"]),
        jnp.asarray(p["vt"]), jcfg.MatcherConfig(),
        level_q=jnp.asarray(p["lq"].astype(np.int32)) if lvl else None,
        level_t=jnp.asarray(p["lt"].astype(np.int32)) if lvl else None,
        angle_q=jnp.asarray(ang_q), angle_t=jnp.asarray(ang_t), **kw)
    tm = tmatch.match_windowed(
        _t(p["dq"]), _t(p["uvq"]), torch.as_tensor(radius), _t(p["vq"]),
        _t(p["dt"]), _t(p["uvt"]), _t(p["vt"]), tcfg.MatcherConfig(),
        level_q=_t(p["lq"].astype(np.int32)) if lvl else None,
        level_t=_t(p["lt"].astype(np.int32)) if lvl else None,
        angle_q=_t(ang_q), angle_t=_t(ang_t), **kw)
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    np.testing.assert_array_equal(tm.idx.numpy(), np.asarray(jm.idx))
    np.testing.assert_array_equal(tm.dist.numpy(), np.asarray(jm.dist))
    assert int(tm.valid.sum()) > 20


def test_dense_match_and_hamming_equal(rng):
    p = _problem(rng, 180, 150)
    dq, dt = p["dq"], p["dt"]
    np.testing.assert_array_equal(
        tham.pairwise_hamming(_t(dq), _t(dt)).numpy(),
        np.asarray(jham.pairwise_hamming(jnp.asarray(dq), jnp.asarray(dt))))
    np.testing.assert_array_equal(
        tham.pairwise_hamming_pm1(_t(dq), _t(dt)).numpy(),
        np.asarray(jham.pairwise_hamming_mxu(jnp.asarray(dq),
                                             jnp.asarray(dt))))
    np.testing.assert_array_equal(
        tham.popcount_u32(_t(dq)).numpy(),
        np.asarray(jham.popcount_u32(jnp.asarray(dq))))
    ang_q = rng.uniform(-np.pi, np.pi, 180).astype(np.float32)
    ang_t = rng.uniform(-np.pi, np.pi, 150).astype(np.float32)
    ang_t[:100] = ang_q[:100] + 0.3
    jm = jmatch.match(jnp.asarray(dq), jnp.asarray(p["vq"]), jnp.asarray(dt),
                      jnp.asarray(p["vt"]), jcfg.MatcherConfig(),
                      max_dist=50, ratio=0.7, mutual=True,
                      angle_q=jnp.asarray(ang_q), angle_t=jnp.asarray(ang_t))
    tm = tmatch.match(_t(dq), _t(p["vq"]), _t(dt), _t(p["vt"]),
                      tcfg.MatcherConfig(), max_dist=50, ratio=0.7,
                      mutual=True, angle_q=_t(ang_q), angle_t=_t(ang_t))
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(tm.valid.sum()) > 20

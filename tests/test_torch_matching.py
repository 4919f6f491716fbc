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


@pytest.mark.parametrize("gates", ["window", "levels_r2t"])
def test_twin_against_pallas_kernel(rng, gates):
    p = _problem(rng, 256, 512)
    kw_j, kw_t = {}, {}
    if gates == "levels_r2t":
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
    assert has.sum() > 50
    np.testing.assert_array_equal(ti[has], ji[has])
    assert (ti[~has] == -1).all()


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

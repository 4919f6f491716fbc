"""Port pose-graph optimisation against coslam_tpu on the same graphs: the
per-edge residuals and Jacobian blocks (held to `jax.jacfwd`'s values), the
dense solver, the matrix-free PCG solver, and sparse against dense as the
reference's own test does (tests/test_sim3_posegraph.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.optim import pose_graph as jpg
from coslam_tpu.utils import geometry as jgeo
from coslam_tpu_torch.optim import pose_graph as tpg


def _ring(K, step_xi, noise, seed):
    """The drifted-ring problem of the reference's tests: K poses around a
    ring, odometry with noise, measurements from the drifted estimate plus
    one loop edge holding the true relative pose."""
    gt = [np.eye(4, dtype=np.float32)]
    step = np.asarray(jgeo.exp_se3(jnp.asarray(step_xi, jnp.float32)))
    for _ in range(1, K):
        gt.append((step @ gt[-1]).astype(np.float32))
    gt = np.stack(gt)
    rng = np.random.default_rng(seed)
    est = [gt[0]]
    for k in range(1, K):
        rel = gt[k] @ np.linalg.inv(gt[k - 1])
        n = np.asarray(jgeo.exp_se3(jnp.asarray(
            rng.normal(0, noise, 6).astype(np.float32))))
        est.append((n @ rel @ est[-1]).astype(np.float32))
    est = np.stack(est)
    ei = np.asarray(list(range(K - 1)) + [K - 1], np.int32)
    ej = np.asarray(list(range(1, K)) + [0], np.int32)
    meas = np.stack([gt[0] @ np.linalg.inv(gt[K - 1]) if (a, b) == (K - 1, 0)
                     else est[b] @ np.linalg.inv(est[a])
                     for a, b in zip(ei, ej)]).astype(np.float32)
    return gt, est, ei, ej, meas


def _jax_side(est, ei, ej, meas, scales=None):
    v = jpg.vertices_from_se3(jnp.asarray(est))
    m = jpg.Sim3Vertices(
        s=jnp.ones(len(ei), jnp.float32) if scales is None
        else jnp.asarray(scales),
        R=jnp.asarray(meas[:, :3, :3]), t=jnp.asarray(meas[:, :3, 3]))
    return v, jnp.asarray(ei), jnp.asarray(ej), m


def _torch_side(est, ei, ej, meas, scales=None):
    v = tpg.vertices_from_se3(torch.tensor(est))
    m = tpg.Sim3Vertices(
        s=torch.ones(len(ei)) if scales is None else torch.tensor(scales),
        R=torch.tensor(meas[:, :3, :3].copy()),
        t=torch.tensor(meas[:, :3, 3].copy()))
    return v, torch.tensor(ei), torch.tensor(ej), m


def _fixed0(K):
    f = np.zeros(K, bool)
    f[0] = True
    return f


def test_edge_terms_match_jacfwd():
    """Per-edge r, Ji, Jj at xi = 0 against `jax.vmap(jax.jacfwd(...))` on
    the same edges, 1e-4 of the largest entry.  The sequential edges have a
    residual at the identity (log_so3's clip, the series branches), the loop
    edge a large one; measurement scales off 1 exercise the sigma row."""
    K = 16
    _, est, ei, ej, meas = _ring(K, [0.5, 0, 0, 0, 0, np.pi / 8], 0.02, 0)
    scales = np.linspace(0.9, 1.1, len(ei)).astype(np.float32)
    jv, jei, jej, jm = _jax_side(est, ei, ej, meas, scales)
    z = jnp.zeros(7, jnp.float32)

    def per_edge(si_s, si_R, si_t, sj_s, sj_R, sj_t, m_s, m_R, m_t):
        Si, Sj, M = (si_s, si_R, si_t), (sj_s, sj_R, sj_t), (m_s, m_R, m_t)
        r = jpg.edge_residual(z, z, Si, Sj, M)
        Ji = jax.jacfwd(lambda x: jpg.edge_residual(x, z, Si, Sj, M))(z)
        Jj = jax.jacfwd(lambda x: jpg.edge_residual(z, x, Si, Sj, M))(z)
        return r, Ji, Jj

    jr, jJi, jJj = jax.vmap(per_edge)(
        jv.s[jei], jv.R[jei], jv.t[jei], jv.s[jej], jv.R[jej], jv.t[jej],
        jm.s, jm.R, jm.t)
    tr, tJi, tJj = tpg.edge_terms(*_torch_side(est, ei, ej, meas, scales))
    assert tJi.shape == (K, 7, 7) and tJi.dtype == torch.float32
    for t, j in ((tr, jr), (tJi, jJi), (tJj, jJj)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4,
                                   atol=1e-4 * np.abs(j).max())
    # the relative measurement of the vertices themselves: zero residual
    rel = tpg.relative_sim3(tpg.vertices_from_se3(torch.tensor(est)),
                            torch.tensor(ei), torch.tensor(ej))
    jrel = jpg.relative_sim3(jv, jei, jej)
    for k in ("s", "R", "t"):
        np.testing.assert_allclose(getattr(rel, k).numpy(),
                                   np.asarray(getattr(jrel, k)), atol=1e-5)


@pytest.mark.parametrize("solver", ["optimize", "optimize_sparse"])
def test_optimizers_match_jax_on_drifted_ring(solver):
    """Both solvers on the drifted square loop (K = 16, 15 iterations):
    vertices within 1e-3 of the JAX result, and the loop closes."""
    K = 16
    gt, est, ei, ej, meas = _ring(K, [0.5, 0, 0, 0, 0, np.pi / 8], 0.02, 0)
    kw = {} if solver == "optimize" else {"pcg_iters": 80}
    jout = getattr(jpg, solver)(*_jax_side(est, ei, ej, meas), 15,
                                fixed=jnp.asarray(_fixed0(K)), **kw)
    tout = getattr(tpg, solver)(*_torch_side(est, ei, ej, meas), 15,
                                fixed=torch.tensor(_fixed0(K)), **kw)
    for k in ("s", "R", "t"):
        np.testing.assert_allclose(getattr(tout, k).numpy(),
                                   np.asarray(getattr(jout, k)), atol=1e-3)
    P = tpg.vertices_to_se3(tout).numpy()
    np.testing.assert_allclose(P, np.asarray(jpg.vertices_to_se3(jout)),
                               atol=1e-3)
    rel_gt = gt[0] @ np.linalg.inv(gt[K - 1])
    d = P[0] @ np.linalg.inv(P[K - 1]) @ np.linalg.inv(rel_gt)
    d0 = est[0] @ np.linalg.inv(est[K - 1]) @ np.linalg.inv(rel_gt)
    assert np.linalg.norm(d[:3, 3]) < max(0.35 * np.linalg.norm(d0[:3, 3]),
                                          0.08)


def test_sparse_pcg_matches_dense():
    """optimize_sparse reproduces the dense direct solver on the K = 64 ring
    at the reference's own margin (5e-3), with an invalid edge masked out
    and the default gauge (vertex 0)."""
    K = 64
    _, est, ei, ej, meas = _ring(K, [0.25, 0, 0, 0, 0, 2 * np.pi / K],
                                 0.015, 3)
    # a wrong edge that the mask must remove
    ei = np.concatenate([ei, [3]]).astype(np.int32)
    ej = np.concatenate([ej, [40]]).astype(np.int32)
    meas = np.concatenate([meas, np.eye(4, dtype=np.float32)[None]])
    valid = torch.ones(len(ei), dtype=torch.bool)
    valid[-1] = False
    args = _torch_side(est, ei, ej, meas)
    dense = tpg.optimize(*args, 10, edge_valid=valid)
    sparse = tpg.optimize_sparse(*args, 10, edge_valid=valid, pcg_iters=80)
    Pd = tpg.vertices_to_se3(dense).numpy()
    Ps = tpg.vertices_to_se3(sparse).numpy()
    assert np.abs(Pd[:, :3, 3] - Ps[:, :3, 3]).max() < 5e-3
    assert np.abs(Pd[:, :3, :3] - Ps[:, :3, :3]).max() < 5e-3
    np.testing.assert_array_equal(Pd[0], est[0])       # the gauge held
    jd = jpg.optimize(*_jax_side(est, ei, ej, meas), 10,
                      edge_valid=jnp.asarray(valid.numpy()))
    np.testing.assert_allclose(Pd, np.asarray(jpg.vertices_to_se3(jd)),
                               atol=1e-3)

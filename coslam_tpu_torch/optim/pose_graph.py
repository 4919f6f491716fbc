"""Sim3 pose-graph ("essential graph") optimization (port of coslam_tpu/
optim/pose_graph.py, whole).

Replaces g2o-based Optimizer::OptimizeEssentialGraph (ORB_SLAM2/src/
Optimizer.cc:781-1044: VertexSim3Expmap/EdgeSim3 over loop, spanning-tree
and covisibility edges, 20 iterations).  The edge set is a fixed-shape list
with a validity mask; per-edge 7x7 Jacobian blocks come from forward-mode
autodiff (`geo.jacfwd_rows`, batched over the edges) of the residual

    r_e = log_sim3( M_ji^-1 o (exp(xi_j) S_j) o (exp(xi_i) S_i)^-1 )

at xi = 0, where forward mode takes the tangent of the `where` branch that
was selected (the series branch of exp_so3 / exp_sim3, and log_so3's clip at
1 - 1e-7, whose tangent is zero for a residual near identity), exactly as
`jax.jacfwd` does in the reference.

`optimize` assembles the (7K x 7K) Gauss-Newton system by scatter-add and
solves it densely; `optimize_sparse` never materializes it and runs a
block-Jacobi-preconditioned CG over the edge list.  The scatter-adds have
repeated indices by design (`index_add_`): on the GPU their summation order
is not fixed, so two runs agree to float rounding (about 1e-6 relative on
the vertices), not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_tpu_torch.utils import geometry as geo


class Sim3Vertices(NamedTuple):
    s: torch.Tensor  # (K,)
    R: torch.Tensor  # (K, 3, 3)
    t: torch.Tensor  # (K, 3)


def vertices_from_se3(poses, s=None) -> Sim3Vertices:
    K = poses.shape[0]
    return Sim3Vertices(
        s=torch.ones(K, dtype=torch.float32, device=poses.device)
        if s is None else s,
        R=poses[:, :3, :3], t=poses[:, :3, 3])


def vertices_to_se3(v: Sim3Vertices):
    """[R | t/s] like the reference's conversion after graph optimization
    (LoopClosing.cc:471-478, Optimizer.cc:1030-1040).  Rotations projected
    back to SO(3) (see geo.project_so3)."""
    return geo.se3(geo.project_so3(v.R), v.t / v.s[:, None])


def _compose(sa, Ra, ta, sb, Rb, tb):
    """(a o b): x -> a(b(x)) for batched (s, R, t)."""
    s = sa * sb
    R = Ra @ Rb
    t = sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta
    return s, R, t


def _inverse(s, R, t):
    si = 1.0 / s
    Rt = R.transpose(-1, -2)
    ti = -si[..., None] * (Rt @ t[..., None])[..., 0]
    return si, Rt, ti


def _log(s, R, t):
    return geo.log_sim3({"s": s, "R": R, "t": t})


def _exp(xi):
    S = geo.exp_sim3(xi)
    return S["s"], S["R"], S["t"]


def edge_residual(xi_i, xi_j, Si, Sj, Mji):
    """(..., 7), given perturbations (..., 7) of the two endpoint vertices.

    Si, Sj, Mji are (s, R, t) tuples; Mji is the fixed measurement
    S_j S_i^-1 captured at graph-build time.
    """
    es, eR, et = _exp(xi_i)
    si, Ri, ti = _compose(es, eR, et, *Si)
    es, eR, et = _exp(xi_j)
    sj, Rj, tj = _compose(es, eR, et, *Sj)
    rel = _compose(sj, Rj, tj, *_inverse(si, Ri, ti))   # S_j S_i^-1
    err = _compose(*_inverse(*Mji), *rel)
    return _log(*err)


def edge_terms(v: Sim3Vertices, edges_i, edges_j, meas: Sim3Vertices):
    """Residuals (E, 7) and Jacobian blocks Ji, Jj (E, 7, 7) of every edge
    with respect to the perturbations of its two endpoints, at zero."""
    ei, ej = edges_i.long(), edges_j.long()
    Si = (v.s[ei], v.R[ei], v.t[ei])
    Sj = (v.s[ej], v.R[ej], v.t[ej])
    M = (meas.s, meas.R, meas.t)
    # both endpoints' perturbations side by side: one primal evaluation and
    # 14 tangent columns in one batched pass
    z = torch.zeros((ei.shape[0], 14), dtype=torch.float32,
                    device=v.s.device)
    r, J = geo.jacfwd_rows(
        lambda x: edge_residual(x[:, :7], x[:, 7:], Si, Sj, M), z)
    return r, J[..., :7], J[..., 7:]


def _defaults(v, edges_i, edge_valid, fixed):
    K = v.s.shape[0]
    dev = v.s.device
    if edge_valid is None:
        edge_valid = torch.ones(edges_i.shape[0], dtype=torch.bool,
                                device=dev)
    if fixed is None:
        fixed = torch.zeros(K, dtype=torch.bool, device=dev)
        fixed[0] = True
    return edge_valid, fixed


def _apply_update(vv: Sim3Vertices, dx) -> Sim3Vertices:
    es, eR, et = _exp(dx)
    s, R, t = _compose(es, eR, et, vv.s, vv.R, vv.t)
    return Sim3Vertices(s=s, R=geo.project_to_so3(R), t=t)


def optimize(v: Sim3Vertices, edges_i, edges_j, meas: Sim3Vertices,
             iters: int, edge_valid=None, fixed=None,
             lam: float = 1e-6) -> Sim3Vertices:
    """Gauss-Newton over the masked edge list.

    edges_i/edges_j: (E,) int endpoints; meas: (E,)-batched measurement
    Sim3 (S_j S_i^-1 target); fixed: (K,) bool gauge mask.
    """
    K = v.s.shape[0]
    dev = v.s.device
    f32 = torch.float32
    edge_valid, fixed = _defaults(v, edges_i, edge_valid, fixed)
    free = ~fixed
    fm = free.to(f32)
    ei, ej = edges_i.long(), edges_j.long()
    w = edge_valid.to(f32)
    diag_boost = torch.where(free.repeat_interleave(7), lam, 1.0) + lam

    for _ in range(iters):
        r, Ji, Jj = edge_terms(v, ei, ej, meas)
        Jiw = Ji * w[:, None, None]
        Jjw = Jj * w[:, None, None]

        # (K*K, 7, 7) blocks, [a, b] block = rows of vertex a, cols of b
        H = torch.zeros((K * K, 7, 7), dtype=f32, device=dev)
        H.index_add_(0, ei * K + ei, torch.einsum("eai,eaj->eij", Jiw, Ji))
        H.index_add_(0, ej * K + ej, torch.einsum("eai,eaj->eij", Jjw, Jj))
        H.index_add_(0, ei * K + ej, torch.einsum("eai,eaj->eij", Jiw, Jj))
        H.index_add_(0, ej * K + ei, torch.einsum("eai,eaj->eij", Jjw, Ji))
        b = torch.zeros((K, 7), dtype=f32, device=dev)
        b.index_add_(0, ei, torch.einsum("eai,ea->ei", Jiw, r))
        b.index_add_(0, ej, torch.einsum("eai,ea->ei", Jjw, r))

        # gauge: zero rows/cols of fixed vertices, identity diagonal
        H = H.reshape(K, K, 7, 7) * fm[:, None, None, None] \
            * fm[None, :, None, None]
        b = b * fm[:, None]
        Hf = H.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
        Hf = Hf + torch.diag(diag_boost)
        dx = -torch.linalg.solve(Hf, b.reshape(-1)).reshape(K, 7)
        dx = dx * fm[:, None]
        v = _apply_update(v, dx)
    return v


def relative_sim3(v: Sim3Vertices, i, j) -> Sim3Vertices:
    """Measurement S_j S_i^-1 from current vertex estimates (batched)."""
    i, j = i.long(), j.long()
    Si = (v.s[i], v.R[i], v.t[i])
    Sj = (v.s[j], v.R[j], v.t[j])
    s, R, t = _compose(*Sj, *_inverse(*Si))
    return Sim3Vertices(s=s, R=R, t=t)


def optimize_sparse(v: Sim3Vertices, edges_i, edges_j, meas: Sim3Vertices,
                    iters: int, edge_valid=None, fixed=None,
                    lam: float = 1e-6, pcg_iters: int = 64) -> Sim3Vertices:
    """Gauss-Newton over a SPARSE edge list with a matrix-free
    block-Jacobi-preconditioned CG solve.

    The dense `optimize` materializes the (7K, 7K) Hessian and solves it
    directly — O(K^2) memory and O(K^3) work (the reference's essential
    graph is sparse, Optimizer.cc:869-980: spanning tree + covisibility +
    loop edges, E = O(K)).  Here the normal equations are never
    materialized: the Hv product gathers the two endpoint updates per edge,
    applies the per-edge (14, 14) block J^T W J, and scatter-adds — O(E) per
    CG step, the same matrix-free machinery as optim/ba.py's reduced-camera
    solve.  (The reference applies J and then J^T, and solves the
    preconditioner's blocks by their Cholesky factors instead of inverting
    them: the same products up to float rounding, in a third more kernel
    launches.)"""
    K = v.s.shape[0]
    dev = v.s.device
    f32 = torch.float32
    edge_valid, fixed = _defaults(v, edges_i, edge_valid, fixed)
    free = ~fixed
    fm = free.to(f32)
    ei, ej = edges_i.long(), edges_j.long()
    w = edge_valid.to(f32)
    eye7 = torch.eye(7, dtype=f32, device=dev)
    E = ei.shape[0]
    ends = torch.cat([ei, ej])                # (2E,) both endpoints' vertices

    def scatter(per_end):
        """(E, 2, ...) per-edge, per-endpoint terms summed per vertex."""
        flat = per_end.transpose(0, 1).reshape((2 * E,) + per_end.shape[2:])
        out = torch.zeros((K,) + per_end.shape[2:], dtype=f32, device=dev)
        return out.index_add_(0, ends, flat)

    def dot(a, b):
        return torch.dot(a.reshape(-1), b.reshape(-1))

    for _ in range(iters):
        r, Ji, Jj = edge_terms(v, ei, ej, meas)
        J = torch.cat([Ji, Jj], -1)                          # (E, 7, 14)
        Jw = J * w[:, None, None]
        # per-edge blocks of the normal equations, [[ii, ij], [ji, jj]]:
        # the Hv product applies them to the endpoints' updates side by side
        A = torch.einsum("eai,eaj->eij", Jw, J)              # (E, 14, 14)

        # gradient b = J^T r  (per free vertex)
        b = scatter(torch.einsum("eai,ea->ei", Jw, r).reshape(E, 2, 7))
        b = b * fm[:, None]

        # block-diagonal of H, inverted through its Cholesky factor (the
        # Jacobi preconditioner)
        D = scatter(torch.stack([A[:, :7, :7], A[:, 7:, 7:]], 1))
        D = D + (lam + 1e-6) * eye7
        D = torch.where(free[:, None, None], D, eye7.expand(K, 7, 7))
        D_inv = torch.cholesky_inverse(torch.linalg.cholesky_ex(D)[0])

        def Hv(x):
            xm = x * fm[:, None]
            xe = xm[ends].reshape(2, E, 7).transpose(0, 1).reshape(E, 14)
            y = scatter((A @ xe[..., None]).reshape(E, 2, 7))
            y = y * fm[:, None] + lam * xm
            # fixed vertices: identity rows keep them pinned at zero update
            return y + x * (1.0 - fm)[:, None]

        def precond(x):
            return (D_inv @ x[..., None])[..., 0]

        # PCG on H dx = -b
        x = torch.zeros((K, 7), dtype=f32, device=dev)
        rr = -b - Hv(x)
        zz = precond(rr)
        p = zz
        for _ in range(pcg_iters):
            Hp = Hv(p)
            rz = dot(rr, zz)
            alpha = rz / torch.clamp(dot(p, Hp), min=1e-20)
            x = x + alpha * p
            rr = rr - alpha * Hp
            zz = precond(rr)
            beta = dot(rr, zz) / torch.clamp(rz, min=1e-20)
            p = zz + beta * p
        v = _apply_update(v, x * fm[:, None])
    return v

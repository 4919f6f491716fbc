"""Two-view monocular initialization: batched H/F RANSAC + motion recovery
(port of coslam_tpu/ops/twoview.py, whole).

All RANSAC hypotheses of both models are scored as two batched
computations and the winners selected by argmax (first index on ties);
model selection keeps RH = SH/(SH+SF) > 0.40, the scoring mirrors
Initializer::CheckHomography / CheckFundamental, motion recovery
ReconstructF's 4-candidate and ReconstructH's 8-motion cheirality vote.

The reference draws its (iters, 8) sample indices with
`jax.random.choice(key, N, p=valid/sum)` inside `initialize`; torch cannot
reproduce that stream, so here `initialize` takes the draws as an argument
and `draw_samples` makes them from a `torch.Generator`.  Null vectors come
from `eigh` of A^T A and F's rank-2 projection from an SVD; their
signs may differ from JAX's, which changes nothing downstream (H and F are
used up to sign, the motion candidates form the same set).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from coslam_tpu_torch.config import CameraConfig
from coslam_tpu_torch.utils import geometry as geo

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # both scores accumulate against 5.991 (Initializer.cc:305,390)


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # () bool
    used_homography: torch.Tensor  # () bool
    T21: torch.Tensor              # (4, 4) pose of view 2 w.r.t. view 1 (unit t)
    points3d: torch.Tensor         # (N, 3) triangulated in view-1 frame
    is_inlier: torch.Tensor        # (N,) bool triangulated + cheirality-clean
    n_good: torch.Tensor           # () int


def _k_matrix(cam: CameraConfig, device) -> torch.Tensor:
    return torch.tensor(cam.K, dtype=torch.float32, device=device)


def draw_samples(valid: torch.Tensor, iters: int,
                 generator: torch.Generator, size: int = 8) -> torch.Tensor:
    """(iters, size) sample indices drawn with replacement, uniformly over
    the valid matches (the reference's p = valid / sum); over all of them
    where none is valid (no hypothesis can win then)."""
    p = valid.to(torch.float32)
    p = torch.where(p.sum() > 0, p, torch.ones_like(p))
    p = p / (p.sum() + 1e-9)
    return torch.multinomial(p, iters * size, replacement=True,
                             generator=generator).reshape(iters, size)


def _normalize(uv, valid):
    """Hartley normalization over valid matches (Initializer.cc:707)."""
    w = valid.to(torch.float32)
    n = w.sum() + 1e-6
    mean = (uv * w[:, None]).sum(0) / n
    dev = (uv - mean).abs() * w[:, None]
    md = dev.sum(0) / n + 1e-8
    s = 1.0 / md
    uvn = (uv - mean) * s
    z = torch.zeros((), dtype=torch.float32, device=uv.device)
    o = torch.ones((), dtype=torch.float32, device=uv.device)
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return uvn, T


def _smallest_eigvec(A):
    """Unit null-ish vector of (..., m, 9): eigenvector of A^T A with the
    smallest eigenvalue."""
    AtA = torch.einsum("...mi,...mj->...ij", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, 0]


def _h_from_8(uv1n, uv2n):
    """(..., 8, 2) x2 -> H (..., 3, 3) by DLT (Initializer.cc ComputeH21)."""
    x1, y1 = uv1n[..., 0], uv1n[..., 1]
    x2, y2 = uv2n[..., 0], uv2n[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    A = torch.cat([r1, r2], -2)  # (..., 16, 9)
    return _smallest_eigvec(A).reshape(A.shape[:-2] + (3, 3))


def _f_from_8(uv1n, uv2n):
    """(..., 8, 2) x2 -> rank-2 F (..., 3, 3) (Initializer.cc ComputeF21)."""
    x1, y1 = uv1n[..., 0], uv1n[..., 1]
    x2, y2 = uv2n[..., 0], uv2n[..., 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o],
                    -1)
    F = _smallest_eigvec(A).reshape(A.shape[:-2] + (3, 3))
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    return (u * s[..., None, :]) @ vt


def _score_h(H, uv1, uv2, valid, sigma2):
    """Symmetric transfer score of (..., 3, 3) homographies."""
    Hinv = torch.linalg.inv(H)

    def transfer(M, a, b):
        ah = torch.cat([a, torch.ones_like(a[:, :1])], 1)
        p = ah @ M.transpose(-1, -2)
        proj = p[..., :2] / (p[..., 2:3] + 1e-12)
        return ((proj - b) ** 2).sum(-1) / sigma2

    c1 = transfer(Hinv, uv2, uv1)
    c2 = transfer(H, uv1, uv2)
    in1 = c1 < CHI2_H
    in2 = c2 < CHI2_H
    score = torch.where(valid & in1, SCORE_TH - c1, 0.0).sum(-1) \
        + torch.where(valid & in2, SCORE_TH - c2, 0.0).sum(-1)
    return score, valid & in1 & in2


def _score_f(F, uv1, uv2, valid, sigma2):
    """Symmetric epipolar score of (..., 3, 3) fundamental matrices."""
    ones = torch.ones_like(uv1[:, :1])
    p1 = torch.cat([uv1, ones], 1)
    p2 = torch.cat([uv2, ones], 1)
    l2 = p1 @ F.transpose(-1, -2)       # epipolar line in image 2
    l1 = p2 @ F                         # in image 1
    d2 = ((l2 * p2).sum(-1) ** 2) \
        / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12) / sigma2
    d1 = ((l1 * p1).sum(-1) ** 2) \
        / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12) / sigma2
    in1 = d1 < CHI2_F
    in2 = d2 < CHI2_F
    score = torch.where(valid & in1, SCORE_TH - d1, 0.0).sum(-1) \
        + torch.where(valid & in2, SCORE_TH - d2, 0.0).sum(-1)
    return score, valid & in1 & in2


def _triangulate_many(K, R, t, uv1, uv2):
    """Triangulate all matches for candidate (R, t) via eigh of the 4x4
    DLT normal matrix (Initializer.cc:734 Triangulate, batched)."""
    P1 = torch.cat([K, torch.zeros((3, 1), dtype=K.dtype, device=K.device)],
                   1)
    P2 = K @ torch.cat([R, t[:, None]], 1)

    def rows(P, uv):
        return torch.stack([uv[:, 0, None] * P[2] - P[0],
                            uv[:, 1, None] * P[2] - P[1]], 1)  # (N, 2, 4)

    A = torch.cat([rows(P1, uv1), rows(P2, uv2)], 1)  # (N, 4, 4)
    AtA = torch.einsum("nmi,nmj->nij", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    X = vecs[:, :, 0]
    w = X[:, 3:4]
    return X[:, :3] / (w + torch.where(w.abs() < 1e-12, 1e-12, 0.0))


def _check_rt(K, R, t, uv1, uv2, valid, sigma2):
    """Count good points for candidate motion (Initializer.cc CheckRT:798):
    finite, in front of both cameras, parallax > ~1deg (cos < 0.99998),
    reprojection error < 4 sigma^2 in both views."""
    X = _triangulate_many(K, R, t, uv1, uv2)
    finite = torch.isfinite(X).all(1)
    z1 = X[:, 2]
    Xc2 = X @ R.T + t
    z2 = Xc2[:, 2]
    C2 = -R.T @ t
    r1 = X
    r2 = X - C2
    cos_par = (r1 * r2).sum(1) / (
        torch.linalg.vector_norm(r1, dim=1)
        * torch.linalg.vector_norm(r2, dim=1) + 1e-12)

    def reproj(P3, uv):
        p = P3 @ K.T
        pr = p[:, :2] / (p[:, 2:3] + 1e-12)
        return ((pr - uv) ** 2).sum(1)

    e1 = reproj(X, uv1)
    e2 = reproj(Xc2, uv2)
    good = (valid & finite & (z1 > 0) & (z2 > 0) & (cos_par < 0.99998)
            & (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2))
    # representative parallax: 50th-best cos (reference takes the 50th)
    cos_sorted = torch.sort(torch.where(good, cos_par, 1.0)).values
    n_good = good.sum()
    idx = torch.clamp(torch.clamp(n_good - 1, max=50), min=0)
    par_cos = cos_sorted.index_select(0, idx.reshape(1))[0]
    return n_good, good, X, par_cos


def _motions_from_f(K, F):
    """4 candidate (R, t) from E = K^T F K (Initializer.cc DecomposeE:909)."""
    E = K.T @ F @ K
    u, _, vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]],
                     dtype=torch.float32, device=K.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = u[:, 2]
    t = t / (torch.linalg.vector_norm(t) + 1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motions_from_h(K, H):
    """8 candidate (R, t) via Faugeras SVD decomposition
    (Initializer.cc ReconstructH:572)."""
    dev = K.device
    A = torch.linalg.inv(K) @ H @ K
    u, d, vt = torch.linalg.svd(A)
    s = torch.linalg.det(u) * torch.linalg.det(vt)
    d1, d2, d3 = d[0], d[1], d[2]
    pm = torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev)
    mp = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev)
    zeros4 = torch.zeros(4, device=dev)
    ones4 = torch.ones(4, device=dev)

    aux1 = torch.sqrt(torch.clamp(
        (d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3 + 1e-12), min=0.0))
    aux3 = torch.sqrt(torch.clamp(
        (d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3 + 1e-12), min=0.0))
    x1s = pm * aux1
    x3s = mp * aux3

    # case d' > 0
    aux_st = torch.sqrt(torch.clamp(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0)) \
        / ((d1 + d3) * d2 + 1e-12)
    st = mp * aux_st
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2 + 1e-12)
    ct4 = ct * ones4
    Rp_pos = torch.stack([torch.stack([ct4, zeros4, -st], -1),
                          torch.stack([zeros4, ones4, zeros4], -1),
                          torch.stack([st, zeros4, ct4], -1)], -2)
    tp_pos = torch.stack([x1s, zeros4, -x3s], 1) * (d1 - d3)

    # case d' < 0
    aux_sp = torch.sqrt(torch.clamp(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0)) \
        / ((d1 - d3) * d2 + 1e-12)
    sp = mp * aux_sp
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2 + 1e-12)
    cp4 = cp * ones4
    Rp_neg = torch.stack([torch.stack([cp4, zeros4, sp], -1),
                          torch.stack([zeros4, -ones4, zeros4], -1),
                          torch.stack([sp, zeros4, cp4], -1)], -2)
    tp_neg = torch.stack([x1s, zeros4, x3s], 1) * (d1 + d3)

    Rp = torch.cat([Rp_pos, Rp_neg])     # (8, 3, 3)
    tp = torch.cat([tp_pos, tp_neg])     # (8, 3)
    R = s * torch.einsum("ij,njk,kl->nil", u, Rp, vt)
    t = torch.einsum("ij,nj->ni", u, tp)
    t = t / (torch.linalg.vector_norm(t, dim=1, keepdim=True) + 1e-12)
    return R, t


def initialize(cam: CameraConfig, uv1, uv2, valid, samples,
               sigma: float = 1.0, min_good: int = 50) -> TwoViewResult:
    """Full two-view bootstrap from matched (undistorted) pixel coords.

    uv1, uv2: (N, 2) float32; valid: (N,) bool; samples: (iters, 8) indices
    into the N matches (`draw_samples`).  Mirrors Initializer::Initialize
    (Initializer.cc:44-123) with batched hypotheses."""
    sigma2 = sigma * sigma
    K = _k_matrix(cam, uv1.device)

    uv1n, T1 = _normalize(uv1, valid)
    uv2n, T2 = _normalize(uv2, valid)
    idx = samples.long()
    a, b = uv1n[idx], uv2n[idx]                         # (iters, 8, 2)
    Hs = torch.linalg.inv(T2) @ _h_from_8(a, b) @ T1
    Fs = T2.T @ _f_from_8(a, b) @ T1
    sh, _ = _score_h(Hs, uv1, uv2, valid, sigma2)
    sf, _ = _score_f(Fs, uv1, uv2, valid, sigma2)
    bh, bf = torch.argmax(sh), torch.argmax(sf)
    H = Hs.index_select(0, bh.reshape(1))[0]
    F = Fs.index_select(0, bf.reshape(1))[0]
    SH = sh.index_select(0, bh.reshape(1))[0]
    SF = sf.index_select(0, bf.reshape(1))[0]
    use_h = SH / (SH + SF + 1e-12) > 0.40
    _, inl_h = _score_h(H, uv1, uv2, valid, sigma2)
    _, inl_f = _score_f(F, uv1, uv2, valid, sigma2)
    inliers = torch.where(use_h, inl_h, inl_f)

    Rf, tf = _motions_from_f(K, F)          # (4, ...)
    Rh, th = _motions_from_h(K, H)          # (8, ...)
    Rall = torch.cat([Rf, Rh])              # (12, 3, 3)
    tall = torch.cat([tf, th])
    hyp_mask = torch.cat([(~use_h).expand(4), use_h.expand(8)])

    checks = [_check_rt(K, Rall[i], tall[i], uv1, uv2, inliers, sigma2)
              for i in range(12)]
    counts = torch.stack([c[0] for c in checks])
    goods = torch.stack([c[1] for c in checks])
    Xs = torch.stack([c[2] for c in checks])
    par_cos = torch.stack([c[3] for c in checks])
    counts = torch.where(hyp_mask, counts, -1)
    best = torch.argmax(counts).reshape(1)
    n_good = counts.index_select(0, best)[0]
    n_inl = inliers.sum()
    # reference acceptance: clear winner (no similar second), >= 90 % of the
    # required minimum, parallax above ~1 deg (Initializer.cc:470-570)
    second = torch.sort(counts).values[-2]
    min_g = torch.clamp(0.9 * n_inl.to(torch.float32), min=float(min_good))
    ok = ((n_good.to(torch.float32) > min_g)
          & (second.to(torch.float32) < 0.75 * n_good.to(torch.float32))
          & (par_cos.index_select(0, best)[0] < 0.9998))

    T21 = geo.se3(Rall.index_select(0, best)[0], tall.index_select(0, best)[0])
    return TwoViewResult(success=ok, used_homography=use_h, T21=T21,
                         points3d=Xs.index_select(0, best)[0],
                         is_inlier=goods.index_select(0, best)[0],
                         n_good=n_good)

"""SE3 / SO3 / Sim3 Lie-group operations on tensors (port of coslam_tpu/
utils/geometry.py: what the tracker, the mapper and loop closing use).

All functions broadcast over leading batch dimensions; poses are 4x4
float32 world-to-camera matrices (Tcw), Sim3 elements are dicts
{"s", "R", "t"} with the action x -> s R x + t.  Conventions:
x_cam = R @ x_world + t;  Tcw = [[R, t], [0, 1]].

Every `where` branch, threshold and `_EPS` is the reference's: the pose
graph and the Sim3 polish differentiate through them at zero, where forward
mode takes the tangent of the branch that was selected.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so3 hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation (..., 3, 3)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    W = hat(w)
    return _eye3_like(W) + a[..., None, None] * W \
        + b[..., None, None] * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    # theta/(2 sin theta) with series fallback near 0
    sin_t = torch.sin(theta)
    scale = torch.where(theta < 1e-4, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * sin_t + _EPS))
    return vee(R - R.transpose(-1, -2)) * scale[..., None]


def project_to_so3(R: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix via SVD (renormalizes the pose graph's
    vertices after each update)."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return (u * d[..., None, :]) @ vt


def se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)        # a fill, no host tensor copied over
    return T


def se3_identity(dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def rot(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def trans(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rot(T).transpose(-1, -2)
    t = -(Rt @ trans(T)[..., None])[..., 0]
    return se3(Rt, t)


def project_so3(R: torch.Tensor) -> torch.Tensor:
    """Nearest-rotation projection by Gram-Schmidt on (..., 3, 3) ROWS.

    Optimizer boundaries project their output through this: chained f32
    pose compositions drift off SO(3), and since `se3_inverse` uses R^T the
    drift would compound through every velocity-model prediction."""
    r0 = R[..., 0, :]
    r0 = r0 / (torch.linalg.vector_norm(r0, dim=-1, keepdim=True) + 1e-12)
    r1 = R[..., 1, :]
    r1 = r1 - (r1 * r0).sum(-1, keepdim=True) * r0
    r1 = r1 / (torch.linalg.vector_norm(r1, dim=-1, keepdim=True) + 1e-12)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def project_se3(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block of (..., 4, 4) poses."""
    return se3(project_so3(rot(T)), trans(T))


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se3 exp: (..., 6) twist [rho(3), phi(3)] -> (..., 4, 4), with the
    left-Jacobian V so that translation integrates along rotation."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    W = hat(phi)
    I = _eye3_like(W)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - a) / (theta2 + _EPS))
    WW = W @ W
    R = I + a[..., None, None] * W + b[..., None, None] * WW
    V = I + b[..., None, None] * W + c[..., None, None] * WW
    t = (V @ rho[..., None])[..., 0]
    return se3(R, t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """se3 log: (..., 4, 4) -> (..., 6) twist [rho(3), phi(3)]."""
    phi = log_so3(rot(T))
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    W = hat(phi)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - theta sin/(2(1-cos))) W^2
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - (theta * torch.sin(theta))
         / (2.0 * (1.0 - torch.cos(theta)) + _EPS)) / (theta2 + _EPS))
    Vinv = _eye3_like(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)
    rho = (Vinv @ trans(T)[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    return pts @ rot(T).transpose(-1, -2) + trans(T)[..., None, :]


def apply_se3(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to a single point (..., 3)."""
    return (rot(T) @ p[..., None])[..., 0] + trans(T)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) as (w, x, y, z), any norm and either sign ->
    rotation (..., 3, 3)."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _norm4(q: torch.Tensor) -> torch.Tensor:
    """|q| over the last axis, (..., 1).  In float32 the squares are summed
    in order, each product added in float64 (where a product of two
    float32 is exact) and the sum rounded to float32 at every step: a
    model of the fused multiply-add chain that XLA's CPU backend was found
    to use, fitted by measurement, not derived from XLA.  It holds where
    it was measured: on the synthetic trajectories' rotations it gives the
    reference's quaternions bit for bit (a plain float32 sum does not).
    On random rotations it still differs in the last bits for ~0.7% (1-2
    ulp, cause untraced), against ~12% for a plain float32 sum."""
    if q.dtype != torch.float32:
        return torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    d = q.to(torch.float64)
    acc = (d[..., 0] * d[..., 0]).to(torch.float32)
    for i in range(1, q.shape[-1]):
        acc = (d[..., i] * d[..., i] + acc.to(torch.float64)) \
            .to(torch.float32)
    return torch.sqrt(acc)[..., None]


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> unit quaternion (..., 4) as (w, x, y, z):
    Shepperd's method, branchless (the reference's `rot_to_quat`)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def norm4(w, x, y, z):
        q = torch.stack([w, x, y, z], dim=-1)
        return q / (_norm4(q) + _EPS)

    # four candidate decompositions; pick the numerically best
    s0 = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) * 2
    q0 = norm4(0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
               (m10 - m01) / s0)
    s1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) * 2
    q1 = norm4((m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
               (m02 + m20) / s1)
    s2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS)) * 2
    q2 = norm4((m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
               (m12 + m21) / s2)
    s3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS)) * 2
    q3 = norm4((m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
               0.25 * s3)
    c0 = (tr > 0)[..., None]
    c1 = ((m00 > m11) & (m00 > m22))[..., None]
    c2 = (m11 > m22)[..., None]
    return torch.where(c0, q0, torch.where(c1, q1, torch.where(c2, q2, q3)))


# ---------------------------------------------------------------------------
# Sim3 — {"s": scalar, "R": 3x3, "t": 3} with action x -> s R x + t
# (reference: g2o::Sim3 used by LoopClosing.cc:231-601, Optimizer.cc:781-1244)
# ---------------------------------------------------------------------------

def sim3(s, R: torch.Tensor, t: torch.Tensor) -> dict:
    return {"s": torch.as_tensor(s, dtype=torch.float32, device=R.device),
            "R": R, "t": t}


def sim3_identity(device) -> dict:
    return sim3(1.0, torch.eye(3, dtype=torch.float32, device=device),
                torch.zeros(3, dtype=torch.float32, device=device))


def sim3_apply(S: dict, pts: torch.Tensor) -> torch.Tensor:
    return S["s"][..., None, None] * (pts @ S["R"].transpose(-1, -2)) \
        + S["t"][..., None, :]


def sim3_compose(A: dict, B: dict) -> dict:
    """A after B: x -> A(B(x))."""
    s = A["s"] * B["s"]
    R = A["R"] @ B["R"]
    t = A["s"][..., None] * (A["R"] @ B["t"][..., None])[..., 0] + A["t"]
    return sim3(s, R, t)


def sim3_inverse(S: dict) -> dict:
    s_inv = 1.0 / S["s"]
    Rt = S["R"].transpose(-1, -2)
    t = -s_inv[..., None] * (Rt @ S["t"][..., None])[..., 0]
    return sim3(s_inv, Rt, t)


def sim3_from_se3(T: torch.Tensor, s=1.0) -> dict:
    return sim3(s, rot(T), trans(T))


def sim3_to_se3(S: dict) -> torch.Tensor:
    """Drop scale into translation-normalized SE3: [R | t/s] (reference
    LoopClosing.cc:471-478 rescales points then uses [R | t/s])."""
    return se3(S["R"], S["t"] / S["s"][..., None])


def _sim3_wmat(phi, sigma, s):
    """Wmat = A*I + B*W + C*W^2 with t = Wmat @ rho (Strasdat's closed
    form); series where sigma or theta is small, B = C = 0 at theta = 0."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(phi)
    I = _eye3_like(W)
    sig_small = sigma.abs() < 1e-5
    th_small = theta2 < 1e-8
    A = torch.where(sig_small, 1.0 + sigma / 2.0, (s - 1.0) / (sigma + _EPS))
    es_cos = s * torch.cos(theta)
    es_sin = s * torch.sin(theta)
    denom = sigma * sigma + theta2 + _EPS
    B = torch.where(
        th_small, torch.zeros_like(theta),
        (es_sin * sigma + (1.0 - es_cos) * theta) / (denom * theta + _EPS))
    C = torch.where(
        th_small, torch.zeros_like(theta),
        (A - ((es_cos - 1.0) * sigma + es_sin * theta) / (denom + _EPS))
        / (theta2 + _EPS))
    return A[..., None, None] * I + B[..., None, None] * W \
        + C[..., None, None] * (W @ W)


def exp_sim3(xi: torch.Tensor) -> dict:
    """sim3 exp of (..., 7) = [rho(3), phi(3), sigma(1)]: first-order-
    consistent closed form (W matrix per Strasdat's thesis)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = exp_so3(phi)
    t = (_sim3_wmat(phi, sigma, s) @ rho[..., None])[..., 0]
    return {"s": s, "R": R, "t": t}


def log_sim3(S: dict) -> torch.Tensor:
    """Inverse of exp_sim3: (..., 7); the W matrix is inverted by a 3x3
    solve."""
    phi = log_so3(S["R"])
    sigma = torch.log(S["s"])
    Wmat = _sim3_wmat(phi, sigma, S["s"])
    rho = torch.linalg.solve(Wmat, S["t"][..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def jacfwd_rows(f, x: torch.Tensor):
    """Value and forward-mode Jacobian of a row-wise function: f maps
    x (B, D) to (..., M) where output row b (or, for B = 1, every output)
    depends on x[b] alone.  Returns (f(x), J of shape f(x).shape + (D,)):
    one `torch.func.jvp` per basis vector, the tangent e_d given to every
    row at once, batched by `torch.func.vmap` — `jax.jacfwd`'s semantics
    (the tangent of the `where` branch that was selected).  The rows keep
    their batch dimension on purpose: a 0-d dual tensor combined with a
    Python number is promoted to float64 by torch.func (2.13), which a
    per-row vmap would run into."""
    D = x.shape[-1]
    eye = torch.eye(D, dtype=x.dtype, device=x.device)

    def column(e):
        return torch.func.jvp(f, (x,), (e.expand_as(x).contiguous(),))

    out, tangents = torch.func.vmap(column)(eye)
    return out[0], torch.movedim(tangents, 0, -1)


# ---------------------------------------------------------------------------
# Triangulation (reference Initializer.cc:734 Triangulate — DLT / SVD) and
# quaternion interpolation
# ---------------------------------------------------------------------------

def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """Linear triangulation: P1, P2 (..., 3, 4) projection matrices, x1, x2
    (..., 2) image points -> (..., 3) world points, from the smallest right
    singular vector of the 4x4 DLT system (Initializer.cc:734-758)."""
    rows = torch.stack([
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)
    X = torch.linalg.svd(rows).Vh[..., 3, :]
    w = X[..., 3:4]
    return X[..., :3] / (w + torch.where(torch.abs(w) < _EPS,
                                         torch.full_like(w, _EPS),
                                         torch.zeros_like(w)))


def slerp(q0: torch.Tensor, q1: torch.Tensor, u) -> torch.Tensor:
    """Spherical linear interpolation of quaternions (w, x, y, z)."""
    u = torch.as_tensor(u, dtype=q0.dtype, device=q0.device)
    d = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0 - 1e-7))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-5
    w0 = torch.where(small, 1.0 - u,
                     torch.sin((1.0 - u) * theta) / (sin_theta + _EPS))
    w1 = torch.where(small, u,
                     torch.sin(u * theta) / (sin_theta + _EPS))
    q = w0 * q0 + w1 * q1
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)

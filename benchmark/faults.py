"""Faults planted underneath the timed path, for the checks' tests on the
CPU (benchmark/tests/test_bench_faults.py) and the fault readings on the
card (`benchmark/control.py --fault <name>`).  Each takes the run's
`capture.Patches` and replaces one attribute of the program; the run
restores it when the window closes."""

import math


def _turned(R, angle: float):
    import torch

    c, s = math.cos(angle), math.sin(angle)
    Rz = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                      dtype=R.dtype, device=R.device)
    return Rz @ R


def pose_unchanged(p):
    """K3 returns the pose it started from."""
    from coslam_tpu_torch.ops import cuda_kernels as ck

    def make(inner):
        def call(T_init, X, uv, isg, **kw):
            _T, inl = inner(T_init, X, uv, isg, **kw)
            return T_init.clone(), inl
        return call
    p.replace(ck, "pose_opt_lm", make)


def half_batch(p):
    """K2 leaves out the second half of its queries."""
    from coslam_tpu_torch.ops import cuda_kernels as ck

    def make(inner):
        def call(desc_q, uv_q, r2_q, valid_q, *a, **kw):
            half = valid_q.clone()
            half[half.shape[0] // 2:] = False
            return inner(desc_q, uv_q, r2_q, half, *a, **kw)
        return call
    p.replace(ck, "masked_match", make)


def pose_altered(p):
    """K3's pose turned by 0.02 rad where it is produced."""
    from coslam_tpu_torch.ops import cuda_kernels as ck

    def make(inner):
        def call(*a, **kw):
            T, inl = inner(*a, **kw)
            T = T.clone()
            T[:3, :3] = _turned(T[:3, :3], 0.02)
            return T, inl
        return call
    p.replace(ck, "pose_opt_lm", make)


def ba_unchanged(p):
    """The windowed local BA returns the poses and points it started
    from."""
    from coslam_tpu_torch.optim import ba

    def make(inner):
        def call(cam, prob, *a, **kw):
            res = inner(cam, prob, *a, **kw)
            return res._replace(poses=prob.poses.clone(),
                                points=prob.points.clone())
        return call
    p.replace(ba, "solve_dense", make)


def sim3_altered(p):
    """Every Sim3 polish's rotation turned by 0.02 rad where it is
    produced."""
    from coslam_tpu_torch.ops import sim3

    def make(inner):
        def call(*a, **kw):
            s, R, t, ok = inner(*a, **kw)
            return s, _turned(R, 0.02), t, ok
        return call
    p.replace(sim3, "refine_sim3", make)


FAULTS = {f.__name__: f for f in (pose_unchanged, half_batch, pose_altered,
                                  ba_unchanged, sim3_altered)}

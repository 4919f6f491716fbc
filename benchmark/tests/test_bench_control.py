"""The control of the correctness check at a size a test run holds: the
plain reference one precision below the configuration's float32
(bfloat16) put in the program's place must fail each number that has a
limit between readings, while the float32 reference passes it.  On the
card, benchmark/control.py reads the same at the cells' own size."""

import math

import pytest
import torch

from benchmark.tests.bench_common import ALL_CELLS, full_cell, small_cell
from benchmark.harness import render
from benchmark.reference import ba, orb, pose, sim3

CELLS = [w["name"] for w in ALL_CELLS["workloads"]]


def _frame(cell):
    cam = cell.config["system"]["camera"]
    lens = render.Lens.of(cam)
    scene = render.make_cylinder_scene(700, seed=2**31 + 11)
    T = render.make_loop_trajectory(4, seed=3)[1]
    return torch.as_tensor(render.render_frame(lens, T, scene, distort=True))


@pytest.mark.parametrize("workload", CELLS)
def test_frame_control_fails_where_the_reference_passes(workload):
    cell = small_cell(workload)
    limit = full_cell(workload).limits["frame_mismatch_pct"]
    ex = cell.config["system"]["extractor"]
    img = _frame(cell)
    ref = orb.extract(img, ex)
    same, n = orb.mismatch(orb.extract(img, ex), ref)
    low, _ = orb.mismatch(orb.extract(img, ex, dtype=torch.bfloat16), ref)
    assert n > 300 and 100.0 * same / n <= limit
    assert 100.0 * low / n > limit


def _pose_problem(seed):
    g = torch.Generator().manual_seed(seed)
    n = 400
    X = torch.randn(n, 3, generator=g) * torch.tensor([2.0, 1.5, 1.0]) \
        + torch.tensor([0.0, 0.0, 6.0])
    fx = fy = 517.3
    cx, cy = 318.6, 255.3
    uv = torch.stack([fx * X[:, 0] / X[:, 2] + cx,
                      fy * X[:, 1] / X[:, 2] + cy], 1)
    uv = uv + 0.5 * torch.randn(n, 2, generator=g)
    uv[:40] += 30.0 * torch.randn(40, 2, generator=g)         # outliers
    isg = torch.ones(n)
    T = torch.eye(4)
    a = 0.03
    T[:3, :3] = torch.tensor([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                              [-math.sin(a), 0, math.cos(a)]])
    T[:3, 3] = torch.tensor([0.05, -0.02, 0.1])
    kw = dict(fx=fx, fy=fy, cx=cx, cy=cy, rounds=4, iters=10, chi2_th=5.991)
    return T, X, uv, isg, kw


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pose_control_fails_where_float32_passes(workload, seed):
    limit = full_cell(workload).limits["k3_gap_px"]
    T, X, uv, isg, kw = _pose_problem(seed)
    T32, _ = pose.optimize(T, X, uv, isg, dtype=torch.float32, **kw)
    call = {"args": (T, X, uv, isg), "kw": kw, "out": (T32, None)}
    assert pose.gap_px(call) <= limit
    T16, _ = pose.optimize(T, X, uv, isg, dtype=torch.bfloat16, **kw)
    assert pose.gap_px(call, against=T16) > limit


class _Cam:
    fx = fy = 517.3
    cx, cy = 318.6, 255.3


def _project(X):
    return torch.stack([_Cam.fx * X[:, 0] / X[:, 2] + _Cam.cx,
                        _Cam.fy * X[:, 1] / X[:, 2] + _Cam.cy], 1)


def _rot_y(a):
    return torch.tensor([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                         [-math.sin(a), 0.0, math.cos(a)]])


def _ba_problem(seed):
    """Four keyframes on an arc around 60 landmarks, 0.5 px of noise, the
    first keyframe fixed, the start a little off."""
    import collections

    g = torch.Generator().manual_seed(seed)
    K, P = 4, 60
    X = torch.randn(P, 3, generator=g) * torch.tensor([2.0, 1.5, 1.0]) \
        + torch.tensor([0.0, 0.0, 6.0])
    poses = torch.eye(4).repeat(K, 1, 1)
    for k in range(K):
        poses[k, :3, :3] = _rot_y(0.04 * k)
        poses[k, :3, 3] = torch.tensor([-0.3 * k, 0.0, 0.05 * k])
    kf = torch.arange(K).repeat_interleave(P)
    pt = torch.arange(P).repeat(K)
    Xc = torch.einsum("oij,oj->oi", poses[kf, :3, :3], X[pt]) \
        + poses[kf, :3, 3]
    uv = _project(Xc) + 0.5 * torch.randn(K * P, 2, generator=g)
    start = poses.clone()
    start[1:, :3, 3] += 0.02 * torch.randn(K - 1, 3, generator=g)
    Prob = collections.namedtuple("Prob", "poses points obs_kf obs_pt obs_uv "
                                  "obs_w obs_valid kf_fixed")
    return Prob(start, X + 0.03 * torch.randn(P, 3, generator=g), kf, pt, uv,
                torch.ones(K * P), torch.ones(K * P, dtype=torch.bool),
                torch.arange(K) == 0)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ba_control_fails_where_float32_passes(workload, seed):
    limit = full_cell(workload).limits["ba_cost_excess_pct"]
    prob = _ba_problem(seed)
    kw = dict(iters=4)
    P32, X32 = ba.solve(_Cam, prob, dtype=torch.float32, **kw)
    call = {"args": (_Cam, prob), "kw": kw,
            "out": type("Out", (), {"poses": P32, "points": X32})}
    assert ba.cost_excess_pct(call) <= limit
    low = ba.solve(_Cam, prob, dtype=torch.bfloat16, **kw)
    assert ba.cost_excess_pct(call, against=low) > limit


def _sim3_call(seed):
    """120 landmark pairs between two keyframes under a Sim3 of scale 1.05,
    0.5 px of noise, 10 outliers, the start a little off."""
    g = torch.Generator().manual_seed(seed)
    n = 120
    x1 = torch.randn(n, 3, generator=g) * torch.tensor([2.0, 1.5, 1.0]) \
        + torch.tensor([0.0, 0.0, 6.0])
    s, R, t = 1.05, _rot_y(0.05), torch.tensor([0.2, -0.05, 0.1])
    x2 = s * x1 @ R.T + t
    uv1 = _project(x1) + 0.5 * torch.randn(n, 2, generator=g)
    uv2 = _project(x2) + 0.5 * torch.randn(n, 2, generator=g)
    uv2[:10] += 40.0
    args = (_Cam, x1, x2, uv1, uv2, torch.tensor(1.0), _rot_y(0.03),
            t + 0.05, torch.ones(n, dtype=torch.bool))
    return {"args": args, "kw": {"chi2_th": 9.21}}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sim3_control_fails_where_float32_passes(workload, seed):
    limit = full_cell(workload).limits["sim3_gap_px"]
    call = _sim3_call(seed)
    kw = sim3._kw(call)
    call["out"] = sim3.refine(**kw, dtype=torch.float32)
    assert sim3.inliers(call) >= 100
    assert sim3.gap_px(call) <= limit
    low = sim3.refine(**kw, dtype=torch.bfloat16)[:3]
    assert sim3.gap_px(call, against=low) > limit


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_at_the_cells_size(workload):
    """benchmark/control.py's readings for one seed, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size runs there")
    import time

    from benchmark import control
    from benchmark.harness import checks, main

    cell = full_cell(workload)
    keep = {}
    main.run(cell, 2**31 + 99, 15.0, False, time.perf_counter(), keep=keep)
    lim = checks.limits(cell)
    ctl = control.control_numbers(cell, keep["samples"], keep["outcome"])
    assert ctl and all(v > lim[k] for k, v in ctl.items() if k in lim)

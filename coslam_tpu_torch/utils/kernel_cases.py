"""Seeded inputs for kernels K1 `fast_score_nms_pyramid`, K2 `masked_match`,
K3 `pose_opt_lm` and K4 `sim3_refine_lm` at the shapes the tracking,
mapping and loop-closing paths give them.

`chip_smoke.py` and `scripts/compare_torch_kernels.py` both walk `MATCH_CASES`
and then `POSE_CASES` in order with one `numpy.random.default_rng(0)`, so the
two time the same inputs under the same names; K1's input is a rendered
frame and draws nothing.  K4's cases draw from a generator of their own
(`sim3_inputs` with `numpy.random.default_rng(SIM3_SEED)`, case by case).
"""

from __future__ import annotations

import numpy as np
import torch

POSE_KW = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, rounds=4, iters=10,
               chi2_th=5.991)


FAST_MARGIN = 19      # ExtractorConfig.edge_threshold


def fast_inputs(dev, width=640, height=480):
    """The pyramid levels K1 sees on a frame of the synthetic reference
    workload (frame 80, the first of the localization slice), as contiguous
    float32 tensors on `dev`."""
    from coslam_tpu_torch.config import CameraConfig, ExtractorConfig
    from coslam_tpu_torch.ops import pyramid
    from coslam_tpu_torch.utils import synthetic
    cam = CameraConfig(fx=400.0 * width / 640, fy=400.0 * width / 640,
                       cx=width / 2, cy=height / 2, width=width,
                       height=height)
    poses = synthetic.make_trajectory(360, seed=3).poses_cw[80:81]
    img = synthetic.render_sequence(cam, synthetic.Trajectory(poses),
                                    synthetic.make_scene(600, seed=3))[0]
    return [l.contiguous() for l in pyramid.build_pyramid(
        torch.as_tensor(img, device=dev),
        ExtractorConfig(n_features=1000, max_keypoints=1024))]


def _match_cases():
    dense = ((1024, 1024), (32768, 1024), (1024, 32768), (16384, 1024),
             (1024, 16384))
    cases = [(f"{n}x{m}", n, m, None, None) for n, m in dense]
    # a point table as the paths hold it: (slots, valid points at the front)
    for slots, valid in ((32768, 361), (16384, 319)):
        cases.append((f"{slots}x1024 map-like ({valid} valid queries)",
                      slots, 1024, valid, None))
        cases.append((f"1024x{slots} map-like ({valid} valid targets)",
                      1024, slots, None, valid))
    return tuple(cases)


# (name, queries, targets, valid queries or None, valid targets or None)
MATCH_CASES = _match_cases()
# The mapping path's local-map search and whole-map fuse on its own table.
MATCH_MAPPING_PAIR = (MATCH_CASES[7][0], MATCH_CASES[8][0])
MATCH_MAPPING_PAIR_DENSE = ("16384x1024", "1024x16384")
# (name, observations, observations with information or None for 90%):
# dense; what tracking hands over (the localization slice's mean inlier
# count); below the block size; above the register path's limit
POSE_CASES = (("N=1024", 1024, None),
              ("N=1024, 215 with information", 1024, 215),
              ("N=200", 200, None), ("N=3000", 3000, None))
POSE_MAIN_PATH = POSE_CASES[1][0]


def match_inputs(rng, dev, n, m, n_valid_q=None, n_valid_t=None):
    """(args, kw) of one `masked_match` call with the octave gate and
    per-target radii on.  n_valid_*: only the first so many rows of that side
    are valid (a map table), else 90% at random.  Half of the smaller side
    (of its valid rows) has a near-duplicate on the other side."""
    dq = rng.integers(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64)
    dt = rng.integers(-2 ** 31, 2 ** 31, (m, 8), dtype=np.int64)
    k = min(n, m) // 2
    if n_valid_q is not None or n_valid_t is not None:
        k = min(k, n_valid_q or n_valid_t or 0)
    dt[:k] = dq[:k] ^ (1 << rng.integers(0, 31, (k, 8)))
    uq = rng.uniform(0, 640, (n, 2))
    ut = rng.uniform(0, 640, (m, 2))
    ut[:k] = uq[:k] + rng.normal(0, 4, (k, 2))
    vq = rng.uniform(size=n) > 0.1 if n_valid_q is None \
        else np.arange(n) < n_valid_q
    vt = rng.uniform(size=m) > 0.1 if n_valid_t is None \
        else np.arange(m) < n_valid_t
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
    b = lambda a: torch.as_tensor(a, device=dev)
    args = (i32(dq), f32(uq), f32(rng.uniform(10, 60, n) ** 2), b(vq),
            i32(dt), f32(ut), b(vt))
    kw = dict(level_q=f32(rng.integers(0, 8, n)),
              level_t=f32(rng.integers(0, 8, m)), level_lo=-1, level_hi=1,
              r2_t=f32(rng.uniform(10, 60, m) ** 2))
    return args, kw


def match_plain(ck, args, kw):
    """The plain twin of module `ck` on the inputs of `match_inputs`."""
    dq, uq, r2, vq, dt, ut, vt = args
    return ck.masked_match_plain(dq, uq, r2, vq, kw["level_q"], dt, ut, vt,
                                 kw["r2_t"], kw["level_t"], True,
                                 kw["level_lo"], kw["level_hi"])


def pose_inputs(rng, dev, n, n_live=None):
    """(args, kw, true pose) of one `pose_opt_lm` call from the identity: 0.5
    px of noise, an eighth of the observations outliers and a tenth without
    information; n_live: only so many keep their information (the matched
    keypoints among a frame's slots)."""
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 10, n)], 1).astype(np.float32)
    w, t = np.array([0.03, -0.02, 0.05]), np.array([0.1, -0.05, 0.08])
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    pc = X @ R.T + t
    uv = np.stack([pc[:, 0] / pc[:, 2] * 400 + 320,
                   pc[:, 1] / pc[:, 2] * 400 + 240], 1)
    uv += rng.normal(0, 0.5, uv.shape)
    n_out = n // 8
    uv[rng.choice(n, n_out, replace=False)] += rng.uniform(20, 80, (n_out, 2))
    isg = (1.0 / 1.2 ** (2 * rng.integers(0, 8, n))).astype(np.float32)
    isg[rng.choice(n, n // 10 if n_live is None else n - n_live,
                   replace=False)] = 0.0
    Tgt = np.eye(4)
    Tgt[:3, :3], Tgt[:3, 3] = R, t
    args = [torch.eye(4, device=dev)] + [
        torch.as_tensor(np.asarray(a, np.float32), device=dev)
        for a in (X, uv, isg)]
    return args, dict(POSE_KW), Tgt


# K4: the loop closer's polish (chi2_th 9.21, 1024 keypoint slots at 1000
# features).  (name, slots, valid pairs, fix_scale, scale of the true Sim3):
# what a failed RANSAC hands over (0 and 3 pairs: most polishes in the
# replay cell), one that closes a loop (20, 215), every slot valid, the
# strided path above the register limit, the scale frozen, a scale near the
# RANSAC's 1/16 floor.
SIM3_CAM = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640,
                height=480)
SIM3_CHI2 = 9.21
SIM3_SEED = 18
SIM3_CASES = (("1024 slots, 0 valid", 1024, 0, False, 1.4),
              ("1024 slots, 3 valid", 1024, 3, False, 1.4),
              ("1024 slots, 20 valid", 1024, 20, False, 1.4),
              ("1024 slots, 215 valid", 1024, 215, False, 1.4),
              ("1024 slots, 1024 valid", 1024, 1024, False, 1.4),
              ("2048 slots, 1800 valid", 2048, 1800, False, 1.4),
              ("1024 slots, 215 valid, fix_scale", 1024, 215, True, 1.0),
              ("1024 slots, 20 valid, fix_scale", 1024, 20, True, 1.0),
              ("1024 slots, 215 valid, scale 0.07", 1024, 215, False, 0.07))
SIM3_MAIN_PATH = SIM3_CASES[1][0]


def sim3_inputs(rng, dev, n, n_valid, fix_scale=False, s_gt=1.4):
    """(cam, args, kw) of one `sim3.refine_sim3` call: n slots of landmark
    pairs in two keyframes' camera frames related by a Sim3 of scale s_gt,
    0.3 px of pixel noise, a tenth of the valid pairs moved off it, and
    n_valid valid pairs at random slots (the others hold pairs as well, as
    the loop closer's do); the start is the true Sim3 perturbed by 3% in
    scale (not under fix_scale), ~0.03 rad and 5% of its translation."""
    from coslam_tpu_torch.config import CameraConfig

    def rot(w):
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                      [-w[1], w[0], 0]]) / th
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K

    cam = CameraConfig(**SIM3_CAM)
    X1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(4, 9, n)], 1)
    R_gt = rot(np.array([0.1, -0.2, 0.15]))
    t_gt = np.array([0.5, -0.3, 0.8]) * s_gt
    X2 = s_gt * X1 @ R_gt.T + t_gt

    def proj(X):
        return np.stack([X[:, 0] / X[:, 2] * cam.fx + cam.cx,
                         X[:, 1] / X[:, 2] * cam.fy + cam.cy], 1)

    uv1 = proj(X1) + rng.normal(0, 0.3, (n, 2))
    uv2 = proj(X2) + rng.normal(0, 0.3, (n, 2))
    valid = np.zeros(n, bool)
    valid[rng.choice(n, n_valid, replace=False)] = True
    bad = valid & (rng.uniform(size=n) < 0.1)
    X2[bad] += rng.uniform(1, 3, (int(bad.sum()), 3)) * s_gt
    s0 = s_gt if fix_scale else s_gt * 1.03
    R0 = rot(np.array([0.02, -0.015, 0.01])) @ R_gt
    t0 = t_gt + 0.05 * s_gt * np.array([1.0, -1.0, 1.0])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    args = (f32(X1), f32(X2), f32(uv1), f32(uv2), f32(s0), f32(R0),
            f32(t0), torch.as_tensor(valid, device=dev))
    return cam, args, dict(fix_scale=fix_scale, chi2_th=SIM3_CHI2)


def sim3_gaps(sim3, cam, args, kw, got, ref, band=1e-3):
    """(largest |difference| of s, R and t, pairs whose inlier flags differ
    with neither gate error within `band` px^2 of chi2_th at the reference's
    Sim3, pairs whose flags differ in all) between two outputs (s, R, t,
    inliers) of `sim3.refine_sim3` on `args`; `sim3` is the module."""
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got[:3], ref[:3]))
    x1c, x2c, uv1, uv2 = args[:4]
    r = sim3.sim3_residuals(cam, x1c, x2c, uv1, uv2,
                            torch.zeros((1, 7), device=x1c.device),
                            *ref[:3], kw.get("fix_scale", False))
    e = torch.stack([(r[:, :2] ** 2).sum(-1), (r[:, 2:] ** 2).sum(-1)], -1)
    near = ((e - kw["chi2_th"]).abs() < band).any(-1)
    differ = got[3] != ref[3]
    return err, int((differ & ~near).sum()), int(differ.sum())

"""The cylinder loop of tests/test_torch_loop_closing.py (640x480, 500
features, K=64, P=8192, cadence pinned) run from the first frame in both
packages.

The two runs part at frame 1, on the monocular model selection: the
homography's share of the scores, RH = SH / (SH + SF), sits on the 0.40
threshold (Initializer.cc:108).  The reference's f32 solve of the best
fundamental hypothesis puts it at 0.3971 (the F path, initialised at frame
1); the port's f32 solve at 0.4014 and a float64 solve of the same
hypotheses at 0.4025 (the H path, which fails at frame 1).  The port then
initialises at frame 2 with draws the reference never made, on a two-frame
baseline, and loses track around frame 35.  Given the same initialisation
— both runs skip the frame-1 attempt and take the reference's draws — the
port tracks the sequence as the reference does: the same initialisation
frame, the same inliers and keyframe flags, no frame lost."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models import system as jsystem
from coslam_tpu.models.frame import build_frame as jbuild
from coslam_tpu.ops import twoview as jtv
from coslam_tpu.utils import synthetic
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import system as tsystem
from coslam_tpu_torch.models.frame import build_frame as tbuild
from coslam_tpu_torch.ops import twoview as ttv
from coslam_tpu_torch.utils import evaluation

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_torch_smoke_assets as assets  # noqa: E402

# see tests/torch_mapping_common.py: one intra-op thread per xdist worker
torch.set_num_threads(1)

FRAMES = 42
SKIP = 1             # the initialisation attempt decided by the near-tie
CENTRE_BAR = 1e-3


def _cfg(mod):
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640,
                                height=480),
        extractor=mod.ExtractorConfig(n_features=500, max_keypoints=512),
        mapper=mod.MapperConfig(max_keyframes=64, max_points=8192),
        tracker=mod.TrackerConfig(mapper_latency_frames=3))


JC, TC = _cfg(jcfg), _cfg(tcfg)


@pytest.fixture(scope="module")
def seq():
    scene = synthetic.make_cylinder_scene(700, seed=5)
    traj = synthetic.make_loop_trajectory(115, seed=5, frac=1.25)
    return synthetic.render_sequence(JC.camera, traj, scene)[:FRAMES]


def _jax_rh(f0, f1, samples):
    """The reference's H / F scores over its own hypotheses, as
    `twoview.initialize` computes them before choosing the model."""
    mm = jsystem._match_for_init(JC, f0, f1)
    uv1, uv2 = f0.uv, f1.uv[jnp.maximum(mm.idx, 0)]
    uv1n, T1 = jtv._normalize(uv1, mm.valid)
    uv2n, T2 = jtv._normalize(uv2, mm.valid)

    def one(idx):
        a, b = uv1n[idx], uv2n[idx]
        H = jtv._hm(jtv._hm(jnp.linalg.inv(T2), jtv._h_from_8(a, b)), T1)
        F = jtv._hm(jtv._hm(T2.T, jtv._f_from_8(a, b)), T1)
        return (jtv._score_h(H, uv1, uv2, mm.valid, 1.0)[0],
                jtv._score_f(F, uv1, uv2, mm.valid, 1.0)[0])

    sh, sf = jax.vmap(one)(jnp.asarray(samples))
    return np.asarray(mm.idx), np.asarray(sh), np.asarray(sf)


def _port_rh(f0, f1, samples, dtype):
    mm = tsystem._match_for_init(TC, f0, f1)
    uv1 = f0.uv.to(dtype)
    uv2 = f1.uv[torch.clamp(mm.idx, min=0).long()].to(dtype)
    uv1n, T1 = ttv._normalize(uv1, mm.valid)
    uv2n, T2 = ttv._normalize(uv2, mm.valid)
    idx = torch.from_numpy(np.array(samples, np.int64))
    a, b = uv1n[idx], uv2n[idx]
    H = torch.linalg.inv(T2) @ ttv._h_from_8(a, b) @ T1
    F = T2.T @ ttv._f_from_8(a, b) @ T1
    return (mm.idx.numpy(), ttv._score_h(H, uv1, uv2, mm.valid, 1.0)[0]
            .numpy(), ttv._score_f(F, uv1, uv2, mm.valid, 1.0)[0].numpy())


def test_frame_one_model_selection_is_a_near_tie(seq):
    """At frame 1, with the reference's draws: the same matches and the
    same best homography; RH falls below 0.40 in the reference (F path)
    and above it in the port, and a float64 solve of the same hypotheses
    sides with the port.  The best F hypothesis's score differs between
    the two f32 solves by ~2%, as much as either differs from float64:
    the 8-point null vector is ill-conditioned (ROADMAP Queue 3)."""
    js = assets.DrawRecordingSystem(JC, enable_loop_closing=False)
    js.track_mono(seq[0], 0)
    js.track_mono(seq[1], 1)
    assert js.state == "OK"               # the reference initialises here
    draws = js.draws[1]
    j0, j1 = (jbuild(jnp.asarray(seq[i]), JC) for i in (0, 1))
    t0, t1 = (tbuild(torch.as_tensor(seq[i]), TC) for i in (0, 1))
    jidx, jsh, jsf = _jax_rh(j0, j1, draws)
    tidx, tsh, tsf = _port_rh(t0, t1, draws, torch.float32)
    _, dsh, dsf = _port_rh(t0, t1, draws, torch.float64)
    np.testing.assert_array_equal(tidx, jidx)
    assert int(np.argmax(jsh)) == int(np.argmax(tsh)) == int(np.argmax(dsh))
    np.testing.assert_allclose(tsh.max(), jsh.max(), rtol=1e-4)
    rh = [sh.max() / (sh.max() + sf.max())
          for sh, sf in ((jsh, jsf), (tsh, tsf), (dsh, dsf))]
    assert rh[0] < 0.40 < rh[1] and rh[2] > 0.40, rh
    assert all(abs(r - 0.40) < 0.005 for r in rh), rh
    b = int(np.argmax(jsf))
    assert abs(jsf[b] - dsf[b]) / dsf[b] < 0.03, (jsf[b], dsf[b])
    assert abs(tsf[b] - dsf[b]) / dsf[b] < 0.03, (tsf[b], dsf[b])
    # and the port's System, with the same draws, does not initialise
    ts = tsystem.System(TC, device="cpu", enable_loop_closing=False)
    ts.init_draws[1] = draws
    ts.track_mono(seq[0], 0)
    ts.track_mono(seq[1], 1)
    assert ts.state == "NOT_INITIALIZED"


class _JaxSkip(assets.DrawRecordingSystem):
    def _try_initialize(self, frame, frame_id):
        if frame_id != SKIP:
            return super()._try_initialize(frame, frame_id)


class _PortSkip(tsystem.System):
    def _try_initialize(self, frame, frame_id):
        if frame_id != SKIP:
            return super()._try_initialize(frame, frame_id)


def test_port_tracks_the_loop_from_the_first_frame(seq):
    """Both packages skip the frame-1 attempt; the port takes the
    reference's draws.  Over frames 0-41: the same initialisation frame, 0
    lost frames, per-frame inliers within max(3, 5%), the same keyframe
    flags, camera centres within 1e-3 (the scene's radius is 10)."""
    js = _JaxSkip(JC, enable_loop_closing=True)
    js.run_sequence(seq)
    ts = _PortSkip(TC, device="cpu", enable_loop_closing=True)
    ts.init_draws.update(js.draws)
    ts.run_sequence(seq)
    jid, jT = js.trajectory_poses()
    tid, tT = ts.trajectory_poses()
    assert tid == jid and jid[-1] == FRAMES - 1
    for s in (js, ts):
        assert not any(st.get("lost") for st in s.stats)
    assert [st["frame"] for st in ts.stats if st.get("keyframe")] == \
        [st["frame"] for st in js.stats if st.get("keyframe")]
    ji = np.array([st["inliers"] for st in js.stats])
    ti = np.array([st["inliers"] for st in ts.stats])
    assert (np.abs(ti - ji) <= np.maximum(3, 0.05 * ji)).all(), (ti, ji)
    err = np.linalg.norm(evaluation.trajectory_xyz(tT)
                         - evaluation.trajectory_xyz(jT), axis=1)
    assert err.max() <= CENTRE_BAR, err.max()

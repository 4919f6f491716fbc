"""Relocalization against coslam_tpu on the CPU: place-recognition
candidates, one `relocalize_against_kf` attempt, and a kidnap run through
`System.track_mono` (blank frames -> LOST -> recovery).

The map is built in-process by the JAX System (640x480, 512 keypoints, K=32,
P=4096, 20 frames of make_scene(600, seed=3) / make_trajectory(30, seed=3),
the scenario of tests/test_pnp_reloc.py::test_relocalization_after_kidnap)
and carried across by utils/checkpoint.py; the JAX System then goes on
through the kidnap itself, recording each attempt's candidates and the EPnP
draws that `ransac_pnp` makes inside it, which the port gets injected.

Bars: candidate lists equal; per attempt the same side of the 50-inlier
gate, `n_inliers` within max(3, 5%), T within 1e-3 where both accept (both
come out of the same pose optimizer on nearly the same matches), bindings
equal on at least 95% of keypoints; the kidnap run LOST on the same frames,
recovered on the same frame from the same candidate, the recovered pose
within 1e-2 of the JAX run's (one more TrackLocalMap on top)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models import tracking as jtr
from coslam_tpu.models.frame import build_frame as jbuild_frame
from coslam_tpu.models.system import System as JSystem
from coslam_tpu.ops import matching as jmatching
from coslam_tpu.utils import checkpoint as jck
from coslam_tpu.utils import synthetic
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import tracking as ttr
from coslam_tpu_torch.models.frame import build_frame as tbuild_frame
from coslam_tpu_torch.models.system import System as TSystem
from coslam_tpu_torch.utils import checkpoint as tck

# The test run splits the cores among its xdist workers; torch's own
# intra-op pool on top of that spins against the other workers' threads.
torch.set_num_threads(1)

MAPPED = 20
N_BLANK = 3
RETURN_TO = (10, 11, 12, 13)


def _cfg(mod):
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640,
                                height=480),
        extractor=mod.ExtractorConfig(n_features=500, max_keypoints=512),
        mapper=mod.MapperConfig(max_keyframes=32, max_points=4096))


def jax_reloc_draws(cfg, m, frame, c, key):
    """The (512, 6) sample indices `pnp.ransac_pnp` draws inside
    `relocalize_against_kf(cfg, m, frame, c, key)`: the same seed matching,
    then the same `jax.random.choice`."""
    pt = m.kf_obs_pt[c]
    pt_safe = jnp.maximum(pt, 0)
    ok_t = (pt >= 0) & m.kf_kp_valid[c] & m.pt_valid[pt_safe]
    mm = jmatching.match(frame.desc, frame.valid, m.pt_desc[pt_safe], ok_t,
                         cfg.matcher, max_dist=cfg.matcher.th_high,
                         mutual=True, angle_q=frame.angle,
                         angle_t=m.kf_angle[c])
    p = mm.valid.astype(jnp.float32)
    p = p / (p.sum() + 1e-9)
    return np.array(jax.random.choice(key, frame.uv.shape[0], shape=(512, 6),
                                      replace=True, p=p))


class AttemptRecorder(JSystem):
    """The reference System, recording per relocalization attempt the
    frame count, the candidates and each candidate's draws."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.attempts = []

    def _attempt_relocalization(self, frame):
        cands = self.db.detect_reloc_candidates(frame.desc, frame.valid,
                                                top_k=5)
        base = jax.random.fold_in(self._init_key, self.n_frames_tracked)
        self.attempts.append((self.n_frames_tracked, cands, {
            c: jax_reloc_draws(self.cfg, self.map, frame, c,
                               jax.random.fold_in(base, c)) for c in cands}))
        return super()._attempt_relocalization(frame)


@pytest.fixture(scope="module")
def kidnap(tmp_path_factory):
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(30, seed=3)
    seq = synthetic.render_sequence(_cfg(jcfg).camera, traj, scene)
    js = AttemptRecorder(_cfg(jcfg))
    for i in range(MAPPED):
        js.track_mono(seq[i], i)
    assert js.state == "OK"
    path = str(tmp_path_factory.mktemp("map") / "map.npz")
    jck.save_system(path, js)
    blank = np.full_like(seq[0], 96)
    frames = [(100 + i, blank) for i in range(N_BLANK)] \
        + [(200 + i, seq[i]) for i in RETURN_TO]
    log = []
    for fid, img in frames:
        T = js.track_mono(img, fid)
        log.append(dict(frame=fid, state=js.state, T=np.asarray(T),
                        lost=bool(js.stats[-1]["lost"]),
                        inliers=js.stats[-1]["inliers"],
                        ref_kf=js.last_ref_kf))
        if fid >= 200 and js.state == "OK":
            break
    assert [e["state"] for e in log[:N_BLANK]] == ["LOST"] * N_BLANK
    assert log[-1]["state"] == "OK", "the reference did not relocalize"
    assert getattr(js, "n_relocalizations", 0) >= 1
    return dict(path=path, frames=frames[:len(log)], log=log,
                attempts=js.attempts, n0=MAPPED)


def _loaded(path):
    js = JSystem(_cfg(jcfg))
    jck.load_system(path, js)
    ts = TSystem(_cfg(tcfg), device="cpu")
    tck.load_system(path, ts)
    return js, ts


def test_detect_reloc_candidates(kidnap):
    js, ts = _loaded(kidnap["path"])
    assert ts.db.detect_reloc_candidates(
        torch.zeros((512, 8), dtype=torch.int32),
        torch.zeros(512, dtype=torch.bool)) \
        == js.db.detect_reloc_candidates(jnp.zeros((512, 8), jnp.uint32),
                                         jnp.zeros(512, bool))
    for (_fid, img), (_n, cands, _d) in zip(kidnap["frames"],
                                            kidnap["attempts"]):
        jf = jbuild_frame(jnp.asarray(img), js.cfg)
        tf = tbuild_frame(torch.from_numpy(img), ts.cfg)
        got = ts.db.detect_reloc_candidates(tf.desc, tf.valid, top_k=5)
        assert got == js.db.detect_reloc_candidates(jf.desc, jf.valid,
                                                    top_k=5) == cands
        assert ts.db.detect_reloc_candidates(tf.desc, tf.valid, top_k=2) \
            == cands[:2]
    ts.db.has[:] = False
    assert ts.db.detect_reloc_candidates(tf.desc, tf.valid) == []


def test_relocalize_against_kf(kidnap):
    """Every candidate of the frame the reference recovered on."""
    js, ts = _loaded(kidnap["path"])
    (_fid, img), (n_tracked, cands, draws) = \
        kidnap["frames"][-1], kidnap["attempts"][-1]
    jf = jbuild_frame(jnp.asarray(img), js.cfg)
    tf = tbuild_frame(torch.from_numpy(img), ts.cfg)
    gate = ts.cfg.tracker.min_inliers_reloc
    base = jax.random.fold_in(jax.random.PRNGKey(0), n_tracked)
    accepted = {}
    for c in cands:
        jres = jtr.relocalize_against_kf(js.cfg, js.map, jf, jnp.asarray(c),
                                         jax.random.fold_in(base, c))
        tres = ttr.relocalize_against_kf(ts.cfg, ts.map, tf, c,
                                         samples=torch.from_numpy(draws[c]))
        jn, tn = int(jres.n_inliers), int(tres.n_inliers)
        assert (tn >= gate) == (jn >= gate), (c, tn, jn)
        assert abs(tn - jn) <= max(3, 0.05 * jn), (c, tn, jn)
        assert int(tres.ref_kf) == c == int(jres.ref_kf)
        assert int(tres.n_matches) == int(jres.n_matches)
        accepted[c] = jn >= gate
        if jn >= gate:
            np.testing.assert_allclose(tres.T.numpy(), np.asarray(jres.T),
                                       atol=1e-3)
            same = tres.kp_pt.numpy() == np.asarray(jres.kp_pt)
            assert same.mean() >= 0.95, same.mean()
            assert int((tres.kp_pt >= 0).sum()) == tn
    assert any(accepted.values())
    # with draws of its own from a generator the attempt comes out on the
    # same side of the gate
    own = ttr.relocalize_against_kf(
        ts.cfg, ts.map, tf, cands[0],
        generator=torch.Generator().manual_seed(1))
    assert (int(own.n_inliers) >= gate) == accepted[cands[0]]


def test_kidnap_and_recover(kidnap):
    _js, ts = _loaded(kidnap["path"])
    # the reference keyed its draws by its own frame count; the port's
    # count starts at the checkpoint
    for n_tracked, _cands, draws in kidnap["attempts"]:
        for c, d in draws.items():
            ts.reloc_draws[(n_tracked - kidnap["n0"], c)] = d
    for (fid, img), ref in zip(kidnap["frames"], kidnap["log"]):
        T = ts.track_mono(img, fid)
        assert T is not None and np.isfinite(T).all()
        assert ts.state == ref["state"], (fid, ts.state, ref["state"])
        assert ts.stats[-1]["lost"] == ref["lost"]
        if ref["lost"]:
            # dead reckoning without velocity: the pose stands still
            np.testing.assert_allclose(T, ref["T"], atol=1e-6)
            assert ts.velocity is None
            assert int(ts.get_tracked_map_points().max()) == -1
        else:
            np.testing.assert_allclose(T, ref["T"], atol=1e-2)
            ti, ji = ts.stats[-1]["inliers"], ref["inliers"]
            assert abs(ti - ji) <= max(3, 0.05 * ji), (ti, ji)
            assert (ts.get_tracked_map_points() >= 0).sum() == ti
    assert ts.state == "OK"
    info = ts.shutdown()
    assert info["relocalizations"] == 1
    assert ts.get_tracked_keypoints_un().shape == (512, 2)
    # and a reset brings the System back to its start
    ts.reset()
    assert ts.state == "NOT_INITIALIZED" and ts.stats == []
    assert int(ts.map.kf_valid.sum()) == 0 and not ts.db.has.any()
    assert ts.get_tracked_map_points().size == 0

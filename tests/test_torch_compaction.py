"""models/compaction and the System's capacity path: the port against
coslam_tpu.

`compact` / `grow` run on a map with culled keyframe and point slots;
`_remap_after_compact` re-anchors a trajectory whose reference keyframe was
culled; and a whole mapping run with K=6 keyframe slots reaches the
capacity watermark, so the synchronous `_insert_keyframes_batch`,
`compact`, `grow` and `_remap_after_compact` run inside `run_sequence`
(the bench-size card run never reaches them).

Bars: index maps and every integer field exact, floats bit-equal (compaction
only moves rows); the K=6 run as tests/torch_mapping_common.py's bars."""

import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models import compaction as jcomp
from coslam_tpu.models import map_state as jms
from coslam_tpu.models.system import System as JSystem
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import compaction as tcomp
from coslam_tpu_torch.models.system import System as TSystem

from torch_mapping_common import (DrawRecorder, assert_runs_agree,
                                  mapping_cfg, sequence)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _random_map(rng, cfg):
    K, P = cfg.mapper.max_keyframes, cfg.mapper.max_points
    N = cfg.extractor.max_keypoints
    m = jms.empty_map(cfg)
    n_kf, n_pt = K - 2, P - 5
    kf_valid = np.arange(K) < n_kf
    kf_valid[[1, 4]] = False
    pt_valid = (np.arange(P) < n_pt) & (rng.uniform(size=P) > 0.3)
    pose = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    pose[:, :3, 3] = rng.normal(size=(K, 3))
    return m._replace(
        kf_pose=pose, kf_valid=kf_valid,
        kf_frame_id=np.arange(K, dtype=np.int32) * 3,
        kf_uv=rng.uniform(0, 640, (K, N, 2)).astype(np.float32),
        kf_level=rng.integers(0, 8, (K, N)).astype(np.int32),
        kf_desc=rng.integers(0, 2 ** 32, (K, N, 8), dtype=np.uint32),
        kf_kp_valid=rng.uniform(size=(K, N)) > 0.1,
        kf_obs_pt=rng.integers(-1, n_pt, (K, N)).astype(np.int32),
        pt_pos=rng.normal(size=(P, 3)).astype(np.float32),
        pt_valid=pt_valid,
        pt_desc=rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint32),
        pt_ref_kf=rng.integers(0, n_kf, P).astype(np.int32),
        pt_first_kf=rng.integers(0, n_kf + 1, P).astype(np.int32),
        pt_visible=rng.integers(0, 9, P).astype(np.int32),
        n_kf=np.int32(n_kf), n_pt=np.int32(n_pt))


def _small(mod):
    return mod.SystemConfig(
        extractor=mod.ExtractorConfig(n_features=40, max_keypoints=32),
        mapper=mod.MapperConfig(max_keyframes=8, max_points=64))


def _assert_equal_maps(tmap, jmap):
    for k, tv in tmap._asdict().items():
        jv = np.asarray(getattr(jmap, k))
        if jv.dtype == np.uint32:
            jv = jv.view(np.int32)
        np.testing.assert_array_equal(tv.numpy(), jv, err_msg=k)


def test_compact_and_grow_match_reference(rng):
    jmap = _random_map(rng, _small(jcfg))
    tmap = jms.MapState(**{k: _t(v) for k, v in jmap._asdict().items()})
    jnew, jkf, jpt = jcomp.compact(_small(jcfg), jmap)
    tnew, tkf, tpt = tcomp.compact(_small(tcfg), tmap)
    np.testing.assert_array_equal(tkf, jkf)
    np.testing.assert_array_equal(tpt, jpt)
    _assert_equal_maps(tnew, jnew)
    assert int(tnew.n_kf) == int(np.asarray(jnew.n_kf)) == 4
    assert tnew.n_kf.dim() == 0 and tnew.n_pt.dim() == 0
    jc2, jbig = jcomp.grow(_small(jcfg), jnew, 16, 0)
    tc2, tbig = tcomp.grow(_small(tcfg), tnew, 16, 0)
    assert (tc2.mapper.max_keyframes, tc2.mapper.max_points) == \
        (jc2.mapper.max_keyframes, jc2.mapper.max_points) == (16, 128)
    _assert_equal_maps(tbig, jbig)


def test_remap_after_compact_matches_reference(rng):
    """Trajectory anchors on a culled keyframe are re-expressed against the
    nearest surviving one; last-frame bindings and BoW rows follow their
    slots."""
    jmap = _random_map(rng, _small(jcfg))
    tmap = jms.MapState(**{k: _t(v) for k, v in jmap._asdict().items()})
    js = JSystem(_small(jcfg), enable_loop_closing=False)
    ts = TSystem(_small(tcfg), device="cpu", enable_loop_closing=False)
    traj = [(3 * i, i % 6, np.eye(4, dtype=np.float32) * (1 + 0.1 * i))
            for i in range(6)]
    kp = rng.integers(-1, 59, 32).astype(np.int32)
    for s, kp_t in ((js, kp), (ts, torch.from_numpy(kp))):
        s.trajectory = list(traj)
        s.last_kp_pt = kp_t
        s.last_ref_kf = 4
        s.db.bows[:] = rng.uniform(size=s.db.bows.shape).astype(np.float32)
        s.db.has[:] = True
    ts.db.bows[:] = js.db.bows
    jnew, jkf, jpt = jcomp.compact(_small(jcfg), jmap)
    tnew, tkf, tpt = tcomp.compact(_small(tcfg), tmap)
    js._remap_after_compact(jmap, jnew, jkf, jpt)
    ts._remap_after_compact(tmap, tnew, tkf, tpt)
    assert [(f, r) for f, r, _ in ts.trajectory] == \
        [(f, r) for f, r, _ in js.trajectory]
    for (_, _, a), (_, _, b) in zip(ts.trajectory, js.trajectory):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_array_equal(ts.last_kp_pt.numpy(),
                                  np.asarray(js.last_kp_pt))
    assert ts.last_ref_kf == js.last_ref_kf
    np.testing.assert_array_equal(ts.db.bows, js.db.bows)
    np.testing.assert_array_equal(ts.db.has, js.db.has)


@pytest.fixture(scope="module")
def watermark_reference():
    seq = sequence()
    js = DrawRecorder(mapping_cfg(jcfg, K=6), enable_loop_closing=False)
    js.run_sequence(seq)
    return js, seq


def test_capacity_watermark_run_matches_reference(watermark_reference):
    js, seq = watermark_reference
    assert js.cfg.mapper.max_keyframes == 12     # the watermark fired
    ts = TSystem(mapping_cfg(tcfg, K=6), device="cpu",
                 enable_loop_closing=False)
    ts.init_draws = dict(js.draws)
    calls = []
    batch = ts._insert_keyframes_batch

    def spy(*a, **kw):
        calls.append(ts._host_n_kf)
        return batch(*a, **kw)

    ts._insert_keyframes_batch = spy
    ts.run_sequence(seq)
    assert calls, "the synchronous batch insert never ran"
    assert ts.cfg.mapper.max_keyframes == 12
    assert ts.map.kf_pose.shape[0] == ts.db.bows.shape[0] == 12
    assert_runs_agree(js, ts)
    np.testing.assert_allclose(ts.db.bows, js.db.bows, atol=1e-6)

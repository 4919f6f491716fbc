"""The checkpoint converter: a System saved by coslam_tpu loads into the port
with every MapState field bit-equal (descriptors through their int32 view),
and a map saved by the port loads back into coslam_tpu unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models import map_state as jms
from coslam_tpu.models.system import System as JSystem
from coslam_tpu.utils import checkpoint as jck
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import map_state as tms
from coslam_tpu_torch.models.system import System as TSystem
from coslam_tpu_torch.utils import checkpoint as tck

SMALL = dict(extractor=dict(n_features=100, max_keypoints=64),
             mapper=dict(max_keyframes=8, max_points=512))


def _cfg(mod):
    return mod.SystemConfig(
        extractor=mod.ExtractorConfig(**SMALL["extractor"]),
        mapper=mod.MapperConfig(**SMALL["mapper"]))


def _random_map(rng, cfg):
    ref = jms.empty_map(cfg)
    out = {}
    for k, v in ref._asdict().items():
        v = np.asarray(v)
        if v.dtype == np.bool_:
            a = rng.uniform(size=v.shape) > 0.5
        elif v.dtype == np.uint32:
            a = rng.integers(0, 2 ** 32, v.shape, dtype=np.uint32)
        elif v.dtype == np.int32:
            a = rng.integers(-1, 500, v.shape).astype(np.int32)
        else:
            a = rng.normal(0, 3, v.shape).astype(v.dtype)
        out[k] = jnp.asarray(a)
    return jms.MapState(**out)


def _assert_maps_equal(tmap, jmap):
    assert tmap._fields == jmap._fields
    for k, tv in tmap._asdict().items():
        jv = np.asarray(getattr(jmap, k))
        if jv.dtype == np.uint32:
            assert tv.dtype == torch.int32, k
            jv = jv.view(np.int32)
        assert tv.numpy().dtype == jv.dtype, k
        np.testing.assert_array_equal(tv.numpy(), jv, err_msg=k)


def test_load_system_from_reference_checkpoint(rng, tmp_path):
    jc = _cfg(jcfg)
    js = JSystem(jc, enable_loop_closing=False)
    js.map = _random_map(rng, jc)
    js.state = "OK"
    js.last_T = rng.normal(0, 1, (4, 4)).astype(np.float32)
    js.velocity = rng.normal(0, 1, (4, 4)).astype(np.float32)
    js.last_kp_pt = jnp.asarray(rng.integers(-1, 500, 64).astype(np.int32))
    js.last_level = jnp.asarray(rng.integers(0, 8, 64).astype(np.int32))
    js.frames_since_kf, js.ref_kf_matches = 5, 77
    path = str(tmp_path / "map.npz")
    jck.save_system(path, js)

    ts = TSystem(_cfg(tcfg), device="cpu", enable_loop_closing=False)
    tck.load_system(path, ts)
    _assert_maps_equal(ts.map, js.map)
    assert ts.state == "OK"
    np.testing.assert_array_equal(ts.last_T, js.last_T)
    np.testing.assert_array_equal(ts.velocity, js.velocity)
    np.testing.assert_array_equal(ts.last_kp_pt.numpy(),
                                  np.asarray(js.last_kp_pt))
    np.testing.assert_array_equal(ts.last_level.numpy(),
                                  np.asarray(js.last_level))
    assert (ts.frames_since_kf, ts.ref_kf_matches) == (5, 77)
    assert ts._host_n_kf == int(js.map.n_kf)
    # the repaired resume: point-counter mirror and a real KeyFrameDatabase
    assert ts._host_n_pt == int(js.map.n_pt)
    np.testing.assert_array_equal(ts.db.bows, js.db.bows)
    np.testing.assert_array_equal(ts.db.has, js.db.has)
    np.testing.assert_array_equal(ts.db.vocab.numpy().view(np.uint32),
                                  np.asarray(js.db.vocab))
    assert ts.db._external_vocab and ts.db.n_words == js.db.n_words


def test_port_map_loads_back_into_reference(rng, tmp_path):
    jmap = _random_map(rng, _cfg(jcfg))
    path = str(tmp_path / "m.npz")
    jck.save_map(path, jmap, {"note": np.arange(3)})
    tmap, extra = tck.load_map(path, device="cpu")
    np.testing.assert_array_equal(extra["note"], np.arange(3))
    path2 = str(tmp_path / "m2.npz")
    tck.save_map(path2, tmap)
    back, _ = jck.load_map(path2)
    for k in jmap._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(jmap, k)), err_msg=k)


@pytest.mark.parametrize("name", ["empty_map", "point_obs_count"])
def test_map_state_functions(rng, name):
    jc, tc = _cfg(jcfg), _cfg(tcfg)
    if name == "empty_map":
        _assert_maps_equal(tms.empty_map(tc, device="cpu"), jms.empty_map(jc))
        return
    jmap = _random_map(rng, jc)
    jmap = jmap._replace(kf_obs_pt=jnp.asarray(
        rng.integers(-1, 512, (8, 64)).astype(np.int32)))
    tmap = tms.MapState(**{k: torch.from_numpy(
        np.array(v).view(np.int32) if np.asarray(v).dtype == np.uint32
        else np.array(v)) for k, v in jmap._asdict().items()})
    np.testing.assert_array_equal(tms.point_obs_count(tmap).numpy(),
                                  np.asarray(jms.point_obs_count(jmap)))


def test_load_system_widens_capacities_and_db(rng, tmp_path):
    """A checkpoint whose capacities grew past the System's config widens
    the config and the database (reference checkpoint.py:76-82)."""
    jc = _cfg(jcfg)
    js = JSystem(jc, enable_loop_closing=False)
    js.map = _random_map(rng, jc)
    js.state = "OK"
    path = str(tmp_path / "map.npz")
    jck.save_system(path, js)
    small = tcfg.SystemConfig(
        extractor=tcfg.ExtractorConfig(**SMALL["extractor"]),
        mapper=tcfg.MapperConfig(max_keyframes=4, max_points=256))
    ts = TSystem(small, device="cpu", enable_loop_closing=False)
    assert ts.db.bows.shape[0] == 4
    tck.load_system(path, ts)
    assert ts.cfg.mapper.max_keyframes == 8
    assert ts.cfg.mapper.max_points == 512
    assert ts.db.cfg is ts.cfg and ts.db.bows.shape[0] == 8


def test_save_system_loads_into_reference(rng, tmp_path):
    """A System saved by the port resumes in coslam_tpu with the same map,
    tracking state and database."""
    jc = _cfg(jcfg)
    js = JSystem(jc, enable_loop_closing=False)
    js.map = _random_map(rng, jc)
    js.state = "OK"
    js.last_T = rng.normal(0, 1, (4, 4)).astype(np.float32)
    js.last_kp_pt = jnp.asarray(rng.integers(-1, 500, 64).astype(np.int32))
    js.last_level = jnp.asarray(rng.integers(0, 8, 64).astype(np.int32))
    js.db.bows[:] = rng.uniform(size=js.db.bows.shape).astype(np.float32)
    js.db.has[:] = True
    path = str(tmp_path / "j.npz")
    jck.save_system(path, js)
    ts = TSystem(_cfg(tcfg), device="cpu", enable_loop_closing=False)
    tck.load_system(path, ts)
    path2 = str(tmp_path / "t.npz")
    tck.save_system(path2, ts)
    back = JSystem(jc, enable_loop_closing=False)
    jck.load_system(path2, back)
    _assert_maps_equal(ts.map, back.map)
    np.testing.assert_array_equal(back.last_T, js.last_T)
    assert back.velocity is None and back.state == "OK"
    np.testing.assert_array_equal(np.asarray(back.last_kp_pt),
                                  np.asarray(js.last_kp_pt))
    np.testing.assert_array_equal(back.db.bows, js.db.bows)
    np.testing.assert_array_equal(np.asarray(back.db.vocab),
                                  np.asarray(js.db.vocab))

"""models/cooperative (+ local_mapping.backend_post_insert and
checkpoint.load_coop_state) of the port against coslam_tpu's.

The JAX state comes from the assets of scripts/make_torch_smoke_assets.py
--coop-only (the two-agent workload of `cli._coop_setup` at 640x480 / 1000
features, K=128, P=32768): `smoke_coop_merge.npz` holds the receiver just
before the JAX run's first successful `_try_merge` (12 own and 14 foreign
keyframes), `smoke_coop_expected.npz` what that call and the whole run
gave.  It is loaded once per module into a JAX CoopAgent and a port
CoopAgent on the CPU.

Bars: packets, the npz wire bytes, `_add_foreign_points` and packet
integration (dedup, slots, bindings, owners) bit-equal; the component
similarity within 1e-5; `backend_post_insert` at the local-BA bars of
tests/test_torch_local_mapping.py (poses 1e-4, points 1e-3, observation
rows differing in at most 0.5% of the slots); `_try_merge` at
chip_smoke.py phase 10 (a)'s windows: the same foreign keyframe and
candidate, inliers within max(3, 5%), S_w's s within 1e-3 relative, R
within 0.1 deg, t within 1e-3 of the map's extent, and — on the state with
the runaway landmarks of the call's first global BA removed (see
scripts/make_torch_smoke_assets.runaway_points) — the same sweep and merge
count and keyframe centres within 5e-3 of the extent after the whole
call."""

import io
import os
import sys
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models import compaction as jcomp
from coslam_tpu.models import cooperative as jcoop
from coslam_tpu.models import local_mapping as jlm
from coslam_tpu.models import map_state as jms
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import compaction as tcomp
from coslam_tpu_torch.models import cooperative as tcoop
from coslam_tpu_torch.models import local_mapping as tlm
from coslam_tpu_torch.models import map_state as tms
from coslam_tpu_torch.utils import checkpoint as tckpt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_torch_smoke_assets as assets  # noqa: E402

# see tests/torch_mapping_common.py: one intra-op thread per xdist worker
torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(__file__), "..", "coslam_tpu_torch",
                      "assets")
MERGE = os.path.join(ASSETS, "smoke_coop_merge.npz")
EXPECTED = os.path.join(ASSETS, "smoke_coop_expected.npz")


def _cfg(mod, K=128, P=32768, N=1024):
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640,
                                height=480),
        extractor=mod.ExtractorConfig(n_features=1000, max_keypoints=N),
        mapper=mod.MapperConfig(max_keyframes=K, max_points=P),
        loop=mod.LoopConfig(min_kfs_between_loops=15,
                            sim3_min_bow_matches=25, sim3_min_inliers=20),
        tracker=mod.TrackerConfig(init_min_matches=60, init_min_good=35,
                                  mapper_latency_frames=3))


JC, TC = _cfg(jcfg), _cfg(tcfg)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _np(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def to_torch(jm):
    return tms.MapState(**{k: _t(v) for k, v in jm._asdict().items()})


def jax_agent(drop=()):
    """The JAX CoopAgent in the merge asset's state (the file padded as
    `load_coop_state` pads it), landmarks `drop` invalidated."""
    with np.load(MERGE) as z:
        arrays = {k: z[k] for k in z.files}
    x = {k[6:]: v for k, v in arrays.items() if k.startswith("extra_")}
    K, P = int(x["max_keyframes"]), int(x["max_points"])
    fields = {}
    for name, full in jms.empty_map(JC)._asdict().items():
        a = arrays[f"map_{name}"]
        if name.startswith(("kf_", "pt_")):
            full = np.array(full)
            full[: a.shape[0]] = a
            a = full
        fields[name] = jnp.asarray(a)
    m = jms.MapState(**fields)
    if len(drop):
        m = m._replace(pt_valid=m.pt_valid.at[jnp.asarray(drop)].set(False))

    def pad(v, n, fill):
        out = np.full((n,) + v.shape[1:], fill, v.dtype)
        out[: len(v)] = v
        return out

    a = jcoop.CoopAgent(JC, int(x["agent_id"]), enable_loop_closing=False)
    a.map, a.state = m, "OK"
    a.db.bows = pad(x["db_bows"], K, 0.0)
    a.db.has = pad(x["db_has"], K, False)
    a.db._n_added = int(x["db_n_added"])
    a.db._version += 1
    a.kf_agent = pad(x["kf_agent"], K, -1)
    a.pt_agent = pad(x["pt_agent"], P, -1)
    a._kf_sent = pad(x["kf_sent"], K, False)
    a._foreign_pt = {(int(p), int(i)): int(s) for p, i, s in x["foreign_pt"]}
    a._foreign_agents = {int(v) for v in x["foreign_agents"]}
    a.n_merges = int(x["n_merges"])
    a._host_n_kf, a._host_n_pt = int(x["host_n_kf"]), int(x["host_n_pt"])
    return a


def port_agent(drop=(), **kw):
    a = tcoop.CoopAgent(TC, 0, device="cpu", enable_loop_closing=False,
                        **kw)
    tckpt.load_coop_state(MERGE, a)
    if len(drop):
        pv = a.map.pt_valid.clone()
        pv[torch.as_tensor(np.asarray(drop)).long()] = False
        a.map = a.map._replace(pt_valid=pv)
    return a


@pytest.fixture(scope="module")
def exp():
    with np.load(EXPECTED) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def agents():
    return jax_agent(), port_agent()


def _centres(T):
    return -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])


def _rot_err_deg(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


# ---------------------------------------------------------------------------

def test_load_coop_state_restores_the_jax_agent(agents):
    ja, ta = agents
    for k, v in ta.map._asdict().items():
        np.testing.assert_array_equal(v.numpy(), _np(getattr(ja.map, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(ta.db.bows, ja.db.bows)
    np.testing.assert_array_equal(ta.db.has, ja.db.has)
    assert ta.db._n_added == ja.db._n_added
    for name in ("kf_agent", "pt_agent", "_kf_sent"):
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name))
    assert ta._foreign_pt == ja._foreign_pt and len(ta._foreign_pt) > 100
    assert ta._foreign_agents == ja._foreign_agents == {1}
    assert ta.merged_agents == {} and ta._agent_sim3 == {}
    assert (ta._host_n_kf, ta._host_n_pt, ta.n_merges) == \
        (ja._host_n_kf, ja._host_n_pt, 0)


@pytest.mark.parametrize("kf", [0, 3, 9])
def test_pack_keyframe_is_the_jax_packet(agents, kf):
    ja, ta = agents
    jp = jcoop.pack_keyframe(ja.map, kf, 7)
    tp = tcoop.pack_keyframe(ta.map, kf, 7)
    assert int(ja.kf_agent[kf]) == (0 if kf == 0 else 1)
    assert tp.agent_id == jp.agent_id and tp.frame_id == jp.frame_id
    for name in jp._fields[2:]:
        a, b = getattr(tp, name), getattr(jp, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tp.pt_flag.sum() > 50


def _npz_members(data: bytes) -> dict:
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_wire_bytes_both_ways(agents):
    """The npz of either package deserializes in the other bit-equal; the
    archives hold the same members with the same bytes (the zip headers
    carry a time stamp)."""
    ja, ta = agents
    jp = jcoop.pack_keyframe(ja.map, 5, 1)
    tp = tcoop.pack_keyframe(ta.map, 5, 1)
    jb, tb = jcoop.serialize_packet(jp), tcoop.serialize_packet(tp)
    assert _npz_members(jb) == _npz_members(tb)
    for got, want in ((tcoop.deserialize_packet(jb), jp),
                      (jcoop.deserialize_packet(tb), tp)):
        assert got.agent_id == want.agent_id
        assert got.frame_id == want.frame_id
        for name in want._fields[2:]:
            g, w = getattr(got, name), getattr(want, name)
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _small_maps(rng, K=6, N=32, P=64, n_pt=50):
    """A JAX map and its port copy with random contents and n_pt slots
    used."""
    cj = _cfg(jcfg, K=K, P=P, N=N)
    m = jms.empty_map(cj)
    m = m._replace(
        pt_pos=jnp.asarray(rng.standard_normal((P, 3)), jnp.float32),
        pt_valid=jnp.asarray(np.arange(P) < n_pt),
        pt_desc=jnp.asarray(rng.integers(0, 2 ** 32, (P, 8),
                                         dtype=np.uint32)),
        kf_pose=jnp.asarray(np.stack([_pose(rng) for _ in range(K)])),
        kf_valid=jnp.asarray(rng.random(K) < 0.8),
        n_pt=jnp.int32(n_pt), n_kf=jnp.int32(K - 2))
    return cj, _cfg(tcfg, K=K, P=P, N=N), m


def _pose(rng):
    w = rng.standard_normal(3) * 0.3
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    T[:3, 3] = rng.standard_normal(3)
    return T


def test_add_foreign_points_bit_equal_past_capacity(rng):
    cj, ct, m = _small_maps(rng)
    n = 32
    need = rng.random(n) < 0.7          # ~22 new points, 14 slots left
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    jm, jid = jcoop._add_foreign_points(cj, m, jnp.asarray(pos),
                                        jnp.asarray(desc),
                                        jnp.asarray(need), m.n_kf)
    tm, tid = tcoop._add_foreign_points(ct, to_torch(m), _t(pos), _t(desc),
                                        _t(need), to_torch(m).n_kf)
    assert int(need.sum()) > 14 and int((np.asarray(jid) < 0).sum()) > 0
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    assert tid.dtype == torch.int32
    for k, v in tm._asdict().items():
        np.testing.assert_array_equal(v.numpy(), _np(getattr(jm, k)),
                                      err_msg=k)
    assert int(tm.n_pt) == 64


def test_apply_sim3_to_component(rng):
    cj, ct, m = _small_maps(rng)
    R = _pose(rng)[:3, :3]
    s, t = np.float32(1.37), rng.standard_normal(3).astype(np.float32)
    kf_mask = rng.random(6) < 0.5
    pt_mask = rng.random(64) < 0.5
    jm = jcoop._apply_sim3_to_component(
        cj, m, jnp.float32(s), jnp.asarray(R), jnp.asarray(t),
        jnp.asarray(kf_mask), jnp.asarray(pt_mask))
    tm = tcoop._apply_sim3_to_component(
        ct, to_torch(m), torch.tensor(s), _t(R), _t(t), _t(kf_mask),
        _t(pt_mask))
    np.testing.assert_allclose(tm.kf_pose.numpy(), np.asarray(jm.kf_pose),
                               atol=1e-5)
    np.testing.assert_allclose(tm.pt_pos.numpy(), np.asarray(jm.pt_pos),
                               atol=1e-5)
    keep = ~pt_mask
    np.testing.assert_array_equal(tm.pt_pos.numpy()[keep],
                                  np.asarray(m.pt_pos)[keep])


def test_backend_post_insert_matches_reference(agents, exp):
    """One foreign keyframe's back-end pass on the merge asset's map."""
    ja, ta = agents
    k = int(exp["merge_foreign_kf"])
    jr = jlm.backend_post_insert(JC, ja.map, jnp.asarray(k))
    tr = tlm.backend_post_insert(TC, ta.map, torch.tensor(k))
    np.testing.assert_allclose(tr.kf_pose.numpy(), np.asarray(jr.kf_pose),
                               atol=1e-4)
    np.testing.assert_allclose(tr.pt_pos.numpy(), np.asarray(jr.pt_pos),
                               atol=1e-3)
    obs_t, obs_j = tr.kf_obs_pt.numpy(), np.asarray(jr.kf_obs_pt)
    assert (obs_t != obs_j).mean() <= 0.005
    np.testing.assert_array_equal(tr.pt_valid.numpy(), np.asarray(jr.pt_valid))
    np.testing.assert_array_equal(tr.kf_valid.numpy(), np.asarray(jr.kf_valid))
    assert int(tr.n_pt) == int(jr.n_pt) > int(ja.map.n_pt)


def _two_packets(agent, pack):
    """Two keyframes of agent 1's sub-map as packets of a third agent (2):
    they share sender landmarks (their landmark ids)."""
    p1 = pack(agent.map, 9, 2)
    p2 = pack(agent.map, 10, 2)
    shared = np.intersect1d(p1.pt_id[p1.pt_flag], p2.pt_id[p2.pt_flag])
    assert len(shared) > 50
    return p1, p2


def test_integrate_packets_bit_equal():
    ja, ta = jax_agent(), port_agent()
    ks = []
    pkts = list(zip(_two_packets(ja, jcoop.pack_keyframe),
                    _two_packets(ta, tcoop.pack_keyframe)))
    for p_j, p_t in pkts:
        kj = ja._integrate_packet(p_j, full_backend=False)
        kt = ta._integrate_packet(p_t, full_backend=False)
        assert kt == kj
        ks.append(kt)
    assert ta._foreign_pt == ja._foreign_pt
    np.testing.assert_array_equal(ta.pt_agent, ja.pt_agent)
    np.testing.assert_array_equal(ta.kf_agent, ja.kf_agent)
    assert ta._host_n_kf == ja._host_n_kf and ta._host_n_pt == ja._host_n_pt
    for k, v in ta.map._asdict().items():
        np.testing.assert_array_equal(v.numpy(), _np(getattr(ja.map, k)),
                                      err_msg=k)
    np.testing.assert_allclose(ta.db.bows, ja.db.bows, atol=1e-6)
    # dedup: the sender landmarks the two packets share got one slot each,
    # which both new keyframes observe
    p1, p2 = pkts[0][1], pkts[1][1]
    shared = np.intersect1d(p1.pt_id[p1.pt_flag], p2.pt_id[p2.pt_flag])
    slots = {ta._foreign_pt[(2, int(i))] for i in shared}
    assert len(slots) == len(shared)
    for k in ks:
        assert slots <= set(ta.map.kf_obs_pt[k].tolist())


def test_integrate_aligned_packet_bit_equal(exp):
    """A packet of an aligned sender is moved into the local frame on
    arrival by the stored Sim3: a foreign keyframe of the asset (in the
    sender's frame) sent again as a third agent's, whose alignment is the
    JAX run's S_w.  Without the back-end pass (held by
    test_backend_post_insert_matches_reference) the result is exact."""
    ja, ta = jax_agent(), port_agent()
    sim = (float(exp["merge_s"]), exp["merge_R"], exp["merge_t"])
    for a in (ja, ta):
        a._agent_sim3[2] = sim
        a._foreign_agents.add(2)
    kj = ja._integrate_packet(jcoop.pack_keyframe(ja.map, 9, 2),
                              full_backend=False)
    kt = ta._integrate_packet(tcoop.pack_keyframe(ta.map, 9, 2),
                              full_backend=False)
    assert kt == kj
    for k, v in ta.map._asdict().items():
        np.testing.assert_array_equal(v.numpy(), _np(getattr(ja.map, k)),
                                      err_msg=k)
    # the keyframe's centre is the sender-frame centre under S_w
    c = _centres(ta.map.kf_pose.numpy())
    s_, R_, t_ = sim
    np.testing.assert_allclose(c[kt], s_ * R_ @ c[9] + t_, atol=1e-5)
    np.testing.assert_array_equal(ta.pt_agent, ja.pt_agent)


def test_remap_after_compact_matches_reference():
    ja, ta = jax_agent(), port_agent()
    for p_j, p_t in zip(_two_packets(ja, jcoop.pack_keyframe),
                        _two_packets(ta, tcoop.pack_keyframe)):
        ja._integrate_packet(p_j, full_backend=False)
        ta._integrate_packet(p_t, full_backend=False)
    ja._kf_sent[[1, 4, 6]] = True
    ta._kf_sent[[1, 4, 6]] = True
    # cull some keyframes and points in both, then compact
    kf_drop = np.array([2, 5, 11])
    pt_drop = np.arange(0, 2000, 7)
    jm = ja.map._replace(
        kf_valid=ja.map.kf_valid.at[jnp.asarray(kf_drop)].set(False),
        pt_valid=ja.map.pt_valid.at[jnp.asarray(pt_drop)].set(False))
    kv, pv = ta.map.kf_valid.clone(), ta.map.pt_valid.clone()
    kv[kf_drop], pv[pt_drop] = False, False
    tm = ta.map._replace(kf_valid=kv, pt_valid=pv)
    jn, jk, jp = jcomp.compact(JC, jm)
    tn, tk, tp = tcomp.compact(TC, tm)
    np.testing.assert_array_equal(tk, np.asarray(jk))
    np.testing.assert_array_equal(tp, np.asarray(jp))
    ja._remap_after_compact(jm, jn, np.asarray(jk), np.asarray(jp))
    ta._remap_after_compact(tm, tn, tk, tp)
    np.testing.assert_array_equal(ta.kf_agent, ja.kf_agent)
    np.testing.assert_array_equal(ta.pt_agent, ja.pt_agent)
    np.testing.assert_array_equal(ta._kf_sent, ja._kf_sent)
    assert ta._foreign_pt == ja._foreign_pt
    assert (ta.kf_agent >= 0).sum() == int(np.asarray(jn.n_kf))


def _inject(agent, exp, prefix):
    """The JAX call's draws, and a log of the (foreign keyframe, candidate)
    pairs the agent verifies: the last one before a verified alignment
    returns is its candidate."""
    for p, d in zip(exp[f"{prefix}_draw_pairs"], exp[f"{prefix}_draws"]):
        agent.cross_sim3_draws[(int(p[0]), int(p[1]))] = d
    tried = []
    inner = agent._cross_draws

    def draws(fk, cand):
        tried.append((fk, cand))
        return inner(fk, cand)

    agent._cross_draws = draws
    return tried


def test_per_frame_insert_that_compacts_tags_and_publishes_its_keyframe():
    """A CoopAgent's per-frame keyframe insert whose capacity watermark
    compacts culled keyframe slots away (tests/test_torch_lifecycle.py's
    configuration at K=6, with keyframe culling at 0.3 redundancy so that
    culled slots exist when the watermark fires, frames 0-17): the new own
    keyframe is tagged with the agent's id in the slot it got after the
    compaction, and `drain_packets` publishes it."""
    from coslam_tpu_torch.utils import synthetic

    cfg = tcfg.SystemConfig(
        camera=tcfg.CameraConfig(fx=260, fy=260, cx=160, cy=120, width=320,
                                 height=240),
        extractor=tcfg.ExtractorConfig(n_features=300, max_keypoints=256),
        mapper=tcfg.MapperConfig(max_keyframes=6, max_points=2048,
                                 triangulation_neighbors=4,
                                 kf_culling_redundancy=0.3),
        tracker=tcfg.TrackerConfig(init_min_matches=50, init_min_good=30))
    traj = synthetic.make_trajectory(40, seed=7)
    seq = synthetic.render_sequence(cfg.camera, traj,
                                    synthetic.make_scene(500, seed=7))
    a = tcoop.CoopAgent(cfg, agent_id=3, device="cpu")
    shrunk = []
    ensure = a._ensure_capacity

    def spy(*args, **kw):
        n_kf = a._host_n_kf
        pt_map = ensure(*args, **kw)
        if a._host_n_kf < n_kf:
            shrunk.append((n_kf, a._host_n_kf))
        return pt_map

    a._ensure_capacity = spy
    for i in range(18):
        a.track_mono(seq[i], i)
        if shrunk:
            break
    assert shrunk, "no per-frame insert compacted keyframe slots away"
    assert a.stats[-1].get("keyframe")
    n_kf = a._host_n_kf
    assert n_kf == shrunk[0][1] + 1
    assert a.kf_agent[n_kf - 1] == 3
    kf_valid = a.map.kf_valid[:n_kf].cpu().numpy()
    np.testing.assert_array_equal(a.kf_agent[:n_kf][kf_valid], 3)
    sent = [p.frame_id for p in a.drain_packets(max_batch=n_kf)]
    assert a.stats[-1]["frame"] in sent and len(sent) == kf_valid.sum()


def test_cross_sim3_on_the_jax_state(exp):
    """The verification of the JAX run's merging call, its draws injected:
    the same foreign keyframe merges against the same candidate, S_w at
    phase 10 (a)'s windows."""
    ta = port_agent()
    tried = _inject(ta, exp, "merge")
    fk = int(exp["merge_foreign_kf"])
    found = ta._find_cross_sim3(fk)
    assert found is not None
    assert tried[-1] == (fk, int(exp["merge_candidate"]))
    S_w, _p1, _p2, pairs = found
    n, n_exp = int(pairs.sum()), int(exp["merge_n_inliers"])
    assert abs(n - n_exp) <= max(3, 0.05 * n_exp), (n, n_exp)
    kv = ta.map.kf_valid.numpy()
    c = _centres(ta.map.kf_pose.numpy())[kv]
    extent = float(np.linalg.norm(c - c.mean(0), axis=1).max())
    assert abs(float(S_w["s"]) / float(exp["merge_s"]) - 1) <= 1e-3
    assert _rot_err_deg(S_w["R"].numpy().astype(np.float64),
                        exp["merge_R"].astype(np.float64)) <= 0.1
    assert np.abs(S_w["t"].numpy() - exp["merge_t"]).max() <= 1e-3 * extent


def test_try_merge_on_the_conditioned_jax_state(exp):
    """The whole merging call (alignment, global BA, back-end passes, the
    residual sweep, the closing global BA) on the JAX state with the
    runaway landmarks removed, against the JAX package's call there."""
    drop = exp["cond_runaway_pts"]
    ta = port_agent(drop)
    tried = _inject(ta, exp, "cond")
    fk = int(exp["merge_foreign_kf"])
    firsts = []
    inner = ta._find_cross_sim3

    def find(k):
        out = inner(k)
        firsts.append((k, out, tried[-1] if tried else None))
        return out

    ta._find_cross_sim3 = find
    assert ta._try_merge(fk, 1)
    assert firsts[0][2] == (fk, int(exp["cond_candidate"]))
    S_w, _p1, _p2, pairs = firsts[0][1]
    n_exp = int(exp["cond_n_inliers"])
    assert abs(int(pairs.sum()) - n_exp) <= max(3, 0.05 * n_exp)
    assert abs(float(S_w["s"]) / float(exp["cond_s"]) - 1) <= 1e-3
    assert [(k, out is not None) for k, out, _c in firsts[1:]] == \
        [(int(k), bool(v)) for k, _c, v in exp["cond_realigns"]]
    assert ta.n_merges == int(exp["cond_n_merges_after"])
    assert ta.merged_agents == {1: True}
    kv = exp["cond_kf_valid_after"]
    n = len(kv)
    np.testing.assert_array_equal(ta.map.kf_valid.numpy()[:n], kv)
    c_exp = _centres(exp["cond_kf_pose_after"])[kv]
    extent = float(np.linalg.norm(c_exp - c_exp.mean(0), axis=1).max())
    err = np.linalg.norm(_centres(ta.map.kf_pose.numpy()[:n])[kv] - c_exp,
                         axis=1).max()
    assert err <= 5e-3 * extent, (err, extent)


def test_merged_receive_packet_runs_the_loop_closer():
    """After the merge, a received keyframe goes through the back-end pass
    and then the loop closer's `on_keyframe` (when the receiver runs loop
    closing) before the re-alignment."""
    ta = port_agent()
    ta2 = tcoop.CoopAgent(TC, 0, device="cpu", enable_loop_closing=True)
    tckpt.load_coop_state(MERGE, ta2)
    assert ta2.loop_closer is not None
    ta2.merged_agents[2] = True
    ta2._agent_sim3[2] = (1.0, np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32))
    calls = []
    inner = ta2.loop_closer.on_keyframe

    def on_keyframe(m, k, covis_row=None):
        calls.append(k)
        return inner(m, k, covis_row=covis_row)

    ta2.loop_closer.on_keyframe = on_keyframe
    realigned = []
    ta2._try_realign = lambda k, aid: realigned.append((k, aid)) or False
    pkt = tcoop.pack_keyframe(ta.map, 9, 2)
    assert ta2.receive_packet(pkt) is False
    k = ta2._host_n_kf - 1
    assert calls == [k] and realigned == [(k, 2)]
    assert ta2.kf_agent[k] == 2 and ta2.n_merges == 0


def test_coop_agent_needs_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcoop.CoopAgent(_cfg(tcfg, K=4, P=256, N=128))
    assert tcoop.CoopAgent(_cfg(tcfg, K=4, P=256, N=128),
                           device="cpu").device.type == "cpu"


def test_in_memory_bus_matches_reference():
    pkts = ["a", "b"]
    jb, tb = jcoop.InMemoryBus(), tcoop.InMemoryBus()
    for b in (jb, tb):
        b.publish(1, pkts, subscribers=[0, 1, 2])
    assert tb.queues == jb.queues
    assert tb.drain(0) == jb.drain(0) == pkts
    assert tb.drain(0) == jb.drain(0) == []
    assert tb.drain(1) == jb.drain(1) == []


def _port_coop(ref, jax_init=False):
    """The port's two-agent run on the CPU, the JAX run's initialisation
    draws and cross-agent Sim3 draws injected (each pair's in the JAX
    run's order); with `jax_init` each agent's initialisation attempts
    before the JAX run's initialisation frame are skipped.  Returns (own,
    foreign, merges, joint ATE)."""
    from coslam_tpu_torch import cli
    from coslam_tpu_torch.utils import evaluation

    cfg, traj, seq, split0, start1 = cli._coop_setup(
        assets.COOP_FRAMES, assets.COOP_SEED, TC.camera, TC.extractor)
    cfg = cfg.replace(tracker=TC.tracker)
    agents = []
    for aid, tag in ((0, "r"), (1, "s")):
        a = tcoop.CoopAgent(cfg, aid, device="cpu", enable_loop_closing=False)
        a.init_draws = {int(f): d.astype(np.int64) for f, d in
                        zip(ref[f"{tag}_draw_frames"], ref[f"{tag}_draws"])}
        if jax_init:
            first, inner = int(ref[f"{tag}_init_frame"]), a._try_initialize
            a._try_initialize = (
                lambda f, fid, a=a, first=first, inner=inner:
                inner(f, fid) if a.ref_frame is None or fid >= first
                else None)
        agents.append(a)
    a0, a1 = agents
    queue = {}
    for p, d in zip(ref["run_draw_pairs"], ref["run_draws"]):
        queue.setdefault((int(p[0]), int(p[1])), []).append(d)
    inner_draws = a0._cross_draws

    def draws(fk, cand):
        if queue.get((fk, cand)):
            a0.cross_sim3_draws[(fk, cand)] = queue[(fk, cand)].pop(0)
        else:
            a0.cross_sim3_draws.pop((fk, cand), None)
        return inner_draws(fk, cand)

    a0._cross_draws = draws
    cli.drive_coop(a0, a1, seq, split0, start1, tcoop.InMemoryBus())
    for a in (a0, a1):
        assert a.state == "OK"
        assert not any(st.get("lost") for st in a.stats)
    K = int(a0.map.n_kf)
    valid = a0.map.kf_valid[:K].numpy()
    agent = a0.kf_agent[:K]
    fid = a0.map.kf_frame_id[:K].numpy()
    c = tms.kf_centers(a0.map).numpy()[:K]
    gt = evaluation.trajectory_xyz(traj.poses_cw[fid])
    return (int((valid & (agent == 0)).sum()),
            int((valid & (agent == 1)).sum()), a0.n_merges,
            float(evaluation.ate_rmse(c[valid], gt[valid])))


@pytest.mark.slow
def test_two_agents_against_the_jax_run(tmp_path):
    """The whole two-agent workload in both packages on the CPU: the JAX
    run (scripts/make_torch_smoke_assets.coop_reference, which records its
    draws), then the port from the first frame, as chip_smoke.py phase 10
    (b) runs it: on its own initialisation decisions (both agents OK with
    no lost frame, a merge, joint ATE below the CLI's 0.3), and with each
    agent's attempts before the JAX run's initialisation frame skipped,
    where it is also held to foreign keyframes within max(2, 15%) and
    joint ATE at most 0.03 above the JAX run's.  Whether an attempt before
    that frame passes rests on f32 rounding in the reference's two-view
    gates (scripts/trace_coop_init.py: on the CPU the port's receiver
    initialises at frame 1, a parallax cosine of 0.9997810 against the
    reference's 0.9998114 and the gate's 0.9998).  Slow: the JAX run alone
    takes ~115 s on the CPU, each port run ~4 min."""
    assets.coop_reference(out_dir=str(tmp_path))
    with np.load(tmp_path / "smoke_coop_expected.npz") as z:
        ref = {k: z[k] for k in z.files}
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        _own, _foreign, merges, ate = _port_coop(ref)
        assert merges >= 1 and ate < 0.3
        _own, foreign, merges, ate = _port_coop(ref, jax_init=True)
    finally:
        torch.set_num_threads(threads)
    f_exp = int(ref["kf_foreign"])
    assert merges >= 1
    assert abs(foreign - f_exp) <= max(2, 0.15 * f_exp), (foreign, f_exp)
    assert ate <= float(ref["ate"]) + 0.03 and ate < 0.3, ate

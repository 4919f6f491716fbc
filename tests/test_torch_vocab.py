"""Online vocabulary training (port of coslam_tpu/ops/bow.py's
`train_vocabulary`, `train_vocabulary_device`, `bow_rows` and
`KeyFrameDatabase.maybe_retrain`) against coslam_tpu.

The device k-means seeds its words from `jax.random.permutation(
PRNGKey(0), n)`; the port takes that permutation as an argument.  With it
the words are bit-equal: the assignment distances are integers computed
exactly in f32 (0/1 products), and so are the centroid sums and counts.
BoW rows within 1e-6."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models.system import System as JSystem
from coslam_tpu.ops import bow as jbow
from coslam_tpu.utils import synthetic
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import keyframe_db as tkdb
from coslam_tpu_torch.models import map_state as tms
from coslam_tpu_torch.ops import bow as tbow

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_torch_smoke_assets as assets  # noqa: E402

# see tests/torch_mapping_common.py: one intra-op thread per xdist worker
torch.set_num_threads(1)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _pool(rng, n, n_proto=40, flip=0.08):
    """Descriptors clustered round prototypes (as real ones are), with
    every tenth row invalid."""
    proto = rng.integers(0, 2 ** 32, (n_proto, 8), dtype=np.uint32)
    bits = np.unpackbits(proto[rng.integers(0, n_proto, n)].view(np.uint8),
                         axis=1)
    bits ^= (rng.random(bits.shape) < flip).astype(np.uint8)
    desc = np.packbits(bits, axis=1).view(np.uint32)
    valid = np.arange(n) % 10 != 3
    return desc, valid


def test_train_vocabulary_host_is_the_reference(rng):
    desc, _ = _pool(rng, 3000)
    np.testing.assert_array_equal(
        tbow.train_vocabulary(desc, n_words=64, iters=4, seed=5),
        jbow.train_vocabulary(desc, n_words=64, iters=4, seed=5))


@pytest.mark.parametrize("n_words", [64, 256])
def test_train_vocabulary_device_bit_equal(rng, n_words):
    """With the reference's permutation injected the words are equal bit
    for bit (some words end empty at 256 and keep their seed)."""
    desc, valid = _pool(rng, 4096)
    jw = np.asarray(jbow.train_vocabulary_device(
        jnp.asarray(desc), jnp.asarray(valid), n_words, 6))
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(0), 4096))
    tw = tbow.train_vocabulary_device(_t(desc), _t(valid), n_words, 6,
                                      perm=perm)
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), jw)
    # without the permutation: a vocabulary of the same shape and kind,
    # the same on every call (a generator seeded 0)
    tw2 = tbow.train_vocabulary_device(_t(desc), _t(valid), n_words, 6)
    assert tw2.shape == (n_words, 8) and tw2.dtype == torch.int32
    assert torch.equal(
        tw2, tbow.train_vocabulary_device(_t(desc), _t(valid), n_words, 6))


def test_bow_rows(rng):
    desc, _ = _pool(rng, 6 * 256)
    desc = desc.reshape(6, 256, 8)
    valid = rng.random((6, 256)) < 0.8
    vocab = rng.integers(0, 2 ** 32, (128, 8), dtype=np.uint32)
    jr = np.asarray(jbow.bow_rows(jnp.asarray(desc), jnp.asarray(valid),
                                  jnp.asarray(vocab), 128))
    tr = tbow.bow_rows(_t(desc), _t(valid), _t(vocab), 128)
    np.testing.assert_allclose(tr.numpy(), jr, atol=1e-6)


def _cfg(mod):
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640,
                                height=480),
        extractor=mod.ExtractorConfig(n_features=500, max_keypoints=512),
        tracker=mod.TrackerConfig(mapper_latency_frames=3),
        mapper=mod.MapperConfig(max_keyframes=32, max_points=4096),
        loop=mod.LoopConfig(vocab_pretrained=False, vocab_words=256))


def test_maybe_retrain_on_a_reference_map():
    """The reference System maps without a pretrained vocabulary and
    retrains at its 4th keyframe; the port's database, given the same rows
    and map and the reference's permutation, retrains there too: the same
    words, every stored row within 1e-6, the tf-idf cache invalidated.  At
    other counts of added keyframes it leaves everything as it is."""
    jc = _cfg(jcfg)
    scene = synthetic.make_scene(600, seed=3)
    traj = synthetic.make_trajectory(36, seed=3)
    seq = synthetic.render_sequence(jc.camera, traj, scene)[:20]
    js = JSystem(jc, enable_loop_closing=False)
    js.db = assets.RetrainRecordingDB(jc)
    js.run_sequence(seq)
    rec = js.db.retrains[0]
    assert rec["n_added"] == 4

    db = tkdb.KeyFrameDatabase(_cfg(tcfg), device="cpu")
    assert not db._external_vocab
    db.bows, db.has = rec["bows"].copy(), rec["has"].copy()
    db.vocab = _t(rec["vocab"])
    tm = tms.MapState(**{k: _t(v) for k, v in rec["map"]._asdict().items()})
    K, N = tm.kf_obs_pt.shape
    db._n_added = 3
    db.maybe_retrain(tm)                         # not a milestone
    np.testing.assert_array_equal(db.vocab.numpy().view(np.uint32),
                                  rec["vocab"])
    db._n_added = 4
    db.retrain_perms[4] = np.asarray(
        jax.random.permutation(jax.random.PRNGKey(0), K * N))
    w_before = db._tfidf_weights()[1].copy()
    db.maybe_retrain(tm)
    np.testing.assert_array_equal(db.vocab.numpy().view(np.uint32),
                                  rec["words"])
    np.testing.assert_allclose(db.bows, rec["bows_after"], atol=1e-6)
    assert db._w_cache[0] != db._version
    assert not np.allclose(db._tfidf_weights()[1], w_before)

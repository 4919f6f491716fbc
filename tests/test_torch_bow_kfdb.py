"""ops/bow and models/keyframe_db: the port against coslam_tpu.

Bars: word ids exact (the +/-1 Hamming matmul is exact in f32, ties go to
the lowest word id in both); BoW rows and L1 scores within 1e-6; the
database's rows, flags and tf-idf scores equal after add / add_row /
remap / grow (host numpy in both packages)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models import keyframe_db as jkdb
from coslam_tpu.models import map_state as jms
from coslam_tpu.ops import bow as jbow
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import keyframe_db as tkdb
from coslam_tpu_torch.models import map_state as tms
from coslam_tpu_torch.ops import bow as tbow


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def test_vocabulary_is_the_reference_file():
    v = tbow.load_pretrained_vocabulary()
    np.testing.assert_array_equal(v, jbow.load_pretrained_vocabulary())
    assert v.shape == (8192, 8)
    np.testing.assert_array_equal(tbow.synthetic_default_vocabulary(64),
                                  jbow.synthetic_default_vocabulary(64))


@pytest.mark.parametrize("n", [1024, 57])
def test_assign_words_and_bow_vector(rng, n):
    vocab = tbow.load_pretrained_vocabulary()
    desc = _desc(rng, n)
    # plant exact copies of words and near-ties
    desc[:20] = vocab[rng.integers(0, len(vocab), 20)]
    desc[20:40] = vocab[:20] ^ np.uint32(1)
    valid = rng.uniform(size=n) > 0.2
    jw = np.asarray(jbow.assign_words(jnp.asarray(desc), jnp.asarray(valid),
                                      jnp.asarray(vocab)))
    tw = tbow.assign_words(_t(desc), torch.from_numpy(valid), _t(vocab))
    np.testing.assert_array_equal(tw.numpy(), jw)
    jv = np.asarray(jbow.bow_vector(jnp.asarray(jw), jnp.asarray(valid),
                                    len(vocab)))
    tv = tbow.bow_vector(tw, torch.from_numpy(valid), len(vocab))
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-6)
    db = rng.uniform(size=(6, len(vocab))).astype(np.float32)
    np.testing.assert_allclose(
        tbow.l1_scores(tv, torch.from_numpy(db)).numpy(),
        np.asarray(jbow.l1_scores(jnp.asarray(jv), jnp.asarray(db))),
        atol=1e-5)


def _cfgs(K=8):
    return (jcfg.SystemConfig(mapper=jcfg.MapperConfig(max_keyframes=K)),
            tcfg.SystemConfig(mapper=tcfg.MapperConfig(max_keyframes=K)))


def test_database_add_remap_grow_and_scores(rng):
    jc, tc = _cfgs()
    jdb = jkdb.KeyFrameDatabase(jc)
    tdb = tkdb.KeyFrameDatabase(tc, device="cpu")
    assert jdb.n_words == tdb.n_words == 8192
    assert tdb._external_vocab and jdb._external_vocab
    for k in range(6):
        desc = _desc(rng, 256)
        valid = rng.uniform(size=256) > 0.1
        if k % 2:
            jdb.add(k, jnp.asarray(desc), jnp.asarray(valid))
            tdb.add(k, _t(desc), torch.from_numpy(valid))
        else:
            row = np.asarray(jdb.compute_bow(jnp.asarray(desc),
                                             jnp.asarray(valid)))
            np.testing.assert_allclose(
                tdb.compute_bow(_t(desc), torch.from_numpy(valid)), row,
                atol=1e-6)
            jdb.add_row(k, row)
            tdb.add_row(k, row)
    np.testing.assert_allclose(tdb.bows, jdb.bows, atol=1e-6)
    np.testing.assert_array_equal(tdb.has, jdb.has)
    for k in (0, 3):
        np.testing.assert_allclose(tdb.scores_against_all(k),
                                   jdb.scores_against_all(k), atol=1e-5)
    q = jdb.bows[2] * 0.5 + jdb.bows[4] * 0.5
    np.testing.assert_allclose(tdb.scores_for_bow(q), jdb.scores_for_bow(q),
                               atol=1e-5)
    kf_map = np.array([0, -1, 1, 2, -1, 3, -1, -1], np.int32)
    jdb.remap(kf_map, 8)
    tdb.remap(kf_map, 8)
    jdb.grow(16)
    tdb.grow(16)
    np.testing.assert_allclose(tdb.bows, jdb.bows, atol=1e-6)
    np.testing.assert_array_equal(tdb.has, jdb.has)
    np.testing.assert_allclose(tdb.scores_against_all(1),
                               jdb.scores_against_all(1), atol=1e-5)


def test_retraining_raises_only_where_the_reference_retrains(rng):
    """Without a pretrained vocabulary the reference retrains at
    vocab_retrain_at milestones; the port retrains exactly there (the
    retrain itself is held to the reference in tests/test_torch_vocab.py),
    and a pretrained vocabulary is never retrained."""
    loop = tcfg.LoopConfig(vocab_pretrained=False, vocab_words=64)
    cfg = tcfg.SystemConfig(
        extractor=tcfg.ExtractorConfig(max_keypoints=512),
        mapper=tcfg.MapperConfig(max_keyframes=8, max_points=64), loop=loop)
    jconf = jcfg.SystemConfig(
        extractor=jcfg.ExtractorConfig(max_keypoints=512),
        mapper=jcfg.MapperConfig(max_keyframes=8, max_points=64),
        loop=jcfg.LoopConfig(vocab_pretrained=False, vocab_words=64))
    db = tkdb.KeyFrameDatabase(cfg, device="cpu")
    jdb = jkdb.KeyFrameDatabase(jconf)
    assert not db._external_vocab and db.n_words == 64
    desc = rng.integers(0, 2 ** 32, (8, 512, 8), dtype=np.uint32)
    m = tms.empty_map(cfg, device="cpu")
    m = m._replace(kf_valid=torch.ones(8, dtype=torch.bool),
                   kf_kp_valid=torch.ones((8, 512), dtype=torch.bool),
                   kf_desc=torch.from_numpy(desc.view(np.int32)))
    jm = jms.empty_map(jconf)
    jm = jm._replace(kf_valid=jnp.ones(8, bool),
                     kf_kp_valid=jnp.ones((8, 512), bool),
                     kf_desc=jnp.asarray(desc))
    retrained, j_retrained = [], []
    for k in range(5):
        db.add_row(k, np.zeros(64, np.float32))
        jdb.add_row(k, np.zeros(64, np.float32))
        before = (db.vocab.clone(), np.asarray(jdb.vocab).copy())
        db.maybe_retrain(m)
        jdb.maybe_retrain(jm)
        if not torch.equal(db.vocab, before[0]):
            retrained.append(k + 1)
        if not np.array_equal(np.asarray(jdb.vocab), before[1]):
            j_retrained.append(k + 1)
    assert retrained == j_retrained == [4]      # keyframes added
    # the rows stored before the milestone were recomputed under the new
    # words
    assert np.abs(db.bows[:4].sum(1) - 1).max() < 1e-5
    pre = tkdb.KeyFrameDatabase(tcfg.SystemConfig(
        mapper=tcfg.MapperConfig(max_keyframes=8)), device="cpu")
    vocab0 = pre.vocab.clone()
    for k in range(4):
        pre.add_row(k, np.zeros(pre.n_words, np.float32))
    pre.maybe_retrain(m)               # pretrained: never retrains
    assert torch.equal(pre.vocab, vocab0)

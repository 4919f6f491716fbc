"""coslam_tpu_torch.scripts.train_vocab and the port's own vocabulary file
against the JAX side's scripts/train_vocab.py (loaded from its file; nothing
of it is changed).

Bars: the port's assets/vocab.npz has the JAX package's file's sha256 (so a
retrain cannot quietly change what the parity gates compare) and is what
`load_pretrained_vocabulary` reads; the harvest of small jobs (320x240, 4
frames each) against the JAX script's `build_frame` loop: valid masks equal,
>= 99.9% of descriptor bits (tests/test_torch_orb.py's bar); the script's
subsample and training at 4096 descriptors / 256 words / 3 iterations on the
JAX pool with the JAX run's PRNGKey(0) permutation injected: the written
words and the printed occupancy equal."""

import hashlib
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu import config as jcfg
from coslam_tpu.models import frame as jframe
from coslam_tpu.utils import synthetic as jsyn
from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.ops import bow as tbow
from coslam_tpu_torch.scripts import train_vocab as ttv
from coslam_tpu_torch.utils import synthetic as tsyn

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_torch_smoke_assets as assets  # noqa: E402

# see tests/torch_mapping_common.py: one intra-op thread per xdist worker
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS, ITERS, MAX_DESC = 256, 3, 4096


def _cfg(mod):
    return mod.SystemConfig(
        camera=mod.CameraConfig(fx=200, fy=200, cx=160, cy=120, width=320,
                                height=240),
        extractor=mod.ExtractorConfig(n_features=1000, max_keypoints=1024))


def _jobs(syn):
    """Three small jobs of the script's kinds: box clouds on arcs, a
    cylinder on a loop; 8 frames each, every second one harvested."""
    return [(syn.make_scene(700, seed=3), syn.make_trajectory(8, seed=3)),
            (syn.make_scene(700, seed=5), syn.make_trajectory(8, seed=5)),
            (syn.make_cylinder_scene(900, seed=11),
             syn.make_loop_trajectory(8, seed=11, frac=1.0))]


def _bits(desc: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(desc).view(np.uint8), axis=1)


@pytest.fixture(scope="module")
def jax_harvest():
    """The JAX script's harvest loop (scripts/train_vocab.py:52-57) on the
    small jobs: per frame (desc, valid), and the pool."""
    cfg = _cfg(jcfg)
    frames = []
    for scene, traj in _jobs(jsyn):
        seq = jsyn.render_sequence(cfg.camera, traj, scene)
        for img in seq[::2]:
            f = jframe.build_frame(jnp.asarray(img), cfg)
            frames.append(jax.device_get((f.desc, f.valid)))
    return frames, np.concatenate([d[v] for d, v in frames])


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_the_port_ships_the_jax_vocabulary():
    path = tbow.pretrained_vocabulary_path()
    ref = os.path.join(ROOT, "coslam_tpu", "assets", "vocab.npz")
    assert os.path.normpath(path) == os.path.join(
        ROOT, "coslam_tpu_torch", "assets", "vocab.npz")
    assert _sha256(path) == _sha256(ref)
    words = tbow.load_pretrained_vocabulary()
    with np.load(ref) as z:
        np.testing.assert_array_equal(words, z["words"])
        assert words.shape == (8192, 8) and words.dtype == np.uint32
        assert z["meta"].tolist() == [8192, 12, 0]


def test_harvest_matches_the_jax_build_frame_loop(jax_harvest):
    frames, jpool = jax_harvest
    cfg = _cfg(tcfg)
    i = 0
    for scene, traj in _jobs(tsyn):
        desc, valid = ttv.job_descriptors(cfg, scene, traj, 2, "cpu")
        assert desc.shape[0] == len(traj.poses_cw[::2]) == 4
        for d, v in zip(desc.numpy(), valid.numpy()):
            jd, jv = frames[i]
            np.testing.assert_array_equal(v, jv)
            agree = (_bits(d[v]) == _bits(jd[jv].view(np.int32))).mean()
            assert agree >= 0.999, (i, agree)
            i += 1
    pool = ttv.harvest(cfg, _jobs(tsyn), 2, "cpu")
    assert pool.dtype == np.uint32 and pool.shape == jpool.shape
    assert pool.shape[0] > MAX_DESC


def _occupancy(text: str) -> str:
    return re.search(r"occupied \d+/\d+, max bucket \d+", text).group(0)


def test_subsample_and_training_match_the_jax_main(jax_harvest, tmp_path,
                                                   monkeypatch, capsys):
    """Both mains on the JAX pool: the JAX script's with its output
    redirected under tmp_path, the port's with the JAX run's permutation."""
    _, pool = jax_harvest
    jtv = assets.jax_script("train_vocab")
    monkeypatch.setattr(jtv, "harvest", lambda: pool)
    monkeypatch.setattr(jtv, "ROOT", str(tmp_path / "jax"))
    monkeypatch.setattr(sys, "argv", [
        "train_vocab.py", "--words", str(WORDS), "--iters", str(ITERS),
        "--max-desc", str(MAX_DESC)])
    jtv.main()
    jax_out = capsys.readouterr().out
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(0),
                                             MAX_DESC))

    monkeypatch.setattr(ttv, "harvest", lambda device: pool)
    out = str(tmp_path / "torch" / "vocab.npz")
    res = ttv.train_vocab(WORDS, ITERS, MAX_DESC, 0, "cpu", out, perm=perm)
    port_out = capsys.readouterr().out

    with np.load(tmp_path / "jax" / "coslam_tpu" / "assets"
                 / "vocab.npz") as j, np.load(out) as t:
        np.testing.assert_array_equal(t["words"], j["words"])
        np.testing.assert_array_equal(t["meta"], j["meta"])
    np.testing.assert_array_equal(res["words"], np.load(out)["words"])
    assert res["n_pool"] == MAX_DESC
    assert _occupancy(port_out) == _occupancy(jax_out)
    assert port_out.splitlines()[0].split(" (")[0] \
        == jax_out.splitlines()[0].split(" (")[0]

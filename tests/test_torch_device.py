"""The port's entry points run on the GPU unless the caller asks for the
CPU: with no device argument and no GPU they raise an error that names
device="cpu"; nothing falls back.  With device="cpu" they run as before."""

import numpy as np
import pytest
import torch

from coslam_tpu_torch import config as tcfg
from coslam_tpu_torch.models import keyframe_db as tkdb
from coslam_tpu_torch.models import loop_closing as tlc
from coslam_tpu_torch.models import map_state as tms
from coslam_tpu_torch.models.system import System
from coslam_tpu_torch.utils import checkpoint as tck
from coslam_tpu_torch.utils.device import resolve_device


def _cfg():
    return tcfg.SystemConfig(
        extractor=tcfg.ExtractorConfig(n_features=100, max_keypoints=128),
        mapper=tcfg.MapperConfig(max_keyframes=4, max_points=256))


@pytest.fixture()
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _saved_map(tmp_path):
    path = str(tmp_path / "m.npz")
    tck.save_map(path, tms.empty_map(_cfg(), device="cpu"))
    return path


ENTRY_POINTS = {
    "System": lambda tmp, **kw: System(_cfg(), **kw),
    "empty_map": lambda tmp, **kw: tms.empty_map(_cfg(), **kw),
    "KeyFrameDatabase": lambda tmp, **kw: tkdb.KeyFrameDatabase(_cfg(), **kw),
    "load_map": lambda tmp, **kw: tck.load_map(_saved_map(tmp), **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_gpu(no_gpu, tmp_path, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](tmp_path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](tmp_path, device="cuda")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_on_request(no_gpu, tmp_path, name):
    out = ENTRY_POINTS[name](tmp_path, device="cpu")
    if name == "System":
        assert out.device.type == "cpu"
        assert out.map.pt_pos.device.type == "cpu"
        assert out.db.vocab.device.type == "cpu"
        # and it runs: a blank frame is taken as an initialisation candidate
        out.track_mono(np.zeros((480, 640), np.uint8), 0)
        assert out.state == "NOT_INITIALIZED"
    elif name == "empty_map":
        assert out.pt_pos.device.type == "cpu" and int(out.n_kf) == 0
    elif name == "KeyFrameDatabase":
        assert out.vocab.device.type == "cpu"
    else:
        assert out[0].kf_pose.device.type == "cpu"


def test_resolve_device(no_gpu):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(torch.device("cuda", 0))


def _tensors(obj):
    """Every tensor reachable from an object's attributes (one level into
    tuples, lists and dicts)."""
    for v in vars(obj).values():
        items = v.values() if isinstance(v, dict) else \
            v if isinstance(v, (tuple, list)) else [v]
        for t in items:
            if isinstance(t, torch.Tensor):
                yield t


def test_loop_closer_stays_on_the_cpu(no_gpu):
    """The LoopCloser a System builds on device="cpu" holds no tensor
    elsewhere, shares the System's database, and what it computes on a CPU
    map (a keyframe too young for any candidate; the edge arrays it hands
    to correct_loop; a global BA) stays on the CPU."""
    s = System(_cfg(), device="cpu", enable_loop_closing=True)
    lc = s.loop_closer
    assert isinstance(lc, tlc.LoopCloser) and lc.db is s.db
    assert lc.sim3_draws is s.sim3_draws
    assert all(t.device.type == "cpu" for t in _tensors(lc))
    assert all(t.device.type == "cpu" for t in _tensors(s.db))
    m = s.map._replace(kf_valid=torch.ones(4, dtype=torch.bool))
    m2, closed = lc.on_keyframe(m, 3)
    assert m2 is m and not closed
    lc.loop_edges.append((3, 0))
    prev, valid = lc._prev_loop_arrays(s.device)
    assert prev.device.type == valid.device.type == "cpu"
    assert prev[0].tolist() == [3, 0] and valid.tolist()[:2] == [True, False]
    out = tlc.global_ba(s.cfg, m, iters=1)
    assert all(t.device.type == "cpu" for t in out)
    assert System(_cfg(), device="cpu",
                  enable_loop_closing=False).loop_closer is None

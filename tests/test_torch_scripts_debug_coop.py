"""coslam_tpu_torch.scripts.debug_coop.probe against the JAX side's
scripts/debug_coop.py `probe` (loaded from its file) on the JAX receiver's
saved state before its first merge (assets/smoke_coop_merge.npz, loaded into
both packages as tests/test_torch_cooperative.py loads it, each given a
loop closer): the printed line is equal, for the last foreign keyframe and
for the last own one.  There no keyframe has a BoW candidate, so the probe
also runs over every keyframe in turn of the JAX pr_quality run's end state
of cylinder-A (a 1.25-lap loop, assets/smoke_scripts_expected.npz) held by
an agent of each package: every printed line equal, match counts
included."""

import os
import sys

import numpy as np
import pytest
import torch

from coslam_tpu.models import cooperative as jcoop
from coslam_tpu.models import loop_closing as jlc
from coslam_tpu.utils import checkpoint as jckpt
from coslam_tpu_torch.models import cooperative as tcoop
from coslam_tpu_torch.models import loop_closing as tlc
from coslam_tpu_torch.scripts import debug_coop as tdc
from coslam_tpu_torch.scripts import pr_quality as tpq
from coslam_tpu_torch.utils import checkpoint as tckpt

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_cooperative as coop  # noqa: E402
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_torch_smoke_assets as assets  # noqa: E402

# see tests/torch_mapping_common.py: one intra-op thread per xdist worker
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jdc():
    return assets.jax_script("debug_coop")


def _agents():
    ja, ta = coop.jax_agent(), coop.port_agent()
    ja.loop_closer = jlc.LoopCloser(coop.JC, ja.db)
    ta.loop_closer = tlc.LoopCloser(coop.TC, ta.db)
    return ja, ta


@pytest.mark.parametrize("owner", ["foreign", "own"])
def test_probe_prints_the_jax_line(jdc, owner, capsys):
    ja, ta = _agents()
    n = ta._host_n_kf
    ids = [k for k in range(n)
           if (ta.kf_agent[k] == ta.agent_id) == (owner == "own")]
    k = ids[-1]
    assert ja.kf_agent[k] == ta.kf_agent[k]
    jdc.probe(ja, k)
    want = capsys.readouterr().out
    tdc.probe(ta, k)
    got = capsys.readouterr().out
    assert want.startswith(f"  [probe kf {k}] cooldown=")
    assert got == want


def test_probe_over_a_loop(jdc, tmp_path, capsys):
    ex = np.load(os.path.join(assets.ASSETS, assets.SCRIPTS_ASSET))
    path = str(tmp_path / "system.npz")
    np.savez(path, **{k[8:]: ex[k] for k in ex.files
                      if k.startswith("pr_ckpt_")})
    ja = jcoop.CoopAgent(assets.pr_quality_config(), 0)
    jckpt.load_system(path, ja)
    ta = tcoop.CoopAgent(tpq.cfg_for(320, 240), 0, device="cpu")
    tckpt.load_system(path, ta)
    n = ta._host_n_kf
    assert n == ja._host_n_kf == int(ex["pr_K"])
    ja.kf_agent[:n] = ta.kf_agent[:n] = 0
    for a, mod in ((ja, jdc), (ta, tdc)):
        for k in range(n):
            mod.probe(a, k)
    lines = capsys.readouterr().out.splitlines()
    assert lines[:n] == lines[n:]
    assert sum("counts=[(" in ln for ln in lines[:n]) >= 5

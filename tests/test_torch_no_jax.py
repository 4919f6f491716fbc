"""The port stands alone: every coslam_tpu_torch module (and chip_smoke.py,
bench_torch.py) imports with jax made unimportable, the ranks that the
port's launcher spawns load no JAX module, and the slice's modules sit at
the same relative paths as their coslam_tpu counterparts (the ports of the
root entry points and of the JAX side's scripts under coslam_tpu_torch/).
The dataset front end (utils/io.py, cli.py, viz/) imports Pillow only where
it reads or draws an image, as the reference does.  Nothing of the port and
not chip_smoke.py reads a file under coslam_tpu/ (the vocabulary is the
port's own copy), and the ported scripts do nothing at import and run on
the GPU unless asked for the CPU."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE = ["config.py", "utils/geometry.py", "utils/camera.py",
         "utils/synthetic.py", "utils/evaluation.py", "utils/checkpoint.py",
         "ops/pyramid.py", "ops/fast.py", "ops/orb.py", "ops/hamming.py",
         "ops/matching.py", "optim/pose_opt.py", "models/frame.py",
         "models/map_state.py", "models/tracking.py", "models/system.py",
         "ops/bow.py", "ops/twoview.py", "optim/ba.py",
         "models/keyframe_db.py", "models/loop_closing.py",
         "models/local_mapping.py", "models/compaction.py", "utils/io.py",
         "ops/sim3.py", "ops/pnp.py", "optim/pose_graph.py",
         "ops/stereo.py", "models/cooperative.py", "utils/profiling.py",
         "native/__init__.py", "cli.py", "parallel/mesh.py",
         "parallel/exchange.py", "parallel/sharded_ba.py", "viz/__init__.py",
         "viz/frame_drawer.py", "viz/map_drawer.py", "viz/viewer.py"]
# the port's modules of the reference's measurement entry points at the
# repo root (port path -> reference path), and the port's own root scripts
ROOT_PORTS = {"entry.py": "__graft_entry__.py", "bench.py": "bench.py",
           "bench_scaling.py": "bench_scaling.py"}
ROOT_SCRIPTS = ["chip_smoke.py", "bench_torch.py"]
# the ports of the JAX side's scripts (port path -> reference path)
SCRIPT_PORTS = {f"scripts/{n}.py": f"scripts/{n}.py" for n in (
    "train_vocab", "pr_quality", "make_proxy_datasets", "run_results",
    "debug_coop")}

LOOP_MODULES = ["coslam_tpu_torch.ops.sim3",
                "coslam_tpu_torch.optim.pose_graph",
                "coslam_tpu_torch.models.loop_closing"]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import coslam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(coslam_tpu_torch.__path__,
                                                "coslam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import bench_torch, chip_smoke
assert not any(k == "jax" or k.startswith(("jax.", "coslam_tpu."))
               for k in sys.modules if sys.modules[k] is not None)
print(len(names))
"""


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) \
        >= len(SLICE) + len(ROOT_PORTS) + len(SCRIPT_PORTS) + 6


def test_slice_modules_mirror_the_reference_layout():
    for rel in SLICE:
        assert os.path.isfile(os.path.join(ROOT, "coslam_tpu", rel)), rel
        assert os.path.isfile(os.path.join(ROOT, "coslam_tpu_torch", rel)), rel
    for port, ref in ROOT_PORTS.items():
        assert os.path.isfile(os.path.join(ROOT, ref)), ref
        assert os.path.isfile(os.path.join(ROOT, "coslam_tpu_torch", port))
    for rel in ROOT_SCRIPTS:
        assert os.path.isfile(os.path.join(ROOT, rel)), rel
    for port, ref in SCRIPT_PORTS.items():
        assert os.path.isfile(os.path.join(ROOT, ref)), ref
        assert os.path.isfile(os.path.join(ROOT, "coslam_tpu_torch", port))
    for name in ("fast_score_nms.cu", "masked_match.cu", "pose_opt_lm.cu"):
        assert os.path.isfile(os.path.join(ROOT, "coslam_tpu_torch", "csrc",
                                           name))


def test_loop_closing_modules_import_without_jax():
    """sim3, pose_graph and loop_closing, each imported on its own in a
    fresh interpreter where `jax` cannot be imported, pull in neither jax
    nor the JAX package; and their public functions are all there."""
    code = """
import importlib, sys
sys.modules["jax"] = None
for name in %r:
    importlib.import_module(name)
assert not any(k.startswith(("jax.", "coslam_tpu.")) or k == "coslam_tpu"
               for k in sys.modules if sys.modules[k] is not None)
from coslam_tpu_torch.models import loop_closing as lc
from coslam_tpu_torch.ops import sim3
from coslam_tpu_torch.optim import ba, pose_graph as pg
for mod, names in ((lc, "match_pair_points match_counts_all "
                    "match_counts_subset sim3_between expand_sim3_matches "
                    "sim3_refine_pairs fuse_landmarks correct_loop global_ba "
                    "LoopCloser"),
                   (sim3, "Sim3Result horn_sim3 ransac_sim3 refine_sim3"),
                   (pg, "Sim3Vertices vertices_from_se3 vertices_to_se3 "
                    "edge_residual optimize relative_sim3 optimize_sparse"),
                   (ba, "BAProblem BAResult solve solve_dense "
                    "solve_dense_compact solve_body")):
    for n in names.split():
        assert hasattr(mod, n), (mod.__name__, n)
print("ok")
""" % (LOOP_MODULES,)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_launched_ranks_import_no_jax():
    """A rank of `parallel.mesh.launch` (spawned: it imports only the module
    of its function) and a rank of the lockstep driver's module load no
    JAX module."""
    code = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, "tests")
import torch_dist_ranks as ranks
from coslam_tpu_torch.parallel import mesh, multichip  # noqa: F401
print(mesh.launch(ranks.modules, 2))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[[], []]"


def test_dataset_front_end_imports_pillow_lazily():
    """utils/io.py, viz/* and cli.py import with neither jax nor PIL
    importable; without Pillow the viewer's first drawing raises an
    ImportError naming it (the reference's own behaviour)."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["PIL"] = None
import numpy as np
from coslam_tpu_torch import cli, viz
from coslam_tpu_torch.utils import io
from coslam_tpu_torch.viz import frame_drawer, map_drawer, viewer
assert not any(k == "PIL" or k.startswith(("PIL.", "jax.", "coslam_tpu."))
               for k in sys.modules if sys.modules[k] is not None)
try:
    viz.draw_frame(np.zeros((8, 8), np.uint8), np.zeros((0, 2)),
                   np.zeros(0, bool))
except ImportError as e:
    print("PIL" in str(e))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "True"


_NO_REFERENCE_FILES = """
import builtins, importlib, os, pkgutil, sys
import numpy as np
sys.modules["jax"] = None
BANNED = os.path.join(os.getcwd(), "coslam_tpu") + os.sep


def guard(fn):
    def wrapped(p, *a, **kw):
        if isinstance(p, (str, bytes, os.PathLike)) and os.path.abspath(
                os.fsdecode(p)).startswith(BANNED):
            raise AssertionError(f"{fn.__name__}({p!r})")
        return fn(p, *a, **kw)
    wrapped.__name__ = fn.__name__
    return wrapped


builtins.open = guard(builtins.open)
np.load = guard(np.load)
os.path.exists = guard(os.path.exists)
os.path.isfile = guard(os.path.isfile)
try:
    np.load("coslam_tpu/assets/vocab.npz")
    raise SystemExit("the guard let a read through")
except AssertionError:
    pass
import coslam_tpu_torch
for m in pkgutil.walk_packages(coslam_tpu_torch.__path__,
                               "coslam_tpu_torch."):
    importlib.import_module(m.name)
import bench_torch, chip_smoke
chip_smoke.preflight()
from coslam_tpu_torch.config import SystemConfig
from coslam_tpu_torch.models.keyframe_db import KeyFrameDatabase
from coslam_tpu_torch.models.system import System
from coslam_tpu_torch.ops import bow
cfg = SystemConfig()
s = System(cfg, device="cpu")
db = KeyFrameDatabase(cfg, device="cpu")
print(s.db.n_words, db.n_words, db._external_vocab,
      os.path.relpath(bow.pretrained_vocabulary_path()))
"""


def test_nothing_reads_a_file_of_the_jax_package():
    """In a process where open, np.load, os.path.exists and os.path.isfile
    raise on any path under coslam_tpu/: every port module and
    chip_smoke.py import, chip_smoke's preflight passes, and a System and a
    KeyFrameDatabase are built on the CPU with the pretrained vocabulary."""
    out = subprocess.run([sys.executable, "-c", _NO_REFERENCE_FILES],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] \
        == "8192 8192 True coslam_tpu_torch/assets/vocab.npz"


_SCRIPTS_DEFAULT_TO_CUDA = """
import contextlib, importlib, io, os, sys
import torch
sys.modules["jax"] = None
torch.cuda.is_available = lambda: False
before = sorted(os.listdir("."))
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    mods = [importlib.import_module(f"coslam_tpu_torch.scripts.{n}")
            for n in %r]
assert buf.getvalue() == "", buf.getvalue()
for mod in mods:
    try:
        mod.main([])
        raise SystemExit(f"{mod.__name__} ran without a GPU")
    except RuntimeError as e:
        assert 'device="cpu"' in str(e), (mod.__name__, e)
assert sorted(os.listdir(".")) == before
print("ok")
"""


def test_scripts_default_to_the_gpu():
    """The ported scripts print nothing at import, and each `main` with no
    arguments asks for the GPU and raises where there is none (nothing
    falls back to the CPU, nothing is written)."""
    names = [os.path.basename(p)[:-3] for p in SCRIPT_PORTS]
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPTS_DEFAULT_TO_CUDA % (names,)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"

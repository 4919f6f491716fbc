"""The port stands alone: every coslam_tpu_torch module (and chip_smoke.py)
imports with jax made unimportable, and the slice's modules sit at the same
relative paths as their coslam_tpu counterparts."""

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
         "ops/stereo.py"]

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
import chip_smoke
assert not any(k == "jax" or k.startswith(("jax.", "coslam_tpu."))
               for k in sys.modules if sys.modules[k] is not None)
print(len(names))
"""


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= len(SLICE) + 5


def test_slice_modules_mirror_the_reference_layout():
    for rel in SLICE:
        assert os.path.isfile(os.path.join(ROOT, "coslam_tpu", rel)), rel
        assert os.path.isfile(os.path.join(ROOT, "coslam_tpu_torch", rel)), rel
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

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
         "models/local_mapping.py", "models/compaction.py", "utils/io.py"]

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

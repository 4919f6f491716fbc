"""Nothing a benchmark run imports is JAX or the JAX package (top-level
module names compared whole: the port's own name begins with the JAX
package's), and the plain reference imports nothing of the program."""

import json
import subprocess
import sys

from benchmark.tests.bench_common import ROOT

RUN_IMPORTS = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.harness import (capture, checks, main, outcome, peaks,
                               program, render, spec, trace, window)
bench = spec.benchmark()
for w in [w["name"] for w in bench["workloads"]]:
    spec.cell(w, bench=bench).driver()
import coslam_tpu_torch.models.system, coslam_tpu_torch.ops.cuda_kernels
import coslam_tpu_torch.ops.orb, coslam_tpu_torch.optim.ba
import coslam_tpu_torch.ops.sim3
import torch.profiler
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_IMPORTS = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.orb, benchmark.reference.matcher
import benchmark.reference.pose, benchmark.reference.mapcheck
import benchmark.reference.trajectory
import benchmark.reference.ba, benchmark.reference.sim3
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_level(RUN_IMPORTS)
    assert "coslam_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "coslam_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    names = _top_level(REFERENCE_IMPORTS)
    assert not names & {"coslam_tpu_torch", "coslam_tpu", "jax", "jaxlib"}

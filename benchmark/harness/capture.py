"""What the harness takes from the program while the window runs, by
replacing module and class attributes in its own process and restoring
them afterwards:

  * `Samples`: a seeded sample of the calls into the three kernels' entry
    points (`orb.extract`, whose K1 and descriptors the frame layer makes,
    `cuda_kernels.masked_match` (K2), `cuda_kernels.pose_opt_lm` (K3)) and
    into two solvers above them (`ba.solve_dense`, the keyframe backend's
    windowed local BA; `sim3.refine_sim3`, the polish of every Sim3 that
    loop closing verifies), with copies of their
    inputs and outputs for the correctness check;
  * `Spans`: in a traced run, a `torch.profiler.record_function` range and
    a host-clock span around each call into a layer.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import numpy as np


def _clone(v):
    import torch
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, dict):
        return {k: _clone(x) for k, x in v.items()}
    if isinstance(v, tuple) and hasattr(v, "_fields"):     # a NamedTuple
        return type(v)(*(_clone(x) for x in v))
    if isinstance(v, (tuple, list)):
        return type(v)(_clone(x) for x in v)
    return v


class Patches:
    """Attribute replacements undone in reverse order on exit."""

    def __init__(self):
        self._undo: List[Tuple[object, str, object]] = []

    def replace(self, owner, name: str, make: Callable[[Callable], Callable]):
        inner = getattr(owner, name)
        self._undo.append((owner, name, inner))
        setattr(owner, name, make(inner))

    def restore(self) -> None:
        while self._undo:
            owner, name, inner = self._undo.pop()
            setattr(owner, name, inner)


class Samples:
    """Seeded sample of kernel entry-point calls.  `plan` maps a kind to
    (probability a call is kept, most kept); the first call of each kind
    is always kept, and the draws come from the seed, one per call, so a
    run's sample depends on the seed and on the calls the program
    makes."""

    KINDS = ("extract", "masked_match", "pose_opt_lm", "solve_dense",
             "refine_sim3")

    def __init__(self, seed: int, plan: Dict[str, Tuple[float, int]]):
        self.plan = {k: (float(p), int(n)) for k, (p, n) in plan.items()}
        self.rng = {k: np.random.default_rng([seed % (1 << 63), i])
                    for i, k in enumerate(self.KINDS)}
        self.calls = {k: 0 for k in self.KINDS}
        self.kept: Dict[str, List[dict]] = {k: [] for k in self.KINDS}
        self.patches = Patches()

    def _take(self, kind: str) -> bool:
        self.calls[kind] += 1
        p, most = self.plan.get(kind, (0.0, 0))
        draw = self.rng[kind].random()
        if not self.kept[kind] and most > 0:
            return True                    # every kind is judged at least once
        return draw < p and len(self.kept[kind]) < most

    def install(self) -> "Samples":
        from coslam_tpu_torch.ops import cuda_kernels as ck
        from coslam_tpu_torch.ops import orb, sim3
        from coslam_tpu_torch.optim import ba

        def sampled(kind):
            def make(inner):
                def call(*args, **kw):
                    out = inner(*args, **kw)
                    if self._take(kind):
                        self.kept[kind].append(
                            {"args": _clone(args), "kw": _clone(kw),
                             "out": _clone(out)})
                    return out
                return call
            return make

        self.patches.replace(orb, "extract", sampled("extract"))
        self.patches.replace(ck, "masked_match", sampled("masked_match"))
        self.patches.replace(ck, "pose_opt_lm", sampled("pose_opt_lm"))
        self.patches.replace(ba, "solve_dense", sampled("solve_dense"))
        self.patches.replace(sim3, "refine_sim3", sampled("refine_sim3"))
        return self

    def restore(self) -> None:
        self.patches.restore()


class Spans:
    """Host-clock spans (time.time_ns, the profiler's clock) around the
    calls into each layer, each also a record_function range."""

    def __init__(self):
        self.spans: Dict[str, List[Tuple[int, int]]] = {}
        self.patches = Patches()

    def _wrap(self, name: str):
        import torch

        spans = self.spans.setdefault(name, [])

        def make(inner):
            def call(*args, **kw):
                t0 = time.time_ns()
                try:
                    with torch.profiler.record_function(name):
                        return inner(*args, **kw)
                finally:
                    spans.append((t0, time.time_ns()))
            return call
        return make

    def install(self) -> "Spans":
        from coslam_tpu_torch.models import local_mapping
        from coslam_tpu_torch.models import loop_closing
        from coslam_tpu_torch.models import system
        from coslam_tpu_torch.models import tracking

        self.patches.replace(tracking, "track_chunk",
                             self._wrap("tracking.track_chunk"))
        self.patches.replace(system.System, "track_mono",
                             self._wrap("System.track_mono"))
        self.patches.replace(local_mapping, "backend_insert",
                             self._wrap("local_mapping.backend_insert"))
        self.patches.replace(loop_closing.LoopCloser, "on_keyframe",
                             self._wrap("LoopCloser.on_keyframe"))
        return self

    def restore(self) -> None:
        self.patches.restore()

"""One run of one cell: set-up, the measured window, the trace (with
`--trace 1`), the correctness check, and the result line."""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from typing import Optional

from benchmark.harness import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "coslam_tpu")
CACHE = os.path.join(spec.HERE, ".cache")


def cache_environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_process: float) -> int:
    args = parse(argv)
    cache_environment()
    try:
        cell = spec.cell(args.workload)
    except spec.SpecError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    res = run(cell, args.seed, args.seconds, bool(args.trace), t_process)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 4
    for name, value, limit in res["checks"]:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


def run(cell, seed: int, seconds: float, traced: bool, t_process: float,
        device: str = "cuda", workers=None, faults=None,
        keep: Optional[dict] = None) -> dict:
    """Set up, measure, check.  `faults` (tests only) is a callable that
    breaks the timed path underneath, given the Patches to register on;
    `keep` (the control) receives the samples and the outcome."""
    import torch

    from benchmark.harness import capture, checks, trace
    from benchmark.harness.window import Clock, rate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    seed = int(seed) % (1 << 63)          # numpy seeds are non-negative
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stamps = [("start", t_process)]

    def stamp(what):
        stamps.append((what, time.perf_counter()))

    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        from coslam_tpu_torch.ops import cuda_kernels  # noqa: F401
    stamp("cuda")
    driver = cell.driver()
    st = driver.setup(cell, seed, device=device, workers=workers,
                      stamp=stamp)
    sync()
    samples = capture.Samples(seed, cell.traffic["samples"])
    spans = capture.Spans() if traced else None
    prof = trace.Profiler() if traced else None
    broken = capture.Patches()
    if faults is not None:
        faults(broken)
    samples.install()
    if spans is not None:
        spans.install()
    if prof is not None:
        prof.start()
    clock = Clock(seconds, at_close=sync)
    clock.start()
    setup_s = time.perf_counter() - t_process
    try:
        sessions = driver.run_window(st, clock)
    finally:
        events = prof.stop() if prof is not None else None
        samples.restore()
        if spans is not None:
            spans.restore()
        broken.restore()
    stamp("window")
    window_s = clock.window_s
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out = driver.outcomes(st, sessions)
    stamp("outcomes")
    del sessions, st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics, breakdown, dev_extra = {}, None, {}
    if traced:
        td = trace.read(events, clock.t0_ns, clock.t_end_ns, out.posed,
                        spans.spans, out, cell.config)
        del events
        for m in cell.per_layer:
            v = cell.readers[m.name].read(td)
            if v is not None:
                metrics[m.name] = {"value": float(v), "unit": m.unit}
        breakdown = trace.breakdown(td)
        stamp("trace")
        dev_extra = {"busy_s": td.busy_s, "window_s": td.window_s}
    else:
        e2e = {"frames_per_s": rate(out.posed, window_s),
               "setup_s": setup_s}
        for m in cell.end_to_end:
            if m.name in e2e:
                metrics[m.name] = {"value": float(e2e[m.name]),
                                   "unit": m.unit}

    if keep is not None:
        keep.update(samples=samples, outcome=out)
    got = checks.numbers(cell, out, samples)
    correct, rows = checks.judge(cell, got)
    stamp("checks")
    print("stages (s): " + ", ".join(
        f"{w} {b - a:.2f}" for (_w0, a), (w, b) in zip(stamps, stamps[1:])),
        file=sys.stderr)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak),
                   **dev_extra}
    if cuda:
        device_info["name_and_power_limit"] = power_limit()
    res = {"correct": bool(correct), "attempted": int(out.attempted),
           "failed": int(out.failed), "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        res["breakdown"] = breakdown
    res["window"] = {"seconds": window_s, "sessions": len(out.sessions),
                     "sessions_finished": sum(s["finished"]
                                              for s in out.sessions),
                     "posed": out.posed,
                     "samples": {k: len(v) for k, v in samples.kept.items()},
                     "counters": {k: out.counter(k) for k in
                                  ("loops_closed",
                                   "n_frames_chunked", "n_frames_discarded")
                                  if out.counter(k) is not None},
                     "readings": checks.readings(cell, out, samples),
                     "per_session": [
                         {"finished": s["finished"], "posed": s["posed"],
                          "failed": s["failed"],
                          "ate_m": checks.session_ate(s),
                          **s.get("counters", {})}
                         for s in out.sessions]}
    res["stages_s"] = {w: b - a for (_w0, a), (w, b)
                       in zip(stamps, stamps[1:])}
    res["checks"] = rows
    return res

"""Shared by the benchmark's CPU tests: the repository root on sys.path,
and a cell cut to a size the CPU runs in seconds (320x240, 500 features,
small map), for driving the harness without the card."""

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import spec  # noqa: E402


ALL_CELLS = spec.benchmark()


def full_cell(workload: str):
    """A cell of BENCHMARK.json."""
    return spec.cell(workload, bench=ALL_CELLS)


def small_cell(workload: str):
    cell = full_cell(workload)
    c = copy.deepcopy(cell.config)
    cam = c["system"]["camera"]
    cam.update(width=320, height=240, fx=cam["fx"] / 2, fy=cam["fy"] / 2,
               cx=cam["cx"] / 2, cy=cam["cy"] / 2)
    c["system"]["extractor"].update(n_features=500, max_keypoints=512)
    c["system"]["mapper"].update(max_keyframes=32, max_points=4096)
    cell.config = c
    t = copy.deepcopy(cell.traffic)
    t.update(warmup_frames=4)
    t["samples"] = {k: [1.0, 2] for k in t["samples"]}
    cell.traffic = t
    return cell

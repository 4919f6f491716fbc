"""Run the dataset CLI end to end on every proxy dataset and write
RESULTS_TORCH.md (port of scripts/run_results.py: the same four runs, bounds
and repetitions).

Without network access the TUM / EuRoC / KITTI sequences named in
BASELINE.md cannot be fetched; proxy datasets in the same on-disk layouts
stand in for them
(`coslam_tpu_torch.scripts.make_proxy_datasets`): the whole dataset path
(image files, timestamp association, ground-truth parsing, the CLI,
trajectory export, ATE) runs; only the pixels are rendered instead of
captured.  Each run is `python -m coslam_tpu_torch.cli <mode> ... --device
<device>` in a subprocess.  The table puts beside each row the JAX package's
figure for the same proxy from RESULTS.md (its CLI on a CPU).

    python -m coslam_tpu_torch.scripts.run_results [--datasets DIR] \
        [--out RESULTS_TORCH.md] [--results-dir results/torch] [--reps 3] \
        [--device cuda]

The exit code is 1 where a run fails or its ATE exceeds the row's bound.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from coslam_tpu_torch.bench import card_name
from coslam_tpu_torch.scripts import make_proxy_datasets
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

RUNS = [
    dict(name="TUM-layout mono (proxy for fr1_xyz)",
         mode="mono", dataset="tum", root="tum_proxy",
         bound_cm=5.0, baseline="ORB-SLAM2 fr1_xyz ~0.9 cm (real data)"),
    dict(name="TUM-layout RGB-D (proxy for fr1_desk)",
         mode="rgbd", dataset="tum", root="tum_proxy",
         bound_cm=5.0, baseline="ORB-SLAM2 fr1_desk ~1.6 cm (real data)"),
    dict(name="EuRoC-layout mono (proxy for MH01)",
         mode="mono", dataset="euroc", root="euroc_proxy",
         bound_cm=6.0, baseline="ORB-SLAM2 MH01 ~3-4 cm (real data)"),
    dict(name="KITTI-layout stereo (proxy for seq 00)",
         mode="stereo", dataset="kitti", root="kitti_proxy",
         bound_cm=200.0, baseline="ORB-SLAM2 KITTI 00 ~1.3 m (real data)"),
]
# RESULTS.md, the JAX package's CLI on a CPU over the same 120-frame
# proxies (one repetition): ATE, frames tracked / keyframes, wall
JAX_CPU = {
    "TUM-layout mono (proxy for fr1_xyz)":
        "1.23 cm, 116 / 120 tracked, 24 KFs, 212.8s",
    "TUM-layout RGB-D (proxy for fr1_desk)":
        "0.97 cm, 120 / 120 tracked, 5 KFs, 119.5s",
    "EuRoC-layout mono (proxy for MH01)":
        "0.84 cm, 117 / 120 tracked, 40 KFs, 304.5s",
    "KITTI-layout stereo (proxy for seq 00)":
        "62.73 cm, 120 / 120 tracked, 45 KFs, 533.5s",
}


def run_one(spec: dict, datasets_dir: str, out_dir: str,
            device=DEFAULT_DEVICE) -> dict:
    """One CLI run in a subprocess: its command, wall seconds, exit code,
    trajectory path and, from its report, `ate_cm` and `tracked`."""
    root = os.path.join(datasets_dir, spec["root"])
    traj = os.path.join(out_dir, f"traj_{spec['mode']}_{spec['dataset']}.txt")
    cmd = [sys.executable, "-m", "coslam_tpu_torch.cli", spec["mode"],
           "--dataset", spec["dataset"], "--root", root, "--out", traj,
           "--device", str(device)]
    if spec["dataset"] == "kitti":
        cmd += ["--seq", "00"]
    env = dict(os.environ)
    # the package imports from this checkout
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       timeout=3600, env=env)
    wall = time.time() - t0
    res = dict(spec=spec, cmd=" ".join(cmd), wall_s=round(wall, 1),
               rc=p.returncode, traj=traj)
    for line in p.stdout.splitlines():
        if line.startswith("ATE RMSE:"):
            res["ate_cm"] = float(line.split(":")[1].split("cm")[0])
        if line.startswith("frames tracked:"):
            res["tracked"] = line.strip()
    if p.returncode != 0:
        res["stderr_tail"] = p.stderr[-2000:]
    return res


def combine(reps: list) -> dict:
    """The row of one run: the first repetition's record with the mean,
    min and max ATE over the repetitions that gave one, and the first
    non-zero exit code of any repetition."""
    best = dict(reps[0])
    best["rc"] = next((r["rc"] for r in reps if r["rc"] != 0), 0)
    ates = [x["ate_cm"] for x in reps if "ate_cm" in x]
    if ates:
        best["ate_cm"] = sum(ates) / len(ates)
        best["ate_min"] = min(ates)
        best["ate_max"] = max(ates)
        best["n_reps"] = len(ates)
    return best


def table_lines(results: list, device_note: str) -> list:
    lines = [
        "# RESULTS — dataset-path validation, coslam_tpu_torch\n",
        f"**Device:** {device_note}.\n",
        "**Provenance.** Without network access the real "
        "TUM/EuRoC/KITTI sequences named in BASELINE.md cannot be "
        "downloaded.  Every run below uses a **PROXY dataset**: a rendered "
        "synthetic sequence written into the exact on-disk layout of the "
        "corresponding real dataset "
        "(`python -m coslam_tpu_torch.scripts.make_proxy_datasets`), driven "
        "through the port's loaders, CLI, trajectory export and evaluation "
        "(`coslam_tpu_torch/utils/io.py`, `coslam_tpu_torch/cli.py`).  The "
        "proxy validates the dataset path end to end; it does NOT validate "
        "real-imagery photometrics.  The last column is the JAX package's "
        "run of the same proxy from RESULTS.md, on a CPU; it is not the "
        "port's.\n",
        "| Run | ATE RMSE (mean of reps) | spread (min..max) | "
        "bound (proxy) | real-data reference point | frames | wall | "
        "JAX package on a CPU (RESULTS.md) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        s = r["spec"]
        ate = f"{r.get('ate_cm', float('nan')):.2f} cm" \
            if "ate_cm" in r else f"FAILED (rc={r['rc']})"
        spread = (f"{r['ate_min']:.2f}..{r['ate_max']:.2f} cm "
                  f"({r['n_reps']} reps)" if "ate_min" in r else "—")
        lines.append(
            f"| {s['name']} | {ate} | {spread} | < {s['bound_cm']:.0f} cm | "
            f"{s['baseline']} | {r.get('tracked', '—')} | {r['wall_s']}s | "
            f"{JAX_CPU.get(s['name'], '—')} |")
    lines.append("\nCommands (re-runnable from the repository root):\n")
    for r in results:
        cmd = r["cmd"].replace(sys.executable, "python")
        lines.append(f"    {cmd.replace(ROOT + os.sep, '')}")
    lines.append("\nExported trajectories: `results/torch/traj_*.txt` "
                 "(TUM format).\n")
    return lines


def failed(results: list) -> list:
    return [r for r in results
            if r["rc"] != 0 or r.get("ate_max", r.get("ate_cm", 1e9))
            > r["spec"]["bound_cm"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--datasets", default=os.path.join(ROOT, "datasets"))
    ap.add_argument("--out", default=os.path.join(ROOT, "RESULTS_TORCH.md"))
    ap.add_argument("--results-dir",
                    default=os.path.join(ROOT, "results", "torch"))
    ap.add_argument("--reps", type=int, default=3,
                    help="repetitions per row; the spread column "
                         "demonstrates run-to-run reproducibility")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.results_dir, exist_ok=True)

    if not os.path.isdir(os.path.join(args.datasets, "tum_proxy")):
        print("generating proxy datasets first...")
        make_proxy_datasets.make_all(args.datasets, device=dev)

    results = []
    for spec in RUNS:
        reps = []
        for rep in range(args.reps):
            print(f"== {spec['name']} (rep {rep + 1}/{args.reps})",
                  flush=True)
            r = run_one(spec, args.datasets, args.results_dir, dev)
            print(json.dumps({k: v for k, v in r.items() if k != "spec"}),
                  flush=True)
            reps.append(r)
        results.append(combine(reps))

    with open(args.out, "w") as f:
        f.write("\n".join(table_lines(results, card_name(dev))))
    print(f"wrote {args.out}")
    return 1 if failed(results) else 0


if __name__ == "__main__":
    raise SystemExit(main())

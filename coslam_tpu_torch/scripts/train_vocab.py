"""Offline vocabulary training (port of scripts/train_vocab.py), the
analogue of building the reference's pre-trained DBoW2 ORBvoc.txt (loaded at
System.cc:61-72).

Harvests rBRIEF descriptors from several diverse synthetic proxy scenes (box
clouds on arcs, cylinder interiors on loops, several seeds) with
`build_frame` on the device, subsamples a pool on the host, and k-means-trains
a flat word set on the device (`ops/bow.train_vocabulary_device`).  The result
is written to the port's own `coslam_tpu_torch/assets/vocab.npz`, which every
`KeyFrameDatabase` loads (`ops/bow.load_pretrained_vocabulary`); vocabulary
training never runs inside the insertion path.

The k-means seeds walk a permutation of the pool.  The JAX script draws it
with `jax.random.permutation(PRNGKey(seed), n)`, which torch cannot
reproduce, so here it comes from a `torch.Generator` seeded `--seed`, or is
given as `perm`.

    python -m coslam_tpu_torch.scripts.train_vocab [--words 8192] \
        [--iters 12] [--max-desc 65536] [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from coslam_tpu_torch.config import (CameraConfig, ExtractorConfig,
                                     SystemConfig)
from coslam_tpu_torch.models.frame import build_frame
from coslam_tpu_torch.ops import bow, hamming
from coslam_tpu_torch.utils import synthetic
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

OCCUPANCY_SAMPLE = 16384


def harvest_config() -> SystemConfig:
    cam = CameraConfig(fx=400, fy=400, cx=320, cy=240, width=640, height=480)
    return SystemConfig(camera=cam,
                        extractor=ExtractorConfig(n_features=1000,
                                                  max_keypoints=1024))


def harvest_jobs() -> List[Tuple[synthetic.Scene, synthetic.Trajectory]]:
    """(scene, trajectory) of each harvest job, in the JAX script's order."""
    jobs = []
    # box clouds seen on arcs (the tracking benches' geometry)
    for seed in (3, 5, 9):
        jobs.append((synthetic.make_scene(700, seed=seed),
                     synthetic.make_trajectory(48, seed=seed)))
    # cylinder interiors on loop trajectories (the loop-closure geometry)
    for seed in (11, 21):
        jobs.append((synthetic.make_cylinder_scene(900, seed=seed),
                     synthetic.make_loop_trajectory(64, seed=seed,
                                                    frac=1.0)))
    return jobs


def job_descriptors(cfg: SystemConfig, scene, traj, stride: int,
                    dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F, N, 8) descriptors and (F, N) validity of every `stride`-th frame
    of one job, on the device (only those frames are rendered: each frame
    is rendered on its own, so the images are the JAX script's)."""
    seq = synthetic.render_sequence(
        cfg.camera, synthetic.Trajectory(traj.poses_cw[::stride]), scene)
    desc, valid = [], []
    for img in seq:
        f = build_frame(torch.from_numpy(img).to(dev), cfg)
        desc.append(f.desc)
        valid.append(f.valid)
    return torch.stack(desc), torch.stack(valid)


def harvest(cfg: Optional[SystemConfig] = None, jobs=None, stride: int = 2,
            device=DEFAULT_DEVICE) -> np.ndarray:
    """(n, 8) uint32 valid descriptors of every job's frames, in frame and
    keypoint order; one read back per job."""
    dev = resolve_device(device)
    cfg = harvest_config() if cfg is None else cfg
    jobs = harvest_jobs() if jobs is None else jobs
    pools = []
    for scene, traj in jobs:
        desc, valid = job_descriptors(cfg, scene, traj, stride, dev)
        pools.append(desc[valid].cpu().numpy().view(np.uint32))
    return np.concatenate(pools)


def train(pool: np.ndarray, n_words: int, iters: int, seed: int,
          dev: torch.device, perm=None) -> np.ndarray:
    """(n_words, 8) uint32 words of binary k-means over the whole pool,
    its seeds walking `perm` or a permutation drawn from a generator seeded
    `seed`."""
    d = torch.from_numpy(np.ascontiguousarray(pool).view(np.int32)).to(dev)
    if perm is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        perm = torch.randperm(d.shape[0], generator=gen, device=dev)
    words = bow.train_vocabulary_device(
        d, torch.ones(d.shape[0], dtype=torch.bool, device=dev), n_words,
        iters, perm=perm)
    return words.cpu().numpy().view(np.uint32)


def occupancy(sub: np.ndarray, words: np.ndarray,
              dev: torch.device) -> np.ndarray:
    """(W,) descriptors of `sub` nearest to each word (ties to the lowest
    word id)."""
    d = hamming.pairwise_hamming_pm1(
        torch.from_numpy(np.ascontiguousarray(sub).view(np.int32)).to(dev),
        bow.vocab_tensor(words, dev))
    return np.bincount(torch.argmin(d, dim=1).cpu().numpy(),
                       minlength=words.shape[0])


def write_vocabulary(path: str, words: np.ndarray, n_words: int, iters: int,
                     seed: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, words=words,
                        meta=np.array([n_words, iters, seed]))


def train_vocab(words: int = 8192, iters: int = 12, max_desc: int = 65536,
                seed: int = 0, device=DEFAULT_DEVICE,
                out: Optional[str] = None, perm=None) -> dict:
    """The whole script: harvest, subsample, train, write `out` (the port's
    vocabulary file by default), occupancy; prints the JAX script's lines
    and returns the words, the occupancy and the times."""
    dev = resolve_device(device)
    out = bow.pretrained_vocabulary_path() if out is None else out
    t0 = time.time()
    pool = harvest(device=dev)
    harvest_s = time.time() - t0
    n_harvested = int(pool.shape[0])
    print(f"harvested {n_harvested} descriptors ({harvest_s:.0f}s)",
          flush=True)
    rng = np.random.default_rng(seed)
    if pool.shape[0] > max_desc:
        pool = pool[rng.choice(pool.shape[0], max_desc, replace=False)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    w = train(pool, words, iters, seed, dev, perm=perm)
    train_ms = (time.perf_counter() - t1) * 1e3
    write_vocabulary(out, w, words, iters, seed)
    # occupancy diagnostics: how many words actually attract descriptors
    sub = pool[rng.choice(pool.shape[0], min(OCCUPANCY_SAMPLE, pool.shape[0]),
                          replace=False)]
    occ = occupancy(sub, w, dev)
    print(f"trained {words} words in {time.time() - t0:.0f}s; "
          f"occupied {int((occ > 0).sum())}/{words}, "
          f"max bucket {int(occ.max())}, wrote {out} "
          f"({os.path.getsize(out) // 1024} KiB)", flush=True)
    return dict(words=w, occupancy=occ, n_harvested=n_harvested,
                n_pool=int(pool.shape[0]), harvest_s=harvest_s,
                train_ms=train_ms, path=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--words", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--max-desc", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    train_vocab(args.words, args.iters, args.max_desc, args.seed, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

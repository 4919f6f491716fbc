"""Bag-of-binary-words place recognition (port of coslam_tpu/ops/bow.py,
whole).

A flat vocabulary of W word centroids, (W, 8) int32 tensors holding the
reference's uint32 bits; word assignment for all keypoints of a frame is
one (N, W) Hamming argmin, computed as the exact +/-1 matmul
(`hamming.pairwise_hamming_pm1`, the reference's `pairwise_hamming_mxu`).
BoW vectors are dense (W,) L1-normalized tf weights; similarity is the
DBoW2 L1 score s(v, w) = 1 - 0.5 * |v - w|_1.

The vocabulary file is the port's own `coslam_tpu_torch/assets/vocab.npz`,
a byte-for-byte copy of the one the JAX package ships
(`coslam_tpu_torch.scripts.train_vocab` trains a new one into that path).
Without it the vocabulary
is trained online by binary k-means (majority-bit medoids):
`train_vocabulary` on the host in numpy, `train_vocabulary_device` on the
System's device, where the (n, W) assignment is one f32 matmul of 0/1 bits
(exact, so the words are bit-equal to the reference's).  The k-means seeds
come from a permutation of the pool: the reference draws it with
`jax.random.permutation(PRNGKey(0), n)`, which torch cannot reproduce, so
it is an argument (`perm`), else drawn from a `torch.Generator` seeded 0.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from coslam_tpu_torch.ops import hamming

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Vocabulary training
# ---------------------------------------------------------------------------

def _unpack_bits_np(desc: np.ndarray) -> np.ndarray:
    """uint32 (N, 8) -> (N, 256) float bits."""
    b = desc.view(np.uint8).reshape(desc.shape[0], -1)  # little-endian bytes
    return np.unpackbits(b, axis=1, bitorder="little").astype(np.float32)


def _pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """(W, 256) {0,1} -> uint32 (W, 8)."""
    by = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    return by.view(np.uint32)


def train_vocabulary(descriptors: np.ndarray, n_words: int = 1024,
                     iters: int = 8, seed: int = 0) -> np.ndarray:
    """Binary k-means over packed uint32 descriptors on the host ->
    (n_words, 8) uint32 words: Hamming assignment, majority-vote centroid
    update, empty words re-seeded from random descriptors (the reference's
    numpy function, same generator and draws)."""
    rng = np.random.default_rng(seed)
    desc = descriptors[rng.permutation(descriptors.shape[0])]
    bits = _unpack_bits_np(desc)                       # (N, 256)
    n = bits.shape[0]
    centers = bits[rng.choice(n, n_words, replace=n < n_words)]
    for _ in range(iters):
        # Hamming distance == squared euclidean on {0,1} vectors
        d = ((bits ** 2).sum(1, keepdims=True)
             - 2.0 * bits @ centers.T + (centers ** 2).sum(1)[None])
        assign = d.argmin(1)
        sums = np.zeros((n_words, bits.shape[1]), np.float32)
        np.add.at(sums, assign, bits)
        counts = np.bincount(assign, minlength=n_words).astype(np.float32)
        upd = counts > 0
        centers[upd] = (sums[upd] / counts[upd, None]) >= 0.5
        n_empty = int((~upd).sum())
        if n_empty:
            centers[~upd] = bits[rng.choice(n, n_empty)]
    return _pack_bits_np(centers)


# descriptors per assignment block: (block, W) f32 distances stay at
# 256 MiB for W = 2048 (the whole pool at 256 keyframes x 1024 keypoints
# would be 2.1 GB)
_ASSIGN_BLOCK = 32768


def _unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(n, 8) 32-bit words -> (n, 256) float32 {0, 1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], -1).to(torch.float32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(W, 256) {0, 1} -> (W, 8) int32 holding the uint32 words."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = (bits.to(torch.int64).reshape(bits.shape[0], 8, 32) << shifts).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def train_vocabulary_device(desc: torch.Tensor, valid: torch.Tensor,
                            n_words: int, iters: int,
                            perm=None) -> torch.Tensor:
    """Binary k-means on the device: (n, 8) packed descriptors + validity
    -> (n_words, 8) int32 words (uint32 bits).  The word seeds walk `perm`
    (a permutation of range(n); if None, one drawn from a generator
    seeded 0 on the device) with the valid rows first; empty words keep
    their previous centroid.  Distances are popcount(x) - 2 x.c +
    popcount(c) from one f32 matmul per block of descriptors: products of
    0/1 summed to at most 256 are exact in f32 in any order, as are the
    integer sums and counts of the centroid update."""
    n = desc.shape[0]
    dev = desc.device
    bits = _unpack_bits(desc)                                 # (n, 256)
    vf = valid.to(torch.float32)
    bitsf = bits * vf[:, None]
    if perm is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        perm = torch.randperm(n, generator=gen, device=dev)
    elif not isinstance(perm, torch.Tensor):
        perm = torch.from_numpy(np.array(perm, np.int64))
    perm = perm.to(device=dev, dtype=torch.int64)
    perm = perm[torch.argsort((~valid[perm]).to(torch.int8), stable=True)]
    n_valid = torch.clamp(valid.sum(), min=1)
    seed_idx = perm[torch.arange(n_words, device=dev) % n_valid]
    centers = bits[seed_idx]                                  # (W, 256)
    pop = bits.sum(1)
    for _ in range(iters):
        cpop = centers.sum(1)
        assign = torch.empty(n, dtype=torch.int64, device=dev)
        for lo in range(0, n, _ASSIGN_BLOCK):
            hi = min(lo + _ASSIGN_BLOCK, n)
            d = pop[lo:hi, None] - 2.0 * (bits[lo:hi] @ centers.T) \
                + cpop[None]
            d = torch.where(valid[lo:hi, None], d, float("inf"))
            assign[lo:hi] = torch.argmin(d, dim=1)
        sums = torch.zeros((n_words, bits.shape[1]), dtype=torch.float32,
                           device=dev).index_add_(0, assign, bitsf)
        counts = torch.zeros(n_words, dtype=torch.float32,
                             device=dev).index_add_(0, assign, vf)
        upd = counts > 0
        new_c = (sums / torch.clamp(counts[:, None], min=1.0)) >= 0.5
        centers = torch.where(upd[:, None], new_c.to(torch.float32), centers)
    return _pack_bits(centers >= 0.5)


def bow_rows(kf_desc: torch.Tensor, kf_kp_valid: torch.Tensor,
             vocab: torch.Tensor, n_words: int) -> torch.Tensor:
    """BoW rows of every keyframe at once: (K, N, 8) descriptors ->
    (K, W) L1-normalized tf matrix (the place-recognition database rebuilt
    after a vocabulary retrain)."""
    d = hamming.pairwise_hamming_pm1(kf_desc, vocab)        # (K, N, W)
    w = torch.argmin(d, dim=-1)
    v = torch.zeros(kf_desc.shape[0], n_words, dtype=torch.float32,
                    device=kf_desc.device)
    v = v.scatter_add(1, w, kf_kp_valid.to(torch.float32))
    return v / torch.clamp(v.sum(1, keepdim=True), min=1e-9)


def pretrained_vocabulary_path() -> str:
    return os.path.join(_PACKAGE, "assets", "vocab.npz")


@functools.lru_cache(maxsize=1)
def load_pretrained_vocabulary() -> Optional[np.ndarray]:
    """The shipped offline-trained vocabulary as (n_words, 8) uint32, or
    None if absent (the reference's ORBvoc.txt load, System.cc:61-72)."""
    path = pretrained_vocabulary_path()
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return np.ascontiguousarray(z["words"].astype(np.uint32))


def synthetic_default_vocabulary(n_words: int = 1024) -> np.ndarray:
    """Deterministic fallback vocabulary from random bit centroids (the
    reference's, same generator and seed)."""
    rng = np.random.default_rng(7)
    return rng.integers(0, 2 ** 32, (n_words, 8), dtype=np.uint32)


def vocab_tensor(vocab: np.ndarray, device) -> torch.Tensor:
    """(W, 8) uint32 numpy -> int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(vocab, np.uint32)).view(np.int32)).to(device)


def assign_words(desc: torch.Tensor, valid: torch.Tensor,
                 vocab: torch.Tensor) -> torch.Tensor:
    """(N, 8) descriptors -> (N,) int32 word ids (-1 for invalid); ties go
    to the lowest word id."""
    d = hamming.pairwise_hamming_pm1(desc, vocab)      # (N, W)
    w = torch.argmin(d, dim=1).to(torch.int32)
    return torch.where(valid, w, -1)


def bow_vector(word_ids: torch.Tensor, valid: torch.Tensor,
               n_words: int) -> torch.Tensor:
    """(N,) word ids -> (W,) L1-normalized tf vector."""
    w = torch.clamp(word_ids, min=0).long()
    v = torch.zeros(n_words, dtype=torch.float32, device=w.device)
    v = v.index_add(0, w, valid.to(torch.float32))
    return v / torch.clamp(v.sum(), min=1e-9)


def l1_scores(query: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity of (W,) query vs (K, W) database -> (K,)."""
    return 1.0 - 0.5 * (db - query[None, :]).abs().sum(dim=1)

"""Bag-of-binary-words place recognition (port of coslam_tpu/ops/bow.py:
the vocabulary loaders, `assign_words`, `bow_vector`, `l1_scores`).

A flat vocabulary of W word centroids, (W, 8) int32 tensors holding the
reference's uint32 bits; word assignment for all keypoints of a frame is
one (N, W) Hamming argmin, computed as the exact +/-1 matmul
(`hamming.pairwise_hamming_pm1`, the reference's `pairwise_hamming_mxu`).
BoW vectors are dense (W,) L1-normalized tf weights; similarity is the
DBoW2 L1 score s(v, w) = 1 - 0.5 * |v - w|_1.

The vocabulary file is the one the JAX package ships
(`coslam_tpu/assets/vocab.npz`), read as data.  Online training
(`train_vocabulary*`, `bow_rows`) is not ported yet (ROADMAP Queue 1
item 11).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from coslam_tpu_torch.ops import hamming

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pretrained_vocabulary_path() -> str:
    return os.path.join(_REPO, "coslam_tpu", "assets", "vocab.npz")


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

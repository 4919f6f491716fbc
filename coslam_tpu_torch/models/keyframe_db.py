"""Keyframe place-recognition database + loop-candidate logic (port of
coslam_tpu/models/keyframe_db.py).

A dense (K, W) host matrix of BoW rows replaces the reference's inverted
file (KeyFrameDatabase.cc:76-196); a query is one tf-idf-weighted L1 pass.
The vocabulary lives on the System's device (`vocab`), the rows and the
loop detector's consistency groups on the host as numpy, exactly as in the
JAX package.  The reference's acceptance policy is preserved: score above
the minimum covisible score (DetectLoop, LoopClosing.cc:122-138), temporal
separation, and covisibility consistency over >= 3 consecutive keyframes
(LoopClosing.cc:43).  Without a pretrained vocabulary the words are
retrained online at growth milestones (`maybe_retrain`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from coslam_tpu_torch.config import SystemConfig
from coslam_tpu_torch.models import map_state as ms
from coslam_tpu_torch.ops import bow
from coslam_tpu_torch.utils import profiling
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class KeyFrameDatabase:
    def __init__(self, cfg: SystemConfig, vocab: Optional[np.ndarray] = None,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        if vocab is None and cfg.loop.vocab_pretrained:
            # reference System.cc:61-72: the vocabulary is a startup
            # artifact, not something trained inside the pipeline
            vocab = bow.load_pretrained_vocabulary()
        W = cfg.loop.vocab_words or \
            cfg.loop.vocab_branching ** cfg.loop.vocab_depth
        self.vocab = bow.vocab_tensor(
            vocab if vocab is not None
            else bow.synthetic_default_vocabulary(W), self.device)
        self.n_words = int(self.vocab.shape[0])
        self._external_vocab = vocab is not None
        self._n_added = 0
        # injected k-means seed permutations per retrain milestone
        # (`_n_added`), else drawn from a generator seeded 0 (ops/bow.py)
        self.retrain_perms: Dict[int, np.ndarray] = {}
        self.n_device_reads = 0    # device -> host readbacks made here
        K = cfg.mapper.max_keyframes
        self.bows = np.zeros((K, self.n_words), np.float32)  # raw tf, L1-normed
        self.has = np.zeros(K, bool)
        # (groups (C, K) bool, chain lengths (C,)) of the previous insertion
        self._consistent_groups = []
        # tf-idf weight cache, rebuilt only when rows change
        self._version = 0
        self._w_cache: Optional[Tuple[int, np.ndarray, np.ndarray]] = None

    def set_vocabulary(self, vocab: np.ndarray):
        """Install a restored vocabulary (checkpoint resume); it is
        authoritative, so no online retraining follows."""
        self.vocab = bow.vocab_tensor(vocab, self.device)
        self.n_words = int(self.vocab.shape[0])
        self._external_vocab = True
        self._version += 1

    # ------------------------------------------------------------------
    def compute_bow(self, desc: torch.Tensor,
                    valid: torch.Tensor) -> np.ndarray:
        words = bow.assign_words(desc, valid, self.vocab)
        self.n_device_reads += 1
        return bow.bow_vector(words, valid, self.n_words).cpu().numpy()

    def add(self, kf_id: int, desc: torch.Tensor, valid: torch.Tensor):
        self.bows[kf_id] = self.compute_bow(desc, valid)
        self.has[kf_id] = True
        self._n_added += 1
        self._version += 1

    def add_row(self, kf_id: int, bow_row: np.ndarray):
        """Store a BoW row computed inside the backend insert
        (local_mapping.backend_insert)."""
        self.bows[kf_id] = bow_row
        self.has[kf_id] = True
        self._n_added += 1
        self._version += 1

    def maybe_retrain(self, m) -> None:
        """Online vocabulary (re)training at growth milestones
        (`LoopConfig.vocab_retrain_at` keyframes added), only without a
        pretrained vocabulary: binary k-means over the descriptors of all
        current keyframes on the device (6 iterations), then every stored
        BoW row is recomputed under the new words and the tf-idf cache is
        invalidated."""
        if self._external_vocab or \
                self._n_added not in self.cfg.loop.vocab_retrain_at:
            return
        kf_valid = m.kf_valid.cpu().numpy()
        ok = m.kf_kp_valid & m.kf_valid[:, None]
        self.n_device_reads += 2
        if not kf_valid.any() or int(ok.sum()) < 512:
            return
        K, N = m.kf_obs_pt.shape
        vocab = bow.train_vocabulary_device(
            m.kf_desc.reshape(K * N, -1), ok.reshape(-1), self.n_words, 6,
            perm=self.retrain_perms.get(self._n_added))
        rows = bow.bow_rows(m.kf_desc, ok, vocab, self.n_words)
        self.vocab = vocab
        self.n_device_reads += 1
        rows_np = rows.cpu().numpy()
        upd = self.has & kf_valid[: len(self.has)]
        self.bows[upd] = rows_np[: len(self.has)][upd]
        self._version += 1

    # ------------------------------------------------------------------
    def remap(self, kf_map: np.ndarray, new_K: int):
        """Repack BoW rows after map compaction (models/compaction.py): row
        i moves to kf_map[i]; culled rows are dropped.  Consistency chains
        reference old indices, so they restart."""
        bows = np.zeros((new_K, self.n_words), np.float32)
        has = np.zeros(new_K, bool)
        src = np.nonzero(kf_map >= 0)[0]
        bows[kf_map[src]] = self.bows[src]
        has[kf_map[src]] = self.has[src]
        self.bows, self.has = bows, has
        self._consistent_groups = []
        self._version += 1

    def grow(self, new_K: int):
        if new_K <= self.bows.shape[0]:
            return
        pad = new_K - self.bows.shape[0]
        self.bows = np.concatenate(
            [self.bows, np.zeros((pad, self.n_words), np.float32)])
        self.has = np.concatenate([self.has, np.zeros(pad, bool)])
        self._version += 1

    # ------------------------------------------------------------------
    def _tfidf_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        """(idf (W,), normalized weight matrix (K, W)), cached per DB
        version."""
        if self._w_cache is not None and self._w_cache[0] == self._version:
            return self._w_cache[1], self._w_cache[2]
        n = max(int(self.has.sum()), 1)
        df = (self.bows > 0).sum(0)
        idf = np.log(n / (1.0 + df)).clip(min=0.0)
        w = self.bows * idf[None]
        norm = np.abs(w).sum(1, keepdims=True)
        w = w / np.maximum(norm, 1e-9)
        self._w_cache = (self._version, idf, w)
        return idf, w

    def scores_against_all(self, kf_id: int,
                           rows: Optional[np.ndarray] = None) -> np.ndarray:
        """tf-idf-weighted L1 similarity of `kf_id` vs every stored KF, or
        vs the KFs of `rows` alone (the same numbers, in their order)."""
        return self.scores_for_bow(self.bows[kf_id], rows)

    def scores_for_bow(self, row: np.ndarray,
                       rows: Optional[np.ndarray] = None) -> np.ndarray:
        """tf-idf-weighted L1 similarity of an external BoW row vs every
        stored KF, or vs the KFs of `rows` alone."""
        idf, w = self._tfidf_weights()
        q = row * idf
        q = q / max(np.abs(q).sum(), 1e-9)
        if rows is not None:
            w = w[rows]
        return 1.0 - 0.5 * np.abs(w - q[None]).sum(1)

    # ------------------------------------------------------------------
    def detect_reloc_candidates(self, desc: torch.Tensor, valid: torch.Tensor,
                                top_k: int = 5) -> List[int]:
        """Best keyframes for relocalizing a lost frame (reference
        KeyFrameDatabase::DetectRelocalizationCandidates,
        KeyFrameDatabase.cc:199: the same scoring, no temporal or
        covisibility exclusion).  On the host, in numpy, as the reference."""
        if not self.has.any():
            return []
        q = self.compute_bow(desc, valid)
        scores = np.where(self.has, self.scores_for_bow(q), -1.0)
        order = np.argsort(-scores)[:top_k]
        return [int(i) for i in order if scores[i] > 0]

    # ------------------------------------------------------------------
    def detect_loop_candidates(self, m: ms.MapState, kf_id: int,
                               covis_row: np.ndarray) -> List[int]:
        """Score-sorted, covisibility-consistent loop candidates for the
        newly inserted keyframe (reference LoopClosing::DetectLoop).

        Per-insertion cost is O(C*K): candidate covisibility groups come
        from one device matmul over the candidate subset
        (map_state.covisibility_rows) and the consistency chains are one
        boolean matrix product against the previous insertion's groups."""
        lcfg = self.cfg.loop
        if not self.has[kf_id]:
            return []
        scores = self.scores_against_all(kf_id)

        connected = covis_row >= self.cfg.mapper.covis_edge_threshold
        covis_scores = scores[connected & self.has]
        min_score = float(covis_scores.min()) if covis_scores.size else 0.1

        K = len(self.has)
        eligible = (self.has & ~connected
                    & (np.arange(K) != kf_id)
                    & (np.abs(np.arange(K) - kf_id)
                       > lcfg.min_kfs_between_loops))
        cand = np.nonzero(eligible & (scores >= max(min_score, 0.02)))[0]
        if cand.size == 0:
            self._consistent_groups = []
            return []

        self.n_device_reads += 1
        rows = ms.covisibility_rows(
            m, torch.as_tensor(cand, device=m.kf_valid.device))
        with profiling.span("sync.loop", kf=kf_id):
            rows = rows.cpu().numpy()                     # (C, K)
        groups = rows >= self.cfg.mapper.covis_edge_threshold
        groups[np.arange(cand.size), cand] = True         # (C, K) bool
        prev_groups, prev_counts = self._consistent_groups \
            if self._consistent_groups else (np.zeros((0, K), bool),
                                             np.zeros(0, np.int32))
        if prev_groups.shape[1] != K:                     # capacity grew
            pg = np.zeros((prev_groups.shape[0], K), bool)
            pg[:, : prev_groups.shape[1]] = prev_groups[:, :K]
            prev_groups = pg
        # (C, G) overlap matrix -> per-candidate best chain length
        overlap = groups @ prev_groups.T                  # bool matmul
        best = np.where(overlap, prev_counts[None, :] + 1, 0).max(axis=1) \
            if prev_groups.shape[0] else np.zeros(cand.size, np.int32)
        self._consistent_groups = (groups, best.astype(np.int32))
        ok = best + 1 >= lcfg.covis_consistency_th
        chosen = cand[ok]
        order = np.argsort(-scores[chosen])
        return [int(c) for c in chosen[order]]

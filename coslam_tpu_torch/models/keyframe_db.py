"""Keyframe place-recognition database (port of coslam_tpu/models/
keyframe_db.py: the constructor through `detect_reloc_candidates`).

A dense (K, W) host matrix of BoW rows replaces the reference's inverted
file (KeyFrameDatabase.cc:76-196); a query is one tf-idf-weighted L1 pass.
The vocabulary lives on the System's device (`vocab`), the rows on the
host as numpy, exactly as in the JAX package.  Still to port: online
vocabulary retraining (ROADMAP Queue 1 item 11) and
`detect_loop_candidates` (item 13).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from coslam_tpu_torch.config import SystemConfig
from coslam_tpu_torch.ops import bow
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
        K = cfg.mapper.max_keyframes
        self.bows = np.zeros((K, self.n_words), np.float32)  # raw tf, L1-normed
        self.has = np.zeros(K, bool)
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
        """Online vocabulary retraining at growth milestones — only without
        a pretrained vocabulary.  Raises where the reference would really
        retrain: that path is not ported yet."""
        if self._external_vocab or \
                self._n_added not in self.cfg.loop.vocab_retrain_at:
            return
        ok = m.kf_kp_valid & m.kf_valid[:, None]
        if not bool(m.kf_valid.any()) or int(ok.sum()) < 512:
            return
        raise NotImplementedError(
            "online vocabulary retraining (no pretrained vocabulary) is not "
            "ported yet (ROADMAP Queue 1 item 11); use the shipped "
            "vocabulary (LoopConfig.vocab_pretrained=True)")

    # ------------------------------------------------------------------
    def remap(self, kf_map: np.ndarray, new_K: int):
        """Repack BoW rows after map compaction (models/compaction.py): row
        i moves to kf_map[i]; culled rows are dropped."""
        bows = np.zeros((new_K, self.n_words), np.float32)
        has = np.zeros(new_K, bool)
        src = np.nonzero(kf_map >= 0)[0]
        bows[kf_map[src]] = self.bows[src]
        has[kf_map[src]] = self.has[src]
        self.bows, self.has = bows, has
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

    def scores_against_all(self, kf_id: int) -> np.ndarray:
        """tf-idf-weighted L1 similarity of `kf_id` vs every stored KF."""
        return self.scores_for_bow(self.bows[kf_id])

    def scores_for_bow(self, row: np.ndarray) -> np.ndarray:
        """tf-idf-weighted L1 similarity of an external BoW row vs every
        stored KF."""
        idf, w = self._tfidf_weights()
        q = row * idf
        q = q / max(np.abs(q).sum(), 1e-9)
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

"""Map-slot recycling: compaction and geometric capacity growth (port of
coslam_tpu/models/compaction.py, whole).

  * `compact` — repack the valid keyframe / point rows into the low slots,
    in stable order, and return the old->new index maps so the System can
    remap everything that names a slot (trajectory anchors, BoW rows,
    last-frame associations).
  * `grow` — double the capacities when compaction cannot free enough.

Compaction runs on host numpy, as in the reference: it is rare (capacity
watermarks), touches every array once, and returns the new map on the old
map's device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from coslam_tpu_torch.config import SystemConfig
from coslam_tpu_torch.models import map_state as ms


def _index_map(valid: np.ndarray) -> Tuple[np.ndarray, int]:
    """old->new slot map (-1 for dropped rows) keeping stable order."""
    new_idx = np.cumsum(valid) - 1
    return np.where(valid, new_idx, -1).astype(np.int32), int(valid.sum())


def compact(cfg: SystemConfig, m: ms.MapState
            ) -> Tuple[ms.MapState, np.ndarray, np.ndarray]:
    """Repack valid keyframes/points into low slots.

    Returns (new_map, kf_map, pt_map) where *_map are (K,)/(P,) old->new
    index arrays with -1 for culled rows."""
    dev = m.pt_pos.device
    a = {k: v.cpu().numpy() for k, v in m._asdict().items()}
    K, N = a["kf_obs_pt"].shape
    kf_valid, pt_valid = a["kf_valid"], a["pt_valid"]
    kf_map, n_kf = _index_map(kf_valid)
    pt_map, n_pt = _index_map(pt_valid)
    kf_src = np.nonzero(kf_valid)[0]
    pt_src = np.nonzero(pt_valid)[0]

    def pack_kf(arr, fill=0):
        out = np.full_like(arr, fill)
        out[:n_kf] = arr[kf_src]
        return out

    def pack_pt(arr, fill=0):
        out = np.full_like(arr, fill)
        out[:n_pt] = arr[pt_src]
        return out

    # associations: gather valid KF rows, remap point ids (culled -> -1)
    obs = a["kf_obs_pt"]
    obs = np.where(obs >= 0, pt_map[np.maximum(obs, 0)], -1)
    obs_new = np.full_like(obs, -1)
    obs_new[:n_kf] = obs[kf_src]

    # per-point keyframe references; a culled reference falls back to the
    # nearest surviving earlier keyframe
    alive_before = np.maximum(np.cumsum(kf_valid) - 1, 0).astype(np.int32)
    ref_safe = np.clip(a["pt_ref_kf"], 0, K - 1)
    ref_new = np.where(kf_map[ref_safe] >= 0, kf_map[ref_safe],
                       alive_before[ref_safe])
    # pt_first_kf stores a keyframe COUNT at creation time (for age);
    # translate it to the surviving-keyframe count
    first = np.clip(a["pt_first_kf"], 0, K)
    first_new = np.concatenate([[0], np.cumsum(kf_valid)])[first]

    kf_pose_new = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    kf_pose_new[:n_kf] = a["kf_pose"][kf_src]

    out = dict(
        kf_pose=kf_pose_new,
        kf_valid=pack_kf(kf_valid, False),
        kf_frame_id=pack_kf(a["kf_frame_id"], -1),
        kf_uv=pack_kf(a["kf_uv"]),
        kf_level=pack_kf(a["kf_level"]),
        kf_angle=pack_kf(a["kf_angle"]),
        kf_desc=pack_kf(a["kf_desc"]),
        kf_kp_valid=pack_kf(a["kf_kp_valid"], False),
        kf_obs_pt=obs_new,
        pt_pos=pack_pt(a["pt_pos"]),
        pt_valid=pack_pt(pt_valid, False),
        pt_desc=pack_pt(a["pt_desc"]),
        pt_normal=pack_pt(a["pt_normal"]),
        pt_max_dist=pack_pt(a["pt_max_dist"]),
        pt_ref_kf=pack_pt(ref_new.astype(np.int32), -1),
        pt_first_kf=pack_pt(first_new.astype(np.int32), -1),
        pt_visible=pack_pt(a["pt_visible"]),
        pt_found=pack_pt(a["pt_found"]),
        n_kf=np.asarray(n_kf, np.int32),
        n_pt=np.asarray(n_pt, np.int32),
    )
    new = ms.MapState(**{k: torch.from_numpy(np.array(v)).to(dev)
                         for k, v in out.items()})
    return new, kf_map, pt_map


def grow(cfg: SystemConfig, m: ms.MapState, new_K: int = 0, new_P: int = 0
         ) -> Tuple[SystemConfig, ms.MapState]:
    """Return (cfg', map') with enlarged capacities (2x by default).  All
    existing rows keep their slots; only the capacity tails grow."""
    K, N = m.kf_obs_pt.shape
    P = m.pt_pos.shape[0]
    new_K = new_K or 2 * K
    new_P = new_P or 2 * P
    cfg2 = cfg.replace(mapper=dataclasses.replace(
        cfg.mapper, max_keyframes=new_K, max_points=new_P))
    big = ms.empty_map(cfg2, m.pt_pos.device)

    fields = {}
    for name in m._fields:
        o, n = getattr(m, name), getattr(big, name)
        if o.dim() == 0:
            fields[name] = o
        else:
            n = n.clone()
            n[tuple(slice(0, s) for s in o.shape)] = o
            fields[name] = n
    return cfg2, ms.MapState(**fields)

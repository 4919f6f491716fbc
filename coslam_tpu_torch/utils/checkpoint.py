"""Map checkpoint / resume (port of coslam_tpu/utils/checkpoint.py:
`save_map`, `load_map`, `load_system`).

This is the converter from the JAX package's state to the port's: a
checkpoint written by `coslam_tpu.utils.checkpoint.save_system` is an npz of
numpy arrays; loading it here gives device tensors.  uint32 descriptors
become int32 tensors with the same bits (`.view(np.int32)`).  The
place-recognition `db_*` extras are kept as numpy on the System
(`System.db_state`) until relocalization is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from coslam_tpu_torch.models import map_state as ms


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def save_map(path: str, m: ms.MapState, extra: Optional[dict] = None) -> None:
    """Write the map in the reference's checkpoint layout (descriptors as
    uint32, so either package can load the file)."""
    arrays = {}
    for k, v in m._asdict().items():
        a = v.detach().cpu().numpy()
        if k.endswith("_desc"):
            a = a.view(np.uint32)
        arrays[f"map_{k}"] = a
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_map(path: str, device="cpu"):
    """Returns (MapState on `device`, extra dict of numpy arrays)."""
    fields, extra = {}, {}
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            if k.startswith("map_"):
                fields[k[4:]] = _to_tensor(z[k], device)
            elif k.startswith("extra_"):
                extra[k[6:]] = z[k]
    return ms.MapState(**fields), extra


def load_system(path: str, system) -> None:
    """Restore a checkpoint into an already-constructed System (same cfg),
    on the System's device."""
    m, extra = load_map(path, system.device)
    system.map = m
    system._kf_pose_host = None
    system._host_n_kf = int(m.n_kf)
    K_saved = int(extra.get("max_keyframes", m.kf_pose.shape[0]))
    P_saved = int(extra.get("max_points", m.pt_pos.shape[0]))
    if (K_saved != system.cfg.mapper.max_keyframes
            or P_saved != system.cfg.mapper.max_points):
        system.cfg = system.cfg.replace(mapper=dataclasses.replace(
            system.cfg.mapper, max_keyframes=K_saved, max_points=P_saved))
    system.last_T = extra["last_T"].astype(np.float32)
    system.velocity = (extra["velocity"].astype(np.float32)
                       if extra["velocity"].size else None)
    if extra["last_kp_pt"].size:
        system.last_kp_pt = _to_tensor(
            extra["last_kp_pt"].astype(np.int32), system.device)
        system.last_level = _to_tensor(
            extra["last_level"].astype(np.int32), system.device)
    system.frames_since_kf = int(extra["frames_since_kf"])
    system.ref_kf_matches = int(extra["ref_kf_matches"])
    system.state = "OK" if int(extra["state_ok"]) else "NOT_INITIALIZED"
    system.db_state = {k[3:]: v for k, v in extra.items()
                       if k.startswith("db_")}

"""Map checkpoint / resume (port of coslam_tpu/utils/checkpoint.py, whole:
`save_map`, `load_map`, `save_system`, `load_system`).

Files are the JAX package's layout, so either package loads what the other
wrote: an npz of numpy arrays, descriptors as uint32 (int32 tensors with the
same bits in the port, `.view(np.int32)`).  `load_system` restores the map,
the tracking state, the host mirrors of the slot counters, the
place-recognition database (BoW rows and vocabulary, which is then
authoritative) and, when the saved capacities differ from the System's
config, widens the config to them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from coslam_tpu_torch.models import map_state as ms
from coslam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


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


def load_map(path: str, device=DEFAULT_DEVICE):
    """Returns (MapState on `device`, extra dict of numpy arrays)."""
    device = resolve_device(device)
    fields, extra = {}, {}
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            if k.startswith("map_"):
                fields[k[4:]] = _to_tensor(z[k], device)
            elif k.startswith("extra_"):
                extra[k[6:]] = z[k]
    return ms.MapState(**fields), extra


def save_system(path: str, system) -> None:
    """Checkpoint a System (map + tracking state) for resume."""
    extra = {
        "last_T": system.last_T,
        "velocity": system.velocity if system.velocity is not None
        else np.zeros((0,)),
        "last_kp_pt": system.last_kp_pt.cpu().numpy()
        if system.last_kp_pt is not None else np.zeros((0,)),
        "last_level": system.last_level.cpu().numpy()
        if system.last_level is not None else np.zeros((0,)),
        "frames_since_kf": system.frames_since_kf,
        "ref_kf_matches": system.ref_kf_matches,
        "state_ok": 1 if system.state == "OK" else 0,
        "db_bows": system.db.bows,
        "db_has": system.db.has,
        "db_vocab": system.db.vocab.cpu().numpy().view(np.uint32),
        # capacities may have grown past the construction-time cfg
        # (models/compaction.py grow)
        "max_keyframes": system.cfg.mapper.max_keyframes,
        "max_points": system.cfg.mapper.max_points,
    }
    save_map(path, system.map, extra)


def load_system(path: str, system) -> None:
    """Restore a checkpoint into an already-constructed System, on the
    System's device."""
    m, extra = load_map(path, system.device)
    system.map = m
    system._kf_pose_dirty = True
    system._host_n_kf = int(m.n_kf)
    system._host_n_pt = int(m.n_pt)
    # restore (possibly grown) capacities so the watermark logic and the
    # DB match the restored array shapes
    K_saved = int(extra.get("max_keyframes", m.kf_pose.shape[0]))
    P_saved = int(extra.get("max_points", m.pt_pos.shape[0]))
    if (K_saved != system.cfg.mapper.max_keyframes
            or P_saved != system.cfg.mapper.max_points):
        system._set_cfg(system.cfg.replace(mapper=dataclasses.replace(
            system.cfg.mapper, max_keyframes=K_saved, max_points=P_saved)))
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
    system.db.bows = extra["db_bows"]
    system.db.has = extra["db_has"]
    system.db.set_vocabulary(extra["db_vocab"])

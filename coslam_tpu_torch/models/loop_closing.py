"""Loop closing (port of coslam_tpu/models/loop_closing.py: so far only
`fuse_landmarks`, which the keyframe backend's neighbour fuse uses).

The loop detector, Sim3 verification, loop correction and global BA wait
for ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import torch

from coslam_tpu_torch.config import SystemConfig
from coslam_tpu_torch.models import map_state as ms


def fuse_landmarks(cfg: SystemConfig, m: ms.MapState, pt_from, pt_to,
                   pair_ok) -> ms.MapState:
    """Merge duplicate landmarks: every observation of pt_from[i] is
    re-pointed at pt_to[i] and pt_from[i] is invalidated (the analogue of
    MapPoint::Replace, reference MapPoint.cc:177, as one index remap over
    the whole observation table).  Where two pairs name one pt_from, the
    later pair wins, as in the reference's scatter."""
    P = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    ids = torch.arange(P, dtype=torch.int32, device=dev)
    tgt = torch.where(pair_ok, pt_from, P - 1)
    remap = ms.scatter_set(ids, tgt, torch.where(pair_ok, pt_to.to(torch.int32),
                                                 P - 1))
    remap = torch.where(ids == P - 1, P - 1, remap)
    obs = m.kf_obs_pt
    obs = torch.where(obs >= 0, remap[torch.clamp(obs, min=0).long()], obs)
    fused_away = ms.scatter_set(torch.zeros(P, dtype=torch.bool, device=dev),
                                tgt, pair_ok)
    fused_away = fused_away & (ids != remap)
    return m._replace(kf_obs_pt=obs, pt_valid=m.pt_valid & ~fused_away)

"""Render-loop driver (reference Viewer, ORB_SLAM2/src/Viewer.cc; port of
coslam_tpu/viz/viewer.py reading the port's System, whose tensors it takes
to the host).

The reference runs a Pangolin window thread at camera fps with menu toggles
(follow camera / show points / show keyframes / show graph / localization
mode / reset, Viewer.cc:68-75) plus an OpenCV imshow of the FrameDrawer
output.  Here the viewer is a host-side object the driver calls once per
tracked frame; every `every`-th call it rasterizes the frame overlay and the
map view and writes them as PNGs under `out_dir` (headless equivalent of the
two windows).  The toggles are constructor flags.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from coslam_tpu_torch.viz import frame_drawer, map_drawer


class Viewer:
    def __init__(self, out_dir: str,
                 every: int = 10,
                 follow: bool = True,
                 show_points: bool = True,
                 show_keyframes: bool = True,
                 show_graph: bool = True,
                 viewpoint: Optional[map_drawer.MapViewpoint] = None,
                 draw_frames: bool = True,
                 draw_maps: bool = True):
        self.out_dir = out_dir
        self.every = max(1, every)
        self.follow = follow
        self.show_points = show_points
        self.show_keyframes = show_keyframes
        self.show_graph = show_graph
        self.viewpoint = viewpoint or map_drawer.MapViewpoint()
        self.draw_frames = draw_frames
        self.draw_maps = draw_maps
        self._n = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, system, img: np.ndarray, frame,
               frame_id: int) -> None:
        """Render one tick from the live System (tracked mask comes from
        System.last_kp_pt — keypoint->map-point association of the frame
        just tracked, the same data FrameDrawer::Update copies under lock,
        FrameDrawer.cc:167)."""
        from PIL import Image

        self._n += 1
        if (self._n - 1) % self.every:
            return
        m = system.map
        n_kf = int(m.kf_valid.sum())
        n_pt = int(m.pt_valid.sum())
        uv = frame.uv.cpu().numpy()
        kp_pt = system.last_kp_pt.cpu().numpy() \
            if system.last_kp_pt is not None else np.full(len(uv), -1)
        tracked = kp_pt >= 0

        if self.draw_frames:
            fr = frame_drawer.draw_frame(
                np.asarray(img), uv, frame.valid.cpu().numpy(), tracked,
                state=system.state, n_kfs=n_kf, n_points=n_pt,
                n_matches=int(tracked.sum()),
                localization_only=getattr(system, "localization_only", False))
            Image.fromarray(fr).save(
                os.path.join(self.out_dir, f"frame_{frame_id:06d}.png"))

        if self.draw_maps and n_kf:
            loop_edges = (system.loop_closer.loop_edges
                          if system.loop_closer is not None else [])
            tracked_ids = kp_pt[tracked]
            mp = map_drawer.draw_map(
                m, current_T_cw=system.last_T,
                viewpoint=self.viewpoint, follow=self.follow,
                show_points=self.show_points,
                show_keyframes=self.show_keyframes,
                show_graph=self.show_graph,
                loop_edges=loop_edges,
                tracked_pt_ids=tracked_ids)
            Image.fromarray(mp).save(
                os.path.join(self.out_dir, f"map_{frame_id:06d}.png"))

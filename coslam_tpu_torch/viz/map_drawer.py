"""Virtual-camera map rendering (reference MapDrawer,
ORB_SLAM2/src/MapDrawer.cc; port of coslam_tpu/viz/map_drawer.py: the
map's tensors are taken to the host with `.cpu()`).

Draws, like the reference GL pass: map points (black, `DrawMapPoints`
MapDrawer.cc:44), keyframe frusta (blue wireframe pyramids, `DrawKeyFrames`
:83), the covisibility graph for weights >= 100 plus the spanning tree
(green lines) and loop edges (red here for distinguishability; reference
draws all graph lines green, :120-176), and the current camera (green
frustum, `DrawCurrentCamera` :179).  Projection uses a simple look-at
pinhole virtual camera instead of Pangolin's OpenGlRenderState
(Viewer.cc:59-66 viewpoint parameters map 1:1 onto `MapViewpoint`).

The spanning tree is *derived* (parent = strongest-covisibility earlier
keyframe — how reference KeyFrame::UpdateConnections first assigns parents,
KeyFrame.cc:341-349) since the functional map state doesn't store parent
pointers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from coslam_tpu_torch.models import map_state as ms

POINT_COLOR = (20, 20, 20)
REF_POINT_COLOR = (230, 40, 40)
KF_COLOR = (60, 70, 230)
GRAPH_COLOR = (40, 180, 80)
LOOP_COLOR = (220, 40, 40)
CUR_COLOR = (30, 200, 30)


@dataclass
class MapViewpoint:
    """Virtual camera (reference Viewer.cc:46-52 Viewer.ViewpointX/Y/Z/F)."""
    x: float = 0.0
    y: float = -4.0
    z: float = -6.0
    f: float = 400.0
    width: int = 800
    height: int = 600


def spanning_tree(covis: np.ndarray, kf_valid: np.ndarray) -> np.ndarray:
    """(K,) parent index per keyframe (-1 for roots/invalid).

    Parent = earlier valid keyframe with the highest covisibility weight
    (reference KeyFrame::UpdateConnections initial parenting,
    KeyFrame.cc:341-349).
    """
    K = covis.shape[0]
    parent = np.full(K, -1, np.int32)
    for i in range(1, K):
        if not kf_valid[i]:
            continue
        w = covis[i, :i].copy()
        w[~kf_valid[:i]] = -1
        j = int(np.argmax(w)) if i > 0 else -1
        if i > 0 and w[j] > 0:
            parent[i] = j
        elif kf_valid[:i].any():
            parent[i] = int(np.nonzero(kf_valid[:i])[0][-1])
    return parent


def _look_at(vp: MapViewpoint, target: np.ndarray) -> np.ndarray:
    """World->view 4x4 for a camera at vp looking at `target` (like
    ModelViewLookAt in Viewer.cc:64)."""
    eye = np.array([vp.x, vp.y, vp.z], np.float64) + target
    fwd = target - eye
    n = np.linalg.norm(fwd)
    fwd = fwd / n if n > 1e-9 else np.array([0.0, 0.0, 1.0])
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        up = np.array([0.0, 0.0, -1.0])
        right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    R = np.stack([right, up, fwd])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ eye
    return T


class _Projector:
    def __init__(self, vp: MapViewpoint, target: np.ndarray):
        self.vp = vp
        self.Tvw = _look_at(vp, target)

    def __call__(self, pts_w: np.ndarray):
        """(M, 3) world -> ((M, 2) pixel, (M,) in-front mask)."""
        pts = np.asarray(pts_w, np.float64)
        pc = pts @ self.Tvw[:3, :3].T + self.Tvw[:3, 3]
        z = pc[:, 2]
        ok = z > 1e-3
        zs = np.where(ok, z, 1.0)
        u = self.vp.f * pc[:, 0] / zs + self.vp.width / 2.0
        v = self.vp.f * pc[:, 1] / zs + self.vp.height / 2.0
        return np.stack([u, v], 1), ok


def _frustum_segments(T_cw: np.ndarray, size: float) -> np.ndarray:
    """(8, 2, 3) world-space line segments of a camera wireframe pyramid
    (vertex layout of MapDrawer::DrawKeyFrames, MapDrawer.cc:93-120)."""
    w, h, z = size, size * 0.75, size * 0.6
    apex = np.zeros(3)
    corners = np.array([[w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]])
    segs = []
    for c in corners:
        segs.append([apex, c])
    for a, b in zip(corners, np.roll(corners, 1, axis=0)):
        segs.append([a, b])
    segs = np.asarray(segs)  # camera frame
    T_wc = np.linalg.inv(np.asarray(T_cw, np.float64))
    return segs @ T_wc[:3, :3].T + T_wc[:3, 3]


def draw_map(m: ms.MapState,
             current_T_cw: Optional[np.ndarray] = None,
             viewpoint: Optional[MapViewpoint] = None,
             show_points: bool = True,
             show_keyframes: bool = True,
             show_graph: bool = True,
             loop_edges: Sequence[Tuple[int, int]] = (),
             graph_min_weight: int = 100,
             follow: bool = True,
             kf_size: float = 0.08,
             tracked_pt_ids: Optional[np.ndarray] = None,
             auto_fit: bool = True) -> np.ndarray:
    """Render the map to an RGB uint8 array.

    Mirrors the reference render pass content (Viewer.cc:88-127):
    points / keyframes / graph toggles == the Pangolin menu checkboxes;
    `follow` recenters the virtual camera on the current camera position.
    `tracked_pt_ids` points are drawn red (reference draws the *reference*
    map points red, MapDrawer.cc:66-80).
    """
    from PIL import Image, ImageDraw

    vp = viewpoint or MapViewpoint()
    kf_valid = m.kf_valid.cpu().numpy()
    pt_valid = m.pt_valid.cpu().numpy()
    pt_pos = m.pt_pos.cpu().numpy()
    centers = ms.kf_centers(m).cpu().numpy()

    if follow and current_T_cw is not None:
        Twc = np.linalg.inv(np.asarray(current_T_cw, np.float64))
        target = Twc[:3, 3]
    elif kf_valid.any():
        target = centers[kf_valid].mean(0)
    else:
        target = np.zeros(3)

    if auto_fit and kf_valid.any():
        # frame the whole map (the reference's user does this with the
        # mouse; headless we recentre on the scene and fit the distance)
        pts = centers[kf_valid]
        if pt_valid.any():
            pts = np.concatenate([pts, pt_pos[pt_valid]])
        mid = 0.5 * (target + np.median(pts, 0))
        radius = float(np.percentile(np.linalg.norm(pts - mid, axis=1), 90))
        target = mid
        d0 = float(np.linalg.norm([vp.x, vp.y, vp.z]))
        s = max(1.6 * radius, 0.5) / max(d0, 1e-6)
        vp = MapViewpoint(x=vp.x * s, y=vp.y * s, z=vp.z * s, f=vp.f,
                          width=vp.width, height=vp.height)
        kf_size = max(kf_size, 0.05 * radius)

    proj = _Projector(vp, target)
    im = Image.new("RGB", (vp.width, vp.height), (255, 255, 255))
    d = ImageDraw.Draw(im)

    def line(p0, p1, color, width=1):
        d.line([tuple(p0), tuple(p1)], fill=color, width=width)

    # --- map points ---
    if show_points and pt_valid.any():
        pos = pt_pos[pt_valid]
        uv, ok = proj(pos)
        ids = np.nonzero(pt_valid)[0]
        red = np.zeros(len(ids), bool)
        if tracked_pt_ids is not None:
            red = np.isin(ids, np.asarray(tracked_pt_ids))
        for (u, v), o, r in zip(uv, ok, red):
            if o and 0 <= u < vp.width and 0 <= v < vp.height:
                c = REF_POINT_COLOR if r else POINT_COLOR
                d.point((u, v), fill=c)
                d.point((u + 1, v), fill=c)

    covis = None
    if (show_graph or show_keyframes) and kf_valid.any():
        covis = ms.covisibility(m).cpu().numpy()

    # --- covisibility graph + spanning tree + loop edges ---
    if show_graph and kf_valid.any():
        cuv, cok = proj(centers)
        K = len(kf_valid)
        strong = np.argwhere(np.triu(covis, 1) >= graph_min_weight)
        for i, j in strong:
            if kf_valid[i] and kf_valid[j] and cok[i] and cok[j]:
                line(cuv[i], cuv[j], GRAPH_COLOR)
        parent = spanning_tree(covis, kf_valid)
        for i in range(K):
            p = parent[i]
            if p >= 0 and cok[i] and cok[p]:
                line(cuv[i], cuv[p], GRAPH_COLOR)
        for i, j in loop_edges:
            if (0 <= i < K and 0 <= j < K and kf_valid[i] and kf_valid[j]
                    and cok[i] and cok[j]):
                line(cuv[i], cuv[j], LOOP_COLOR, width=2)

    # --- keyframe frusta ---
    if show_keyframes and kf_valid.any():
        poses = m.kf_pose.cpu().numpy()
        for k in np.nonzero(kf_valid)[0]:
            segs = _frustum_segments(poses[k], kf_size)
            uv, ok = proj(segs.reshape(-1, 3))
            uv = uv.reshape(-1, 2, 2)
            ok = ok.reshape(-1, 2)
            for (p0, p1), (o0, o1) in zip(uv, ok):
                if o0 and o1:
                    line(p0, p1, KF_COLOR)

    # --- current camera ---
    if current_T_cw is not None:
        segs = _frustum_segments(np.asarray(current_T_cw), kf_size * 1.6)
        uv, ok = proj(segs.reshape(-1, 3))
        uv = uv.reshape(-1, 2, 2)
        ok = ok.reshape(-1, 2)
        for (p0, p1), (o0, o1) in zip(uv, ok):
            if o0 and o1:
                line(p0, p1, CUR_COLOR, width=2)

    return np.asarray(im)

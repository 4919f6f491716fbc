"""Annotated current-frame rendering (reference FrameDrawer,
ORB_SLAM2/src/FrameDrawer.cc).

`DrawFrame` (FrameDrawer.cc:38-123) paints, on the gray frame: green
square+circle per keypoint matched to a map point, blue for keypoints being
matched during initialization, and a status bar of state text
(`DrawTextInfo`, FrameDrawer.cc:124-166: mode, KF count, map-point count,
match count).  Same content here, rasterized with PIL onto a numpy RGB
array.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

GREEN = (40, 220, 40)
BLUE = (80, 120, 255)
RED = (230, 60, 60)


def _to_rgb(img_gray: np.ndarray) -> np.ndarray:
    img = np.asarray(img_gray)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return img.copy()


def draw_frame(img_gray: np.ndarray,
               uv: np.ndarray,
               valid: np.ndarray,
               tracked: Optional[np.ndarray] = None,
               state: str = "OK",
               n_kfs: int = 0,
               n_points: int = 0,
               n_matches: int = 0,
               localization_only: bool = False,
               radius: int = 4) -> np.ndarray:
    """Return an RGB uint8 image with keypoint overlay + status bar.

    uv: (N, 2) keypoint coords; valid: (N,) extraction mask; tracked: (N,)
    mask of keypoints associated to map points (drawn green; untracked valid
    keypoints drawn blue during initialization, dim otherwise).
    """
    from PIL import Image, ImageDraw

    rgb = _to_rgb(img_gray)
    H, W = rgb.shape[:2]
    im = Image.fromarray(rgb)
    d = ImageDraw.Draw(im)

    uv = np.asarray(uv, np.float32)
    valid = np.asarray(valid, bool)
    if tracked is None:
        tracked = np.zeros(len(uv), bool)
    tracked = np.asarray(tracked, bool) & valid

    initializing = state in ("NOT_INITIALIZED", "NO_IMAGES_YET")
    for (x, y), ok, tr in zip(uv, valid, tracked):
        if not ok or not (0 <= x < W and 0 <= y < H):
            continue
        if tr:
            color = GREEN
        elif initializing:
            color = BLUE
        else:
            continue  # reference only draws matched kps once tracking
        d.rectangle([x - radius, y - radius, x + radius, y + radius],
                    outline=color)
        d.ellipse([x - 1, y - 1, x + 1, y + 1], fill=color)

    # status bar (DrawTextInfo appends a text strip below the image)
    bar_h = 18
    out = Image.new("RGB", (W, H + bar_h), (245, 245, 245))
    out.paste(im, (0, 0))
    d = ImageDraw.Draw(out)
    if state == "LOST":
        mode = "TRACK LOST. TRYING TO RELOCALIZE"
    elif initializing:
        mode = "TRYING TO INITIALIZE"
    elif localization_only:
        mode = "LOCALIZATION"
    else:
        mode = "SLAM MODE"
    text = (f"{mode} | KFs: {n_kfs}, MPs: {n_points}, "
            f"Matches: {n_matches}")
    d.text((4, H + 3), text, fill=(10, 10, 10))
    return np.asarray(out)

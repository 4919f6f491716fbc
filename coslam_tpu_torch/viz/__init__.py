"""Host-side visualization (reference L5: Viewer/FrameDrawer/MapDrawer,
SURVEY.md section 2.1).

The reference renders with Pangolin GL + OpenCV HighGUI windows
(ORB_SLAM2/src/Viewer.cc:54-170).  Rendering is not device work, so here it
is a small pure-host layer (port of coslam_tpu/viz; Pillow is imported where
an image is drawn): numpy/PIL rasterization of (a) the annotated current
frame and (b) a virtual-camera view of the map — written as image files by a
`Viewer` driver instead of opened in GUI windows, with the reference's
content: tracked-keypoint overlay, state text, map points, keyframe frusta,
covisibility graph, spanning tree, loop edges, current camera.
"""

from coslam_tpu_torch.viz.frame_drawer import draw_frame
from coslam_tpu_torch.viz.map_drawer import MapViewpoint, draw_map, spanning_tree
from coslam_tpu_torch.viz.viewer import Viewer

__all__ = ["draw_frame", "draw_map", "spanning_tree", "MapViewpoint",
           "Viewer"]

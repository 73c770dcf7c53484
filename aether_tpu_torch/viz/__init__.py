"""Visualization & 3D export: colormaps, PLY point clouds, GLB scenes, video IO.

Capability parity with reference ``aether/utils/visualize_utils.py`` and the
export half of ``aether/utils/postprocess_utils.py`` (colorize_depth, save_ply,
save_pointmap) — but with zero heavyweight deps: the GLB container and PLY
files are written directly with numpy + struct (trimesh/plyfile are not
available in this image and are not needed).

Copy of ``aether_tpu/viz/__init__.py``.
"""

from aether_tpu_torch.viz.colorize import colorize_depth, depth_video_frames
from aether_tpu_torch.viz.glb import predictions_to_glb, write_glb
from aether_tpu_torch.viz.ply import save_ply, save_pointmap, write_ply
from aether_tpu_torch.viz.video import save_video

__all__ = [
    "colorize_depth",
    "depth_video_frames",
    "predictions_to_glb",
    "write_glb",
    "save_ply",
    "save_pointmap",
    "write_ply",
    "save_video",
]

"""Depth / disparity colorization.

Mirrors reference ``aether/utils/postprocess_utils.py:49-56`` (``colorize_depth``:
invert-normalize over positive pixels, Spectral colormap) without requiring
matplotlib at import time (falls back to a built-in Spectral-like LUT).

Copy of ``aether_tpu/viz/colorize.py``.
"""

from __future__ import annotations

import numpy as np

# 11 anchor colors of matplotlib's "Spectral" colormap (public colorbrewer data);
# linearly interpolated. Used only when matplotlib is unavailable.
_SPECTRAL_ANCHORS = np.array(
    [
        [158, 1, 66],
        [213, 62, 79],
        [244, 109, 67],
        [253, 174, 97],
        [254, 224, 139],
        [255, 255, 191],
        [230, 245, 152],
        [171, 221, 164],
        [102, 194, 165],
        [50, 136, 189],
        [94, 79, 162],
    ],
    dtype=np.float64,
) / 255.0


def _apply_cmap(x: np.ndarray, cmap: str) -> np.ndarray:
    try:
        import matplotlib

        cm = matplotlib.colormaps[cmap]
        return cm(x, bytes=False)[..., :3]
    except Exception:
        # piecewise-linear interpolation through the Spectral anchors
        pos = np.clip(x, 0.0, 1.0) * (len(_SPECTRAL_ANCHORS) - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, len(_SPECTRAL_ANCHORS) - 1)
        frac = (pos - lo)[..., None]
        return _SPECTRAL_ANCHORS[lo] * (1 - frac) + _SPECTRAL_ANCHORS[hi] * frac


def colorize_depth(depth: np.ndarray, cmap: str = "Spectral") -> np.ndarray:
    """Color a depth map: near = warm, far = cool. Returns float RGB in [0, 1].

    Normalization matches the reference: min/max over strictly positive pixels,
    then ``(max - d) / (max - min)`` so nearer pixels map to the high end.
    """
    depth = np.asarray(depth, np.float64)
    positive = depth[depth > 0]
    if positive.size == 0:
        return np.zeros((*depth.shape, 3), np.float64)
    min_d, max_d = positive.min(), positive.max()
    denom = max(max_d - min_d, 1e-12)
    x = np.clip((max_d - depth) / denom, 0.0, 1.0)
    return _apply_cmap(x, cmap)


def depth_video_frames(depth_video: np.ndarray, cmap: str = "Spectral") -> np.ndarray:
    """(T, H, W) depth/disparity video -> (T, H, W, 3) uint8 frames, normalized
    jointly across the whole video so colors are temporally stable."""
    depth_video = np.asarray(depth_video, np.float64)
    positive = depth_video[depth_video > 0]
    if positive.size == 0:
        return np.zeros((*depth_video.shape, 3), np.uint8)
    min_d, max_d = positive.min(), positive.max()
    denom = max(max_d - min_d, 1e-12)
    x = np.clip((max_d - depth_video) / denom, 0.0, 1.0)
    rgb = _apply_cmap(x, cmap)
    return (rgb * 255.0).round().astype(np.uint8)

"""Depth discontinuity (flying-pixel) detection via local min/max pooling, in
torch.

Port of ``aether_tpu/geometry/edges.py`` (reference ``depth_edge``,
``postprocess_utils.py:406-461``): a pixel is an edge when the local (max -
min) depth within a k x k window exceeds atol and/or rtol * depth. The JAX
``lax.reduce_window`` max pool with symmetric k//2 padding is
``F.max_pool2d`` with the same padding (it pads with -inf).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from aether_tpu_torch.geometry.transforms import Array, as_f32


def _maxpool2d_same(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Max pool over the last two axes of (N, h, w), stride 1, k//2 padding."""
    return F.max_pool2d(x[:, None], kernel_size, stride=1, padding=kernel_size // 2)[:, 0]


def depth_edge(depth: Array, atol: Optional[float] = None, rtol: Optional[float] = None,
               kernel_size: int = 3, mask: Optional[Array] = None):
    """Boolean edge mask of a (..., h, w) linear depth map: numpy for a numpy
    input, else a tensor on the input's device."""
    was_numpy = isinstance(depth, np.ndarray)
    depth = as_f32(depth)
    shape = depth.shape
    d = depth.reshape((-1,) + tuple(shape[-2:]))
    neg_inf = torch.full_like(d, -torch.inf)
    if mask is not None:
        m = torch.as_tensor(np.asarray(mask) if not isinstance(mask, torch.Tensor)
                            else mask, device=d.device).reshape(d.shape).bool()
        diff = (_maxpool2d_same(torch.where(m, d, neg_inf), kernel_size)
                + _maxpool2d_same(torch.where(m, -d, neg_inf), kernel_size))
    else:
        diff = _maxpool2d_same(d, kernel_size) + _maxpool2d_same(-d, kernel_size)

    edge = torch.zeros_like(d, dtype=torch.bool)
    if atol is not None:
        edge = edge | (diff > atol)
    if rtol is not None:
        rel = torch.nan_to_num(diff / d, nan=0.0, posinf=torch.inf, neginf=-torch.inf)
        edge = edge | (rel > rtol)
    edge = edge.reshape(shape)
    return edge.cpu().numpy() if was_numpy else edge

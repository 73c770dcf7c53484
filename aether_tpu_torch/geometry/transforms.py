"""Scalar field transforms shared by the raymap / disparity codecs, in torch.

Port of ``aether_tpu/geometry/transforms.py`` (reference
``aether/utils/postprocess_utils.py:13-46``, ``:964-987``, ``:847-864``).
Every function takes numpy arrays or tensors, computes in f32 on the input
tensor's device (the CPU for numpy), and returns a tensor.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

Array = Union[torch.Tensor, np.ndarray]


def as_f32(x, device=None) -> torch.Tensor:
    """``x`` as an f32 tensor, on ``device`` or where it already lies."""
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if not x.flags.writeable:  # torch refuses to share read-only memory
            x = x.copy()
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def signed_log1p(x: Array) -> torch.Tensor:
    """sign(x) * log(1 + |x|): compresses large ray-origin translations."""
    x = as_f32(x)
    return torch.sign(x) * torch.log1p(torch.abs(x))


def signed_log1p_inverse(x: Array) -> torch.Tensor:
    """Inverse of :func:`signed_log1p`: sign(x) * (exp(|x|) - 1)."""
    x = as_f32(x)
    return torch.sign(x) * torch.expm1(torch.abs(x))


def depth_to_disparity(depth: Array,
                       sqrt_disparity: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth -> the model's normalized (sqrt-)disparity: clip((1/depth) / dmax,
    0, 1), dmax the largest disparity over valid (depth > 1e-6) pixels, then
    optionally sqrt. Returns (disparity, dmax)."""
    depth = as_f32(depth)
    disparity = 1.0 / depth
    valid = depth > 1e-6
    dmax = torch.where(valid, disparity, torch.full_like(disparity, -torch.inf)).max()
    disparity = torch.clamp(disparity / dmax, 0.0, 1.0)
    if sqrt_disparity:
        disparity = torch.sqrt(disparity)
    return disparity, dmax


def disparity_to_depth(disparity: Array, min_disparity: float = 1e-3,
                       max_depth: float = 1e8) -> torch.Tensor:
    """depth = clip(1 / clip(disparity, 1e-3, 1), 0, 1e8)
    (reference ``postprocess_utils.py:301``)."""
    disparity = as_f32(disparity)
    return torch.clamp(1.0 / torch.clamp(disparity, min_disparity, 1.0), 0.0, max_depth)


def compute_scale(prediction: Array, target: Array, mask: Array):
    """Masked least-squares scalar s minimizing ||m * (s*p - t)||^2, summed over
    the last two axes: a float when one scale results, else a tensor (the
    reference's ``.item()``)."""
    p = as_f32(prediction)
    t = as_f32(target, p.device)
    m = as_f32(mask, p.device)
    numerator = torch.sum(m * p * t, dim=(1, 2))
    denominator = torch.sum(m * p * p, dim=(1, 2))
    scale = torch.where(denominator != 0,
                        numerator / torch.clamp(denominator, min=1e-30),
                        torch.zeros_like(numerator))
    return float(scale.reshape(-1)[0]) if scale.numel() == 1 else scale

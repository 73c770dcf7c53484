"""GroupNorm moments (kernel K5): per-(batch, channel) mean of (x - c0) and of
(x - c0)^2 over (T, H, W), accumulated in f32.

The Hopper kernel ``csrc/groupnorm_moments.cu`` (CUDA C++, sm_90a, bound with
ctypes through ``ops/_build.py``) replaces the Pallas kernel
``aether_tpu/ops/groupnorm.py::_moments_kernel``. On the H100 it is bound by
bytes: one read of x (849 MB at the 480p decode stage's (2, 128, 9, 256, 720)
bf16), against the plain version's two extra full-size f32 copies. The design
reads every element once, in place, in the layout it arrives in (NCTHW or
channels-last), keeps partial sums in registers and shared memory, and adds
the partials of each (b, c) in a fixed order in a second small pass: no
atomics, so repeats are bit-identical. The source carries the full note.

The JAX wrapper takes channels-last ``[B, T, H, W, C]`` and gates on a TPU
tiling rule (``moments_kernel_supported``: C % 128, a dividing tile height);
the port's VAE runs NCTHW, so this wrapper takes ``[B, C, T, H, W]`` and
every shape the VAE produces.
"""

from __future__ import annotations

from typing import Tuple

import torch

from aether_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS = 256
_TARGET_CTAS = 1056  # 8 CTAs of 256 threads on each of the H100's 132 SMs


def groupnorm_moments_plain(x: torch.Tensor,
                            c0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K5 on ``[B, C, T, H, W]``; same contract as
    :func:`groupnorm_moments`."""
    y = x.float() - c0.float()[:, :, None, None, None]
    m1 = y.mean(dim=(2, 3, 4))
    m2 = (y * y).mean(dim=(2, 3, 4))
    return m1, m2


def launch_plan(batch: int, channels: int, n: int, channels_last: bool,
                elem_bytes: int, aligned: bool) -> Tuple[int, int, int, int]:
    """(splits, chunk, vec, g_tile) of one launch, from the shape alone.

    Every reduction of n elements is cut into ``splits`` chunks of ``chunk``
    (a multiple of 8) so that about ``_TARGET_CTAS`` CTAs cover the card, and
    no CTA gets under ~32 elements a thread. Channels-last: ``vec`` channels a
    thread (a 16-byte vector when C allows and x is 16-byte aligned, else 1),
    ``g_tile`` channel vectors a CTA (a divisor of 256)."""
    vec, g_tile = 1, 1
    if channels_last:
        full = 16 // elem_bytes
        vec = full if aligned and channels % full == 0 else 1
        groups = channels // vec
        g_tile = 1
        while g_tile * 2 <= min(groups, _THREADS):
            g_tile *= 2
        units = batch * -(-groups // g_tile)
        per_cta_pass = _THREADS // g_tile  # positions one CTA covers per step
    else:
        units = batch * channels
        per_cta_pass = _THREADS
    most = max(1, n // (per_cta_pass * 32))
    splits = max(1, min(-(-_TARGET_CTAS // units), most))
    chunk = -(-n // splits)
    chunk = -(-chunk // 8) * 8
    splits = -(-n // chunk)
    return splits, chunk, vec, g_tile


def groupnorm_moments(x: torch.Tensor,
                      c0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel moments of (x - c0) over (T, H, W).

    Args:
        x: ``[B, C, T, H, W]``, f32, bf16 or f16; on CUDA it must be
            contiguous or channels-last (``torch.channels_last_3d``).
        c0: ``[B, C]`` shift, used in f32.

    Returns:
        (m1, m2): two ``[B, C]`` f32 tensors, the means of (x - c0) and of
        (x - c0)^2.

    A CPU tensor runs :func:`groupnorm_moments_plain`. A CUDA tensor launches
    the Hopper kernel or raises; there is no fallback.
    """
    if not x.is_cuda:
        return groupnorm_moments_plain(x, c0)
    if x.dim() != 5:
        raise ValueError(f"K5 takes [B, C, T, H, W], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"K5 takes f32, bf16 or f16, got {x.dtype}")
    b, c, t, h, w = x.shape
    n = t * h * w
    if b * c * n == 0:
        raise ValueError(f"K5 needs a non-empty input, got {tuple(x.shape)}")
    if tuple(c0.shape) != (b, c):
        raise ValueError(f"c0 shape {tuple(c0.shape)} != {(b, c)}")
    if x.is_contiguous():
        channels_last = False
    elif x.is_contiguous(memory_format=torch.channels_last_3d):
        channels_last = True
    else:
        raise ValueError("K5 takes a contiguous or channels-last [B, C, T, H, W] "
                         f"tensor, got strides {x.stride()}")
    if not channels_last and b * c > 65535:
        raise ValueError(f"K5 takes at most 65535 (batch, channel) rows, got {b * c}")
    if channels_last and b > 65535:
        raise ValueError(f"K5 takes a batch of at most 65535, got {b}")
    dev = x.device
    shift = c0.to(device=dev, dtype=torch.float32).contiguous()
    splits, chunk, vec, g_tile = launch_plan(
        b, c, n, channels_last, x.element_size(), x.data_ptr() % 16 == 0)
    p1 = torch.empty((b, splits, c), dtype=torch.float32, device=dev)
    p2 = torch.empty_like(p1)
    m1 = torch.empty((b, c), dtype=torch.float32, device=dev)
    m2 = torch.empty_like(m1)
    rc = _build.lib().aether_groupnorm_moments(
        x.data_ptr(), shift.data_ptr(), p1.data_ptr(), p2.data_ptr(), m1.data_ptr(),
        m2.data_ptr(), b, c, n, int(channels_last), splits, chunk, vec, g_tile,
        _DTYPES[x.dtype], _build.stream_ptr(dev))
    _build.check(rc, "aether_groupnorm_moments")
    _build.count_launch(groupnorm_moments)
    return m1, m2


# wrapper calls that launched the Hopper kernel (a plain integer)
groupnorm_moments.launches = 0

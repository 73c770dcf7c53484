"""Fused QKV attention prologue (kernel K1) and the fused joint attention.

Port of ``aether_tpu/ops/attn_prologue.py``. ``qkv_prologue`` turns the q/k/v
projection outputs into kernel-ready attention operands in one pass: per-head
shifted LayerNorm -> interleaved-pair RoPE -> rows >= ``s_valid`` zeroed ->
symmetric int8 quantization with one scale per (head group x token tile) cell,
plus the per-cell L2 row-norm maxima that give K2 its fixed softmax shift.

The Hopper kernel ``csrc/attn_prologue.cu`` (CUDA C++, sm_90a, bound with
ctypes through ``ops/_build.py``) replaces the Pallas kernel
``aether_tpu/ops/attn_prologue.py::_prologue_kernel`` at every even head dim
below 128: one kernel template over the width of its boxes and outputs (16
to 128 in steps of 16, ``head_dim_width``); a head dim between two widths
runs the next one up with the true head dim a runtime argument and writes q,
k and v that wide with zero columns past the head dim, which
:func:`flash_attention_prepacked` reads in place (:func:`qkv_prologue`
returns their first head-dim columns). On the H100 it is bound by memory traffic (472 MB moved per call at
48 heads x 15360 tokens x 64 with int8 codes, ~30 flops per element). It
reads every element of the fused projection from device memory once, in one
launch: TMA brings 64, 128 or 256 rows x hper heads of one tensor into a CTA's
shared memory, a thread-block cluster of ``block / rows`` CTAs holds one
quantization cell, and the cell's absmax and row-norm maximum are reduced
across the cluster through distributed shared memory before each CTA
quantizes the rows it holds (:func:`_launch_plan` is the launch; the source
carries the full note). With ``quantize=False`` (``AETHER_ATTN_QK8=0``) the
same kernel writes bf16 ``z * fold`` for q and bf16 ``z`` for k. The
LayerNorm moments are taken in double on both branches, as the plain version
takes them. ``qkv_prologue_plain`` is the same function in plain PyTorch: the
CPU path, and the reference the kernel is held against on the card.

Layouts differ from the TPU kernel in two places, both deliberate:
- the inputs may be strided views of the fused ``[B, S, 3*H*D]`` projection
  (no head-major transpose before the kernel);
- v is returned plain, ``[B*H, S_pad, D]``, not packed as ``[v | 1 | 0]``:
  that packing was an MXU trick, and K2 sums p itself.
"""

from __future__ import annotations

import ctypes
import dataclasses
import types
from typing import Optional, Sequence, Tuple

import torch

from aether_tpu_torch.ops import _build
from aether_tpu_torch.ops.flash_attention import (
    _heads_per_cell,
    _pick_block,
    flash_attention_prepacked,
    head_dim_width,
)

_LOG2E = 1.4426950408889634


def _pick_pad_and_block(s: int, block_q: int) -> Tuple[int, int]:
    """(s_pad, block) with ``s_pad % block == 0``; copy of the JAX picker.

    Base pad: 1024 multiples for long sequences, 128 multiples for short ones;
    the final pad is rounded up to a block multiple (the extra rows are
    masked by ``s_valid`` like any other padding)."""
    if s > 4096:
        base = -(-s // 1024) * 1024
    else:
        base = -(-s // 128) * 128
    block = _pick_block(base, block_q)
    s_pad = -(-base // block) * block
    return s_pad, block


def _rotate_pairs(z: torch.Tensor) -> torch.Tensor:
    """z @ R with R the pair swap-and-negate: (z0, z1) -> (-z1, z0)."""
    zp = z.unflatten(-1, (-1, 2))
    return torch.stack([-zp[..., 1], zp[..., 0]], dim=-1).flatten(-2)


# K1's launch (csrc/attn_prologue.cu): a CTA holds `rows` token rows of one
# tensor, one TMA box of rows x width bf16 a head (the width of the head
# dim's instance, head_dim_width); a cluster of block / rows CTAs holds one
# quantization cell. The rows a CTA by width, where the token tile is a
# multiple of them (else 128), as the kernel's rows_built takes them: 256 at
# 16 and 32 (small boxes: the CTA's fixed costs over more rows), 64 at 112
# and 128 (two CTAs an SM, in clusters of up to 16, a non-portable size), 128
# elsewhere
_CTA_ROWS = {16: 256, 32: 256, 48: 128, 64: 128, 80: 128, 96: 128, 112: 64, 128: 64}
_MAX_HEADS = 4      # hper: four boxes a CTA
_MAX_CLUSTER = {256: 4, 128: 8, 64: 16}  # so that block <= 1024
_TAIL_BYTES = 112   # the kernel's Tail: an mbarrier a box, published and cell
                    # maxima, the CTA's warp maxima


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """K1's launch at ``head_dim``: grid (``s_pad / rows``, 3 * groups), x
    the CTA's ``rows``-row slice and y ``3 * group + tensor`` (q, k, v),
    clusters of ``cluster`` consecutive slices (one token tile),
    ``smem_bytes`` of dynamic shared memory a CTA; boxes and outputs
    ``width`` columns wide."""

    cluster: int
    rows: int
    grid: Tuple[int, int]
    smem_bytes: int
    hper: int
    block: int
    head_dim: int = 64
    width: int = 64


def _launch_plan(bh: int, s_pad: int, block: int, hper: int, head_dim: int = 64,
                 strides: Sequence[int] = (), ptrs: Sequence[int] = ()) -> LaunchPlan:
    """The launch plan of K1 for ``bh`` heads of ``head_dim`` over ``s_pad``
    tokens in quantization cells of ``hper`` heads x ``block`` tokens.
    Raises ``ValueError`` on what the kernel does not take: an odd head dim
    or one outside 2-126 (the RoPE pairs; the JAX DiT's fused route), hper
    above 4, a block that is not a multiple of 128 or is above 1024 (a
    cluster above 4 CTAs of 256 rows, 8 of 128 or 16 of 64), and element
    ``strides`` or data ``ptrs`` (bf16) that are not 16-byte aligned for
    TMA."""
    if head_dim % 2 or not 2 <= head_dim <= 126:
        raise ValueError(f"K1 takes an even head_dim from 2 to 126, got {head_dim}")
    width = head_dim_width(head_dim)
    rows = _CTA_ROWS[width] if block > 0 and block % _CTA_ROWS[width] == 0 else 128
    if not 1 <= hper <= _MAX_HEADS or bh % hper:
        raise ValueError(f"K1 takes head groups of 1 to {_MAX_HEADS} heads dividing "
                         f"{bh}, got {hper}")
    if block <= 0 or block % 128 or block // rows > _MAX_CLUSTER[rows]:
        raise ValueError(f"K1 takes token tiles of 128 to {rows * _MAX_CLUSTER[rows]} rows "
                         f"in steps of 128, got {block}")
    if s_pad % block:
        raise ValueError(f"s_pad {s_pad} is not a multiple of the tile {block}")
    if any(st * 2 % 16 for st in strides) or any(p % 16 for p in ptrs):
        raise ValueError("K1 reads through TMA: strides and bases must be 16-byte "
                         f"aligned, got strides {tuple(strides)}")
    groups = bh // hper
    if 3 * groups > 65535:
        raise ValueError(f"{groups} head groups exceed the grid's y extent")
    # the kernel's smem_bytes_for(width, rows, hper): the boxes' 1024-byte
    # alignment slack, the boxes (rows x width bf16) and the row statistics
    # (a float2 a row), sizeof(Tail); the C entry refuses any other
    smem = 1024 + hper * (rows * width * 2 + rows * 8) + _TAIL_BYTES
    return LaunchPlan(cluster=block // rows, rows=rows, grid=(s_pad // rows, 3 * groups),
                      smem_bytes=smem, hper=hper, block=block, head_dim=head_dim, width=width)


def qkv_prologue_plain(
    xq: torch.Tensor,
    xk: torch.Tensor,
    xv: torch.Tensor,
    norm_q_scale: torch.Tensor,
    norm_q_bias: torch.Tensor,
    norm_k_scale: torch.Tensor,
    norm_k_bias: torch.Tensor,
    rope_cos: Optional[torch.Tensor],
    rope_sin: Optional[torch.Tensor],
    *,
    num_heads: int,
    head_dim: int,
    eps: float,
    sm_scale: Optional[float] = None,
    quantize: bool = True,
    block_q: int = 1024,
    heads_per_cell: int = 4,
    s_valid: Optional[int] = None,
):
    """Plain PyTorch K1; same arguments and outputs as :func:`qkv_prologue`."""
    b, s, d_model = xq.shape
    nh, hd = num_heads, head_dim
    if d_model != nh * hd:
        raise ValueError(f"model width {d_model} != {nh} heads x {hd}")
    if sm_scale is None:
        sm_scale = 1.0 / (hd**0.5)
    fold = sm_scale * _LOG2E
    s_valid = s if s_valid is None else s_valid
    bh = b * nh
    hper = _heads_per_cell(bh, heads_per_cell)
    s_pad, block = _pick_pad_and_block(s, block_q)
    n_tiles, groups = s_pad // block, bh // hper
    dev = xq.device
    valid = (torch.arange(s_pad, device=dev) < s_valid)[:, None]

    def head_major(x):
        if x.shape[1] != s_pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, s_pad - x.shape[1]))
        return x.reshape(b, s_pad, nh, hd).transpose(1, 2).reshape(bh, s_pad, hd)

    def pad_table(t):
        # the first hd columns, as the Pallas kernel's (block, hd) blocks read
        # a wider table (the RoPE builder's at a head dim that is no multiple
        # of 16)
        t = t[:, :hd].to(device=dev, dtype=torch.float32)
        if t.shape[0] != s_pad:
            t = torch.nn.functional.pad(t, (0, 0, 0, s_pad - t.shape[0]))
        return t

    has_rope = rope_cos is not None
    if has_rope:
        cos, sin = pad_table(rope_cos), pad_table(rope_sin)
    zero = torch.zeros((), device=dev)

    def prep(x, g, bias, fold_val):
        x = head_major(x).float()
        y0 = x - x[..., :1]
        # the shifted single-pass moments, accumulated in float64: the f32
        # form loses up to ~1e-5 to cancellation on rows whose first element
        # sits far from the mean, and the reference should not
        y64 = y0.double()
        m1 = y64.mean(dim=-1, keepdim=True)
        var = torch.clamp((y64 * y64).mean(dim=-1, keepdim=True) - m1 * m1, min=0.0)
        mean_y, var = m1.float(), var.float()
        # a correctly rounded 1/sqrt on every device, as the kernel divides
        # (torch.rsqrt approximates on the CPU and on CUDA)
        z = (y0 - mean_y) * torch.reciprocal(torch.sqrt(var + eps))
        z = z * g.float() + bias.float()
        if has_rope:
            z = z * cos + _rotate_pairs(z) * sin
        z = torch.where(valid, z, zero)
        cells = z.reshape(groups, hper, n_tiles, block, hd)
        absmax = cells.abs().amax(dim=(1, 3, 4))  # [G, T]
        normmax = torch.sqrt((cells * cells).sum(dim=-1).amax(dim=(1, 3)))
        if quantize:
            # 127 / absmax correctly rounded, as the Pallas kernel and both
            # CUDA kernels divide (torch's scalar 127.0 / t is 127 *
            # reciprocal(t), two roundings, which moves half-way codes)
            r = torch.where(absmax > 0.0,
                            torch.full_like(absmax, 127.0) / torch.clamp(absmax, min=1e-30),
                            zero)
            r = r[:, None, :, None, None]
            out = torch.round(cells * r).to(torch.int8).reshape(bh, s_pad, hd)
        else:
            out = (z * fold_val).to(xq.dtype)
        return out, absmax * (fold_val / 127.0), normmax * fold_val

    q, qsc, qn = prep(xq, norm_q_scale, norm_q_bias, fold)
    k, ksc, kn = prep(xk, norm_k_scale, norm_k_bias, 1.0)
    v = torch.where(valid, head_major(xv), torch.zeros((), dtype=xv.dtype,
                                                       device=dev))
    return q, k, v, qsc, qn, ksc, kn, s_pad


def qkv_prologue(
    xq: torch.Tensor,
    xk: torch.Tensor,
    xv: torch.Tensor,
    norm_q_scale: torch.Tensor,
    norm_q_bias: torch.Tensor,
    norm_k_scale: torch.Tensor,
    norm_k_bias: torch.Tensor,
    rope_cos: Optional[torch.Tensor],
    rope_sin: Optional[torch.Tensor],
    *,
    num_heads: int,
    head_dim: int,
    eps: float,
    sm_scale: Optional[float] = None,
    quantize: bool = True,
    block_q: int = 1024,
    heads_per_cell: int = 4,
    s_valid: Optional[int] = None,
):
    """QK-norm + RoPE + int8 quantization + v copy, in head-major layout.

    Args:
        xq / xk / xv: [B, S, H*D] projection outputs (bias added). On CUDA
            they may be column slices of one fused [B, S, 3*H*D] tensor:
            the kernel reads them through their row stride.
        norm_*: (D,) per-head QK LayerNorm params, shared across heads.
        rope_cos / rope_sin: (S_rope, >= D) joint-stream tables (identity
            rows on the text prefix) or None; rows past S_rope rotate to zero,
            as the JAX wrapper's zero padding does, and only the first D
            columns are read, as the Pallas kernel's blocks read them.
        quantize: int8 q/k; False emits q/k in the input dtype, q carrying
            the softmax fold (``AETHER_ATTN_QK8=0``).
        s_valid: true token count; rows >= s_valid are zeroed everywhere.

    Returns:
        (q, k, v, qsc, qn, ksc, kn, s_pad): q/k [B*H, S_pad, D] int8 (or the
        input dtype), v [B*H, S_pad, D] in the input dtype, and [G, T] f32
        per-(head group, token tile) scales / L2-norm maxima, q's carrying
        ``sm_scale * log2(e)``.

    A CPU tensor runs :func:`qkv_prologue_plain`. A CUDA tensor launches the
    Hopper kernel (any even head_dim below 128) or raises; there is no
    fallback. Its launches count on ``qkv_prologue.launches`` at head_dim 64
    and on ``qkv_prologue_hd.launches`` at the others. At a head dim that is
    no multiple of 16 the kernel writes q, k and v ``head_dim_width`` wide,
    zero past the head dim, and q, k and v are their first ``head_dim``
    columns (views that :func:`flash_attention_prepacked` reads in place);
    at a head dim that is no multiple of 8 (a TMA box starts 16-byte aligned)
    or on rows TMA cannot take, the kernel reads a copy of the projections
    with each head's columns a multiple of 8 apart.
    """
    if not xq.is_cuda:
        return qkv_prologue_plain(
            xq, xk, xv, norm_q_scale, norm_q_bias, norm_k_scale, norm_k_bias,
            rope_cos, rope_sin, num_heads=num_heads, head_dim=head_dim,
            eps=eps, sm_scale=sm_scale, quantize=quantize, block_q=block_q,
            heads_per_cell=heads_per_cell, s_valid=s_valid)
    b, s, d_model = xq.shape
    nh, hd = num_heads, head_dim
    if hd > 126:
        raise NotImplementedError(f"K1 takes head_dim 2 to 126 on CUDA, got {hd} "
                                  "(other head dims: ROADMAP.md, Queue 2)")
    if d_model != nh * hd:
        raise ValueError(f"model width {d_model} != {nh} heads x {hd}")
    for t in (xq, xk, xv):
        if t.dtype != torch.bfloat16 or t.device != xq.device:
            raise TypeError("K1 takes bf16 q/k/v projections on one device")
        if tuple(t.shape) != (b, s, d_model):
            raise ValueError(f"projection shape {tuple(t.shape)} != {(b, s, d_model)}")
        if t.stride() != xq.stride() or t.stride(-1) != 1:
            raise ValueError("K1 needs q/k/v views with one shared row stride "
                             "and a contiguous last axis")
    hs = hd  # elements from one head's first column to the next's
    if hd % 16 and (hd % 8 or any(t.data_ptr() % 16 or t.stride(1) % 8
                                  or (b > 1 and t.stride(0) % 8) for t in (xq, xk, xv))):
        # a TMA box starts 16-byte aligned: one copy of the three projections
        # with each head's columns hs = hd rounded up to 8 apart
        hs = -(-hd // 8) * 8
        buf = xq.new_zeros((3, b, s, nh, hs))
        for dst, t in zip(buf, (xq, xk, xv)):
            dst[..., :hd] = t.unflatten(-1, (nh, hd))
        xq, xk, xv = buf.flatten(-2).unbind(0)
    stride_s = xq.stride(1)
    # one batch element: its stride is never followed, so any aligned one
    stride_b = xq.stride(0) if b > 1 else s * stride_s
    if max(stride_b, stride_s) >= 2**31:
        raise ValueError("K1 takes 32-bit strides")
    if sm_scale is None:
        sm_scale = 1.0 / (hd**0.5)
    fold = sm_scale * _LOG2E
    s_valid = s if s_valid is None else s_valid
    if not 0 < s_valid <= s:
        raise ValueError(f"s_valid {s_valid} outside (0, {s}]")
    bh = b * nh
    hper = _heads_per_cell(bh, heads_per_cell)
    s_pad, block = _pick_pad_and_block(s, block_q)
    groups, n_tiles = bh // hper, s_pad // block
    ptrs = tuple(t.data_ptr() for t in (xq, xk, xv))
    plan = _launch_plan(bh, s_pad, block, hper, hd, strides=(stride_b, stride_s), ptrs=ptrs)
    dev = xq.device

    def param(t):
        t = t.to(device=dev, dtype=torch.float32).contiguous()
        if tuple(t.shape) != (hd,):
            raise ValueError(f"QK-norm parameter shape {tuple(t.shape)} != ({hd},)")
        return t

    gq, bq, gk, bk = (param(t) for t in (norm_q_scale, norm_q_bias,
                                         norm_k_scale, norm_k_bias))
    if rope_cos is not None:
        if rope_cos.shape != rope_sin.shape or rope_cos.shape[-1] < hd:
            raise ValueError(f"RoPE tables {tuple(rope_cos.shape)} / {tuple(rope_sin.shape)}")
        cos = rope_cos[:, :hd].to(device=dev, dtype=torch.float32).contiguous()
        sin = rope_sin[:, :hd].to(device=dev, dtype=torch.float32).contiguous()
        cos_p, sin_p, rope_rows = cos.data_ptr(), sin.data_ptr(), cos.shape[0]
    else:
        cos_p = sin_p = None
        rope_rows = 0

    # q and k in one allocation, the four stats in another (each allocation
    # is host time a launch at the small head dims cannot hide)
    width = plan.width
    qo, ko = torch.empty((2, bh, s_pad, width),
                         dtype=torch.int8 if quantize else torch.bfloat16,
                         device=dev).unbind(0)
    v = torch.empty((bh, s_pad, width), dtype=torch.bfloat16, device=dev)
    qsc, qn, ksc, kn = torch.empty((4, groups, n_tiles), dtype=torch.float32,
                                   device=dev).unbind(0)
    inputs = (*ptrs, stride_b, stride_s, gq.data_ptr(), bq.data_ptr(), gk.data_ptr(),
              bk.data_ptr(), cos_p, sin_p, rope_rows)
    outputs = (qo.data_ptr(), ko.data_ptr(), v.data_ptr(), qsc.data_ptr(),
               qn.data_ptr(), ksc.data_ptr(), kn.data_ptr())
    numbers = (s_pad, s_valid, block, hper, int(quantize), eps, fold, fold / 127.0,
               1.0 / 127.0)
    rc = _build.lib().aether_qkv_prologue(
        *inputs, b, s, nh, hd, hs, *numbers, *outputs, plan.rows, plan.cluster,
        plan.smem_bytes, _build.stream_ptr(dev))
    _build.check(rc, "aether_qkv_prologue")
    _build.count_launch(qkv_prologue if hd == 64 else qkv_prologue_hd)
    if width != hd:
        qo, ko, v = qo[..., :hd], ko[..., :hd], v[..., :hd]
    return qo, ko, v, qsc, qn, ksc, kn, s_pad


# wrapper calls that launched the Hopper kernel at head_dim 64 (a plain integer)
qkv_prologue.launches = 0
# and at the other head dims: the same kernel, counted apart so that a run
# shows which head dims its path took
qkv_prologue_hd = types.SimpleNamespace(launches=0)


def prologue_occupancy(plan: LaunchPlan, quantize: bool = True) -> int:
    """``cudaOccupancyMaxActiveClusters`` of K1 under ``plan``: how many of
    its clusters the current card holds at once."""
    n = ctypes.c_int(0)
    _build.check(_build.lib().aether_qkv_prologue_occupancy(
        plan.head_dim, plan.rows, plan.cluster, plan.smem_bytes, int(quantize),
        ctypes.addressof(n)), "aether_qkv_prologue_occupancy")
    return n.value


def fused_joint_attention(
    xq: torch.Tensor,
    xk: torch.Tensor,
    xv: torch.Tensor,
    norm_q_scale: torch.Tensor,
    norm_q_bias: torch.Tensor,
    norm_k_scale: torch.Tensor,
    norm_k_bias: torch.Tensor,
    rope_cos: Optional[torch.Tensor],
    rope_sin: Optional[torch.Tensor],
    *,
    num_heads: int,
    head_dim: int,
    eps: float,
    sm_scale: Optional[float] = None,
    quantize: bool = True,
    noshift: Optional[bool] = False,
    block_q: int = 1024,
    heads_per_cell: int = 4,
    s_valid: Optional[int] = None,
) -> torch.Tensor:
    """Projection outputs [B, S, H*D] -> attention output [B, S, H*D]:
    ``qkv_prologue`` (K1) + ``flash_attention_prepacked`` (K2, with its
    ``noshift``) + head merge."""
    b, s, _ = xq.shape
    q, k, v, qsc, qn, ksc, kn, s_pad = qkv_prologue(
        xq, xk, xv, norm_q_scale, norm_q_bias, norm_k_scale, norm_k_bias,
        rope_cos, rope_sin, num_heads=num_heads, head_dim=head_dim, eps=eps,
        sm_scale=sm_scale, quantize=quantize, block_q=block_q,
        heads_per_cell=heads_per_cell, s_valid=s_valid,
    )
    out = flash_attention_prepacked(
        q, k, v, qsc=qsc, ksc=ksc, qn=qn, kn=kn,
        s_valid=s if s_valid is None else s_valid, block_q=block_q,
        heads_per_cell=heads_per_cell, noshift=noshift,
    )  # [B*H, S_pad, D] (the first D columns of a wider buffer below its width)
    out = out.reshape(b, num_heads, s_pad, head_dim)[:, :, :s]
    return out.transpose(1, 2).reshape(b, s, num_heads * head_dim)

"""Fused QKV attention prologue (kernel K1) and the fused joint attention.

Port of ``aether_tpu/ops/attn_prologue.py``. ``qkv_prologue`` turns the q/k/v
projection outputs into kernel-ready attention operands in one pass: per-head
shifted LayerNorm -> interleaved-pair RoPE -> rows >= ``s_valid`` zeroed ->
symmetric int8 quantization with one scale per (head group x token tile) cell,
plus the per-cell L2 row-norm maxima that give K2 its fixed softmax shift.

The Hopper kernel ``csrc/attn_prologue.cu`` (CUDA C++, sm_90a, bound with
ctypes through ``ops/_build.py``) replaces the Pallas kernel
``aether_tpu/ops/attn_prologue.py::_prologue_kernel``. On the H100 it is bound
by memory traffic (about 0.75 GB moved per call at 48 heads x 15360 tokens,
~30 flops per element). Its design answers by reading the fused projection
in place through its row stride and by touching each element once per pass:
pass 1 reduces each cell's absmax and row-norm maximum across CTAs with
``atomicMax``, pass 2 recomputes z bit for bit and quantizes it; the source
carries the full note. With ``quantize=False`` (``AETHER_ATTN_QK8=0``) the
same kernel keeps pass 1's statistics and writes bf16 ``z * fold`` for q and
bf16 ``z`` for k, with the LayerNorm moments taken in double as the plain
version takes them. ``qkv_prologue_plain`` is the same function in plain
PyTorch: the CPU path, and the reference the kernel is held against on the
card.

Layouts differ from the TPU kernel in two places, both deliberate:
- the inputs may be strided views of the fused ``[B, S, 3*H*D]`` projection
  (no head-major transpose before the kernel);
- v is returned plain, ``[B*H, S_pad, D]``, not packed as ``[v | 1 | 0]``:
  that packing was an MXU trick, and K2 sums p itself.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from aether_tpu_torch.ops import _build
from aether_tpu_torch.ops.flash_attention import (
    _heads_per_cell,
    _pick_block,
    flash_attention_prepacked,
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
        t = t.to(device=dev, dtype=torch.float32)
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
            r = torch.where(absmax > 0.0, 127.0 / torch.clamp(absmax, min=1e-30),
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
        rope_cos / rope_sin: (S_rope, D) joint-stream tables (identity rows on
            the text prefix) or None; rows past S_rope rotate to zero, as the
            JAX wrapper's zero padding does.
        quantize: int8 q/k; False emits q/k in the input dtype, q carrying
            the softmax fold (``AETHER_ATTN_QK8=0``).
        s_valid: true token count; rows >= s_valid are zeroed everywhere.

    Returns:
        (q, k, v, qsc, qn, ksc, kn, s_pad): q/k [B*H, S_pad, D] int8 (or the
        input dtype), v [B*H, S_pad, D] in the input dtype, and [G, T] f32
        per-(head group, token tile) scales / L2-norm maxima, q's carrying
        ``sm_scale * log2(e)``.

    A CPU tensor runs :func:`qkv_prologue_plain`. A CUDA tensor launches the
    Hopper kernel or raises; there is no fallback.
    """
    if not xq.is_cuda:
        return qkv_prologue_plain(
            xq, xk, xv, norm_q_scale, norm_q_bias, norm_k_scale, norm_k_bias,
            rope_cos, rope_sin, num_heads=num_heads, head_dim=head_dim,
            eps=eps, sm_scale=sm_scale, quantize=quantize, block_q=block_q,
            heads_per_cell=heads_per_cell, s_valid=s_valid)
    b, s, d_model = xq.shape
    nh, hd = num_heads, head_dim
    if hd != 64:
        raise NotImplementedError(f"K1 takes head_dim 64 only, got {hd}")
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
    stride_b, stride_s = xq.stride(0), xq.stride(1)
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
    dev = xq.device

    def param(t):
        t = t.to(device=dev, dtype=torch.float32).contiguous()
        if tuple(t.shape) != (hd,):
            raise ValueError(f"QK-norm parameter shape {tuple(t.shape)} != ({hd},)")
        return t

    gq, bq, gk, bk = (param(t) for t in (norm_q_scale, norm_q_bias,
                                         norm_k_scale, norm_k_bias))
    if rope_cos is not None:
        cos = rope_cos.to(device=dev, dtype=torch.float32).contiguous()
        sin = rope_sin.to(device=dev, dtype=torch.float32).contiguous()
        if cos.shape != sin.shape or cos.shape[-1] != hd:
            raise ValueError(f"RoPE tables {tuple(cos.shape)} / {tuple(sin.shape)}")
        cos_p, sin_p, rope_rows = cos.data_ptr(), sin.data_ptr(), cos.shape[0]
    else:
        cos_p = sin_p = None
        rope_rows = 0

    qo = torch.empty((bh, s_pad, hd), dtype=torch.int8 if quantize else torch.bfloat16,
                     device=dev)
    ko = torch.empty_like(qo)
    v = torch.empty((bh, s_pad, hd), dtype=torch.bfloat16, device=dev)
    qsc, qn, ksc, kn = (torch.empty((groups, n_tiles), dtype=torch.float32,
                                    device=dev) for _ in range(4))
    scratch = torch.empty((groups, n_tiles, 4), dtype=torch.int32, device=dev)
    rc = _build.lib().aether_qkv_prologue(
        xq.data_ptr(), xk.data_ptr(), xv.data_ptr(), stride_b, stride_s,
        gq.data_ptr(), bq.data_ptr(), gk.data_ptr(), bk.data_ptr(),
        cos_p, sin_p, rope_rows, b, s, nh, s_pad, s_valid, block, hper,
        int(quantize), eps, fold, fold / 127.0, 1.0 / 127.0,
        qo.data_ptr(), ko.data_ptr(), v.data_ptr(), qsc.data_ptr(),
        qn.data_ptr(), ksc.data_ptr(), kn.data_ptr(), scratch.data_ptr(),
        _build.stream_ptr(dev))
    _build.check(rc, "aether_qkv_prologue")
    qkv_prologue.launches += 1
    return qo, ko, v, qsc, qn, ksc, kn, s_pad


# wrapper calls that launched the Hopper kernel (a plain integer)
qkv_prologue.launches = 0


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
    )  # [B*H, S_pad, D]
    out = out.reshape(b, num_heads, s_pad, head_dim)[:, :, :s]
    return out.transpose(1, 2).reshape(b, s, num_heads * head_dim)

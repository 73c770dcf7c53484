"""Fixed-max flash attention over prologue-packed operands (kernel K2).

Port of ``aether_tpu/ops/flash_attention.py::flash_attention_prepacked``; the
Hopper kernel ``csrc/flash_prepacked.cu`` (CUDA C++, sm_90a, bound with ctypes
through ``ops/_build.py``) replaces the Pallas kernel
``aether_tpu/ops/flash_attention.py::_flash_kernel_prepacked``. On the H100 it
is bound by matrix-unit work and exp2 (2.9e12 flops and 1.1e10 exp2 per call
at 48 heads x 15360 tokens). Its design answers with the fixed softmax shift
(no running max, no rescale, no cross-CTA reduction), int8 ``mma.sync`` for
QK^T and bf16 ``mma.sync`` for PV with p kept in registers between the two;
the source carries the full note. ``flash_attention_prepacked_plain`` is the
same function in plain PyTorch: the CPU path, and the reference the kernel
is held against on the card.

Math (log2 domain, non-causal, one fixed shift per head group):

    s   = f32(q8 . k8^T) * (qsc[g, row tile] * ksc[g, col tile])   (int8 q/k)
    s   = q . k^T                                                   (float q/k)
    p   = exp2(s - max_t qn[g, t] * max_t kn[g, t])
    out = sum_j p_j v_j / sum_j p_j,   p rounded to v's dtype in both sums,
          a zero denominator divides by 1

Columns ``>= s_valid`` are masked out of the numerator and the denominator.
"""

from __future__ import annotations

from typing import Optional

import torch

from aether_tpu_torch.ops import _build


def _pick_block(seq: int, requested: int) -> int:
    """Block size <= requested (multiple of 128); copy of the JAX picker.

    Keep the requested size unless its padding waste is egregious; then fall
    back to the candidate with the least padding (ties -> larger block).
    """
    if seq <= requested:
        # single tile: round the whole sequence up to a 128 multiple
        return max(128, -(-seq // 128) * 128)
    pad = -(-seq // requested) * requested - seq
    if pad <= 0.15 * seq:
        return requested
    best, best_pad = 128, float("inf")
    for cand in range(128, requested + 1, 128):
        pad = -(-seq // cand) * cand - seq
        if pad <= best_pad:
            best, best_pad = cand, pad
    return best


def _heads_per_cell(bh: int, heads_per_cell: int) -> int:
    """Largest divisor of B*H that is <= heads_per_cell (the head group)."""
    return max(h for h in range(1, min(heads_per_cell, bh) + 1) if bh % h == 0)


def _check_grid(q, qsc, block_q: int, heads_per_cell: int):
    bh, s_pad, _ = q.shape
    block = _pick_block(s_pad, block_q)
    if s_pad % block:
        raise ValueError(f"prepacked operands must tile exactly: {s_pad} % {block}")
    hper = _heads_per_cell(bh, heads_per_cell)
    if tuple(qsc.shape) != (bh // hper, s_pad // block):
        raise ValueError(
            f"prologue stats {tuple(qsc.shape)} do not match the kernel grid "
            f"({bh // hper}, {s_pad // block}): pass the same block_q and "
            "heads_per_cell to qkv_prologue and flash_attention_prepacked")
    return block, hper


def flash_attention_prepacked_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    qsc: torch.Tensor,
    ksc: torch.Tensor,
    qn: torch.Tensor,
    kn: torch.Tensor,
    s_valid: Optional[int] = None,
    block_q: int = 1024,
    heads_per_cell: int = 4,
) -> torch.Tensor:
    """Plain PyTorch K2: loops over head groups and q tiles so no score tensor
    is larger than (heads_per_cell, block, S_pad) in f32."""
    bh, s_pad, d = q.shape
    s_valid = s_pad if s_valid is None else s_valid
    block, hper = _check_grid(q, qsc, block_q, heads_per_cell)
    qk_int8 = q.dtype == torch.int8
    bounds = qn.amax(dim=-1) * kn.amax(dim=-1)  # [G]
    col_ok = torch.arange(s_pad, device=q.device) < s_valid
    out = torch.empty((bh, s_pad, d), dtype=v.dtype, device=v.device)
    for g in range(bh // hper):
        heads = slice(g * hper, (g + 1) * hper)
        kf = k[heads].float()
        vf = v[heads].float()
        for ti in range(s_pad // block):
            rows = slice(ti * block, (ti + 1) * block)
            s = torch.matmul(q[heads, rows].float(), kf.transpose(1, 2))
            if qk_int8:
                scale = (qsc[g, ti] * ksc[g]).repeat_interleave(block)
                s = s * scale
            p = torch.exp2(s - bounds[g])
            p = torch.where(col_ok, p, torch.zeros((), dtype=p.dtype,
                                                   device=p.device))
            p = p.to(v.dtype).float()
            num = torch.matmul(p, vf)
            den = p.sum(dim=-1, keepdim=True)
            inv = torch.where(den <= 0.0, torch.ones_like(den), 1.0 / den)
            out[heads, rows] = (num * inv).to(v.dtype)
    return out


def flash_attention_prepacked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    qsc: torch.Tensor,
    ksc: torch.Tensor,
    qn: torch.Tensor,
    kn: torch.Tensor,
    s_valid: Optional[int] = None,
    block_q: int = 1024,
    heads_per_cell: int = 4,
) -> torch.Tensor:
    """Fixed-max attention over ``qkv_prologue``'s outputs -> [B*H, S_pad, D].

    Args:
        q / k: [B*H, S_pad, D] int8 (per-(group, tile) scales) or a float
            dtype carrying the ``sm_scale*log2e`` fold on q (CPU only).
        v: [B*H, S_pad, D] plain values, rows >= s_valid zeroed.
        qsc / ksc / qn / kn: [G, T] f32 scales and L2-norm maxima.
        s_valid: number of real tokens; later kv columns are masked.

    A CPU tensor runs :func:`flash_attention_prepacked_plain`. A CUDA tensor
    launches the Hopper kernel or raises; there is no fallback.
    """
    if not q.is_cuda:
        return flash_attention_prepacked_plain(
            q, k, v, qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=s_valid,
            block_q=block_q, heads_per_cell=heads_per_cell)
    bh, s_pad, d = q.shape
    s_valid = s_pad if s_valid is None else s_valid
    if q.dtype != torch.int8 or k.dtype != torch.int8:
        raise NotImplementedError(
            "the float (AETHER_ATTN_QK8=0) variant of K2 is not ported to CUDA "
            "yet (ROADMAP.md, queue 2: the QK8=0 float variant of K1 and K2)")
    if d != 64:
        raise NotImplementedError(f"K2 takes head_dim 64 only, got {d}")
    if v.dtype != torch.bfloat16:
        raise TypeError(f"K2 takes bf16 v, got {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (bh, s_pad, d):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(bh, s_pad, d)}")
    block, hper = _check_grid(q, qsc, block_q, heads_per_cell)
    if block % 64:
        raise ValueError(f"K2 needs a block that is a multiple of 64, got {block}")
    if not 0 < s_valid <= s_pad:
        raise ValueError(f"s_valid {s_valid} outside (0, {s_pad}]")
    tensors = (q, k, v, qsc, ksc, qn, kn)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("K2 operands must be contiguous on one device")
    for t in (qsc, ksc, qn, kn):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(qsc.shape):
            raise ValueError("K2 stats must be [G, T] float32")
    out = torch.empty((bh, s_pad, d), dtype=torch.bfloat16, device=q.device)
    rc = _build.lib().aether_flash_prepacked(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qsc.data_ptr(),
        ksc.data_ptr(), qn.data_ptr(), kn.data_ptr(), out.data_ptr(),
        bh, s_pad, s_valid, hper, block, s_pad // block,
        _build.stream_ptr(q.device))
    _build.check(rc, "aether_flash_prepacked")
    flash_attention_prepacked.launches += 1
    return out


# wrapper calls that launched the Hopper kernel (a plain integer)
flash_attention_prepacked.launches = 0

"""Differentiable attention: the blockwise online softmax, and K4 with a gradient.

Port of ``aether_tpu/ops/chunked_attention.py``. :func:`chunked_attention` is
the JAX function's recurrence over K/V blocks (running max, running sum,
unnormalized accumulator; natural exp, f32) in plain PyTorch.
:func:`flash_attention_trainable` runs kernel K4
(``ops/flash_attention.py::flash_attention``) on the forward and saves only
(q, k, v), as the JAX ``_fat_fwd`` does.

Both take the same backward: the gradient of ``chunked_attention`` at the
saved inputs, which the JAX package gets from XLA's autodiff of the scan. The
Pallas kernels have no backward of their own, so neither does the port: it
is plain PyTorch, a blockwise recompute that never holds an (S, S) tensor.
Pass 1 recomputes the output and the row statistics (m, l); pass 2 walks the
K/V blocks again with ``p = exp(s - m) / l`` and ``D = rowsum(dO * O)``:

    dv_j = p_j^T dO,   ds_j = p_j * (dO v_j^T - D),
    dq   = sm_scale * sum_j ds_j k_j,   dk_j = sm_scale * ds_j^T q

Heads go in groups of ``_HEADS`` and K/V in blocks of ``block_k``: at 48 heads
x 15076 tokens each transient (group, S, block) tensor is 0.25 GB in f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from aether_tpu_torch.ops.flash_attention import flash_attention

_HEADS = 4  # heads per group in the blockwise loops


def _blocks(block_k: int, skv: int) -> int:
    return min(block_k, max(skv, 1))


def _chunked_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float, block_k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX scan's recurrence -> (out, m, l) in f32, [B*H, S, D | 1].

    A ragged last K/V block is sliced, not padded: the JAX version pads it
    with columns masked to -inf, whose p is exactly 0."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    bh = b * h
    block_k = _blocks(block_k, skv)
    q3, k3, v3 = (t.reshape(bh, t.shape[2], d) for t in (q, k, v))
    dev = q.device
    out = torch.empty((bh, sq, d), dtype=torch.float32, device=dev)
    m_all = torch.empty((bh, sq, 1), dtype=torch.float32, device=dev)
    l_all = torch.empty_like(m_all)
    for g0 in range(0, bh, _HEADS):
        hs = slice(g0, g0 + _HEADS)
        qf = q3[hs].float() * sm_scale
        n = qf.shape[0]
        m = torch.full((n, sq, 1), float("-inf"), device=dev)
        l = torch.zeros((n, sq, 1), device=dev)
        acc = torch.zeros((n, sq, d), device=dev)
        for c0 in range(0, skv, block_k):
            s = torch.matmul(qf, k3[hs, c0:c0 + block_k].float().transpose(1, 2))
            m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_next)
            p = s.sub_(m_next).exp_()
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, v3[hs, c0:c0 + block_k].float())
            m = m_next
        out[hs] = acc / torch.clamp(l, min=1e-30)
        m_all[hs], l_all[hs] = m, l
    return out, m_all, l_all


def _chunked_backward(q, k, v, g, sm_scale: float, block_k: int):
    """(dq, dk, dv) of ``chunked_attention`` at (q, k, v) for the cotangent g."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    bh = b * h
    block_k = _blocks(block_k, skv)
    out, m_all, l_all = _chunked_forward(q, k, v, sm_scale, block_k)
    q3, k3, v3 = (t.reshape(bh, t.shape[2], d) for t in (q, k, v))
    g3 = g.reshape(bh, sq, d)
    dq = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((bh, skv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((bh, skv, d), dtype=v.dtype, device=v.device)
    for g0 in range(0, bh, _HEADS):
        hs = slice(g0, g0 + _HEADS)
        qf = q3[hs].float() * sm_scale
        gf = g3[hs].float()
        m = m_all[hs]
        l = torch.clamp(l_all[hs], min=1e-30)
        dsum = (gf * out[hs]).sum(dim=-1, keepdim=True)  # D = rowsum(dO * O)
        dq_acc = torch.zeros_like(qf)
        for c0 in range(0, skv, block_k):
            cols = slice(c0, c0 + block_k)
            kb, vb = k3[hs, cols].float(), v3[hs, cols].float()
            p = torch.matmul(qf, kb.transpose(1, 2)).sub_(m).exp_().div_(l)
            dv[hs, cols] = torch.matmul(p.transpose(1, 2), gf).to(v.dtype)
            ds = torch.matmul(gf, vb.transpose(1, 2)).sub_(dsum).mul_(p)
            dq_acc.add_(torch.matmul(ds, kb))
            dk[hs, cols] = torch.matmul(ds.transpose(1, 2), qf).to(k.dtype)
        dq[hs] = (dq_acc * sm_scale).to(q.dtype)
    return (dq.reshape(b, h, sq, d), dk.reshape(b, h, skv, d),
            dv.reshape(b, h, skv, d))


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return 1.0 / (q.shape[-1] ** 0.5) if sm_scale is None else sm_scale


class _ChunkedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale, block_k):
        ctx.save_for_backward(q, k, v)
        ctx.sm_scale, ctx.block_k = sm_scale, block_k
        return _chunked_forward(q, k, v, sm_scale, block_k)[0].reshape(q.shape).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*_chunked_backward(q, k, v, g, ctx.sm_scale, ctx.block_k), None, None)


class _FlashTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return _chunked_backward(q, k, v, g, _scale(q, None), 1024)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: Optional[float] = None,
    block_k: int = 1024,
) -> torch.Tensor:
    """Full (non-causal) attention over [B, H, S, D] without an (S, S) buffer."""
    return _ChunkedAttention.apply(q, k, v, _scale(q, sm_scale), block_k)


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Differentiable attention with K4 on the forward, [B, H, S, D].

    The forward is ``flash_attention(q, k, v)`` with its defaults (the plain
    K4 on a CPU tensor); the backward is :func:`chunked_attention`'s gradient
    at the saved (q, k, v), the same exact softmax, so it is the forward's
    true gradient up to float error."""
    return _FlashTrainable.apply(q, k, v)

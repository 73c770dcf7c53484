"""Flash attention: the online-softmax kernel K4 and the fixed-max kernel K2.

Port of ``aether_tpu/ops/flash_attention.py``. Two Hopper kernels (CUDA C++,
sm_90a, bound with ctypes through ``ops/_build.py``) replace two Pallas
kernels; each has a plain PyTorch version here, which CPU tensors take and
which ``chip_smoke.py`` holds the kernel against on the card.

K4, :func:`flash_attention` (``fixed_max=False``): ``csrc/flash_online.cu``
replaces ``_flash_kernel``, the forward of the training path and the
attention at ``AETHER_ATTN_FIXED_MAX=0``. The wrapper keeps the JAX
preparation (``sm_scale * log2e`` folded into q and rounded to q's dtype, the
``kv_valid`` tail zeroed, tokens padded to the kernel's tile); the kernel
runs a base-2 online softmax with kv columns ``>= kv_len`` masked to
``-0.7 * f32max``. The denominator follows the TPU kernel: at head_dim < 128
(``denom="mxu"``) it sums p rounded to v's dtype, because the TPU summed p
through a ones column of the PV matmul; at head_dim >= 128 (``"vpu"``) it sums
unrounded p. A zero denominator divides by 1.

K2, :func:`flash_attention_prepacked`: ``csrc/flash_prepacked.cu`` replaces
``_flash_kernel_prepacked``. On the H100 it is bound by matrix-unit work and
exp2 (2.9e12 flops and 1.1e10 exp2 per call at 48 heads x 15360 tokens). Its
design answers with the fixed softmax shift (no running max, no rescale, no
cross-CTA reduction), int8 ``mma.sync`` for QK^T and bf16 ``mma.sync`` for PV
with p kept in registers between the two; the source carries the full note.

K2's math (log2 domain, non-causal, one fixed shift per head group):

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

_NEG_INF = -0.7 * torch.finfo(torch.float32).max
_LOG2E = 1.4426950408889634
_K4_TILE = 64  # q rows and kv columns per tile of csrc/flash_online.cu


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


# ---------------------------------------------------------------------------
# K4: online-softmax flash attention (``flash_attention(fixed_max=False)``)
# ---------------------------------------------------------------------------


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention with an f32 softmax, [B, H, S, D]; the JAX reference."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _online_operands(q, k, v, sm_scale, kv_valid):
    """The JAX wrapper's preparation: q times ``sm_scale * log2e`` rounded to
    q's dtype, and the k/v rows at or past ``kv_valid`` zeroed.

    Returns (q, k, v, kv_len)."""
    kv_len_in = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    kv_len = kv_len_in if kv_valid is None else min(kv_valid, kv_len_in)
    if kv_len < 0:
        raise ValueError(f"kv_valid {kv_valid} < 0")
    q = (q.float() * (sm_scale * _LOG2E)).to(q.dtype)
    if kv_len < kv_len_in:
        tail = (torch.arange(kv_len_in, device=k.device) >= kv_len)[:, None]
        k = k.masked_fill(tail, 0)
        v = v.masked_fill(tail, 0)
    return q, k, v, kv_len


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    kv_valid: Optional[int] = None,
    block_k: int = 1024,
    denom: str = "mxu",
    block_q: int = 1024,
    heads_per_cell: int = 4,
) -> torch.Tensor:
    """Plain PyTorch K4, [B, H, Sq, D] x [B, H, Skv, D] -> [B, H, Sq, D].

    The online softmax runs over kv blocks of ``_pick_block(Skv, block_k)``
    columns in the Pallas kernel's order, so the running max, and with it the
    rounding of p to v's dtype, is the TPU kernel's. Head groups and q blocks
    are looped over too: no score tensor is larger than
    (heads_per_cell, block_q, block_k) in f32. ``denom`` is the TPU kernel's
    knob: "mxu" sums p rounded to v's dtype, "vpu" sums unrounded p;
    head_dim >= 128 always takes "vpu", as the JAX wrapper does."""
    b, h, sq, dim = q.shape
    skv = k.shape[2]
    if dim >= 128:
        denom = "vpu"
    if denom not in ("mxu", "vpu"):
        raise ValueError(f"denom must be 'mxu' or 'vpu', got {denom!r}")
    q, k, v, kv_len = _online_operands(q, k, v, sm_scale, kv_valid)
    block_k = _pick_block(skv, block_k)
    block_q = _pick_block(sq, block_q)
    bh = b * h
    hper = _heads_per_cell(bh, heads_per_cell)
    qh, kh, vh = (t.reshape(bh, t.shape[2], dim) for t in (q, k, v))
    out = torch.empty((bh, sq, dim), dtype=q.dtype, device=q.device)
    for g0 in range(0, bh, hper):
        heads = slice(g0, g0 + hper)
        for r0 in range(0, sq, block_q):
            qb = qh[heads, r0:r0 + block_q].float()
            rows = qb.shape[1]
            m = torch.full((hper, rows, 1), float("-inf"), device=q.device)
            l = torch.zeros((hper, rows, 1), device=q.device)
            acc = torch.zeros((hper, rows, dim), device=q.device)
            # blocks wholly past kv_len leave m, l and acc exactly unchanged
            # (alpha = 1, p = 0), so the loop stops at kv_len
            for c0 in range(0, kv_len, block_k):
                kb = kh[heads, c0:c0 + block_k].float()
                s = torch.matmul(qb, kb.transpose(1, 2))
                if c0 + s.shape[-1] > kv_len:
                    col = torch.arange(c0, c0 + s.shape[-1], device=q.device)
                    s = s.masked_fill(col >= kv_len, _NEG_INF)
                m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                alpha = torch.exp2(m - m_next)
                m = m_next
                p = torch.exp2(s - m_next)
                p_v = p.to(v.dtype).float()
                l_cur = p_v if denom == "mxu" else p
                l = l * alpha + l_cur.sum(dim=-1, keepdim=True)
                acc = acc * alpha + torch.matmul(p_v, vh[heads, c0:c0 + block_k].float())
            l_inv = torch.where(l <= 0.0, torch.ones_like(l), 1.0 / l)
            out[heads, r0:r0 + rows] = (acc * l_inv).to(q.dtype)
    return out.reshape(b, h, sq, dim)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    block_q: int = 1024,
    block_k: int = 1024,
    heads_per_cell: int = 4,
    denom: str = "mxu",
    fixed_max: bool = False,
    kv_valid: Optional[int] = None,
    qk_int8: bool = False,
    pv_int8: bool = False,
) -> torch.Tensor:
    """Non-causal attention, q [B, H, Sq, D] x k/v [B, H, Skv, D] -> [B, H, Sq, D].

    The ``fixed_max=False`` branch of the JAX ``flash_attention``: K4.
    ``kv_valid`` treats only the first ``kv_valid`` k/v rows as real (the
    tail is zeroed and masked); ``block_q``, ``block_k`` and
    ``heads_per_cell`` shape the plain version's loops. At head_dim >= 128
    the JAX wrapper turns ``fixed_max``, ``qk_int8`` and ``pv_int8`` off and
    takes the "vpu" denominator; so does this one. ``fixed_max``,
    ``qk_int8`` and ``pv_int8`` at head_dim < 128 need kernels K3 and K6 and
    raise.

    A CPU tensor runs :func:`flash_attention_plain`. A CUDA tensor launches
    the Hopper kernel (f32 or bf16, head_dim 64) or raises; there is no
    fallback.
    """
    dim = q.shape[-1]
    if dim >= 128:
        denom, fixed_max, qk_int8, pv_int8 = "vpu", False, False, False
    if fixed_max or qk_int8 or pv_int8:
        raise NotImplementedError(
            "flash_attention(fixed_max=True / qk_int8 / pv_int8) needs kernels "
            "K3 (_flash_kernel_fixed_max) and K6 (_flash_kernel_pv8): not "
            "ported yet (ROADMAP.md, queue 2)")
    if denom not in ("mxu", "vpu"):
        raise ValueError(f"denom must be 'mxu' or 'vpu', got {denom!r}")
    if not q.is_cuda:
        return flash_attention_plain(
            q, k, v, sm_scale=sm_scale, kv_valid=kv_valid, block_k=block_k,
            denom=denom, block_q=block_q, heads_per_cell=heads_per_cell)
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    if dim != 64:
        raise NotImplementedError(
            f"K4 takes head_dim 64 on CUDA, got {dim}: other head dims, the "
            "'vpu' head_dim >= 128 case among them, are later work "
            "(ROADMAP.md, queue 2)")
    dtypes = {torch.float32: 0, torch.bfloat16: 1}
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K4 takes f32 or bf16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, h, skv, dim) or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does not "
                             f"match ({b}, {h}, {skv}, {dim}) on {q.device}")
    q, k, v, kv_len = _online_operands(q, k, v, sm_scale, kv_valid)
    bh = b * h
    sq_pad = -(-sq // _K4_TILE) * _K4_TILE
    skv_pad = -(-skv // _K4_TILE) * _K4_TILE

    def padded(t, rows, keep):
        buf = t.new_zeros((bh, rows, dim))
        buf[:, :keep] = t.reshape(bh, t.shape[2], dim)[:, :keep]
        return buf

    qp = padded(q, sq_pad, sq)
    kp, vp = padded(k, skv_pad, kv_len), padded(v, skv_pad, kv_len)
    out = torch.empty((bh, sq_pad, dim), dtype=q.dtype, device=q.device)
    rc = _build.lib().aether_flash_online(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
        bh, sq_pad, skv_pad, kv_len, dtypes[q.dtype], int(denom == "mxu"),
        _build.stream_ptr(q.device))
    _build.check(rc, "aether_flash_online")
    flash_attention.launches += 1
    return out[:, :sq].reshape(b, h, sq, dim)


# wrapper calls that launched the Hopper kernel (a plain integer)
flash_attention.launches = 0

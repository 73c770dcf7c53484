"""Flash-attention tuning variants: kernels K7, K8 and K9.

Port of the Pallas kernels of the three attention benchmark scripts:
``scripts/bench_flash_variants.py::_kernel_v2`` (K7, :func:`flash_v2`),
``scripts/bench_flash_multihead.py::_kernel`` (K8, :func:`flash_mh`) and
``scripts/bench_flash_bisect.py::_kernel`` (K9, :func:`flash_x`), under the JAX
names and keyword arguments. They run only from the benchmark entry points
(``aether_tpu_torch/bench/``). On the card all three run on the wgmma + TMA
cell that K4 in bf16 runs on (``csrc/online_cell.cuh``; CUDA C++, sm_90a,
instanced in ``csrc/flash_variants.cu`` and bound with ctypes through
``ops/_build.py``), through compile-time switches; each wrapper has a plain
PyTorch version beside it, which CPU tensors take and which ``chip_smoke.py``
holds the kernel against on the card. The wrappers keep the JAX padding
arithmetic but pad nothing: the kernel reads the unpadded q, k and v, folds
q's scale itself, and is told where the mask falls (``_launch_args``).

Each is the same non-causal online softmax; they differ in

- the exponent: exp2 with q scaled by ``sm_scale * log2(e)``, or, for
  ``flash_x``'s ``fold`` and ``padfix_exp`` modes, exp with q scaled by
  ``1/sqrt(d)``; q is scaled in f32 and rounded to its dtype, as the JAX
  wrappers do;
- the padding: ``flash_v2`` and ``flash_x`` round the sequence up to block_q,
  then block_k, then block_q; ``flash_mh`` to ``lcm(block_q, block_k)``;
- the mask of the padded keys: every kv block, only the last one
  (``flash_v2``'s ``mask_last_only``, which asserts that the padding is
  shorter than block_k), or none (``padfix``: zero keys give score 0, and
  the final denominator drops ``pad * e(-m)``);
- the zero-denominator guard: ``l == 0`` (K7) or ``l <= 0`` (K8, K9); they
  differ only where l < 0, which only padfix reaches, so the kernel divides
  by 1 at ``l <= 0`` in every mode.

p is rounded to v's dtype for the PV product only; the denominator sums the
f32 p.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from aether_tpu_torch.ops import _build

_NEG_INF = -0.7 * torch.finfo(torch.float32).max
_LOG2E = 1.4426950408889634
_MASK_ALL, _MASK_LAST, _MASK_NONE = 0, 1, 2  # the kernel's mask switch (2: padfix)
FLASH_X_MODES = ("fold", "fold2", "padfix", "padfix_exp")


class _Variant(NamedTuple):
    """One configuration of the online-softmax cell, as the Pallas body has it."""

    exp2: bool       # exp2 (True) or exp
    mask: int        # _MASK_ALL, _MASK_LAST or _MASK_NONE (padfix: the final
                     # l drops pad * e(-m) instead)
    kt: bool         # K pre-transposed to [bh, d, S]
    guard_le: bool   # l <= 0 (True) or l == 0 divides by 1
    hper: int        # heads per grid cell


class _Launch(NamedTuple):
    """What a wrapper hands ``aether_flash_variants`` besides the tensors."""

    sq: int          # q rows and kv rows: the unpadded sequence
    kv_end: int      # columns at or past it are masked: seq, or seq_pad (padfix)
    pad: int         # padfix: the zero keys [seq, seq_pad) whose mass l drops
    qscale: float    # folded into q in the kernel, bf16(q * qscale)
    exp2: bool       # exp2 (True) or exp
    mask: int        # _MASK_ALL, _MASK_LAST or _MASK_NONE (padfix)
    k_row: int       # K^T's row length, seq rounded up to 8 (kt); 0: K as rows
    hper: int        # heads a CTA walks in turn (flash_mh); 0: one a CTA


def _launch_args(seq: int, seq_pad: int, scale: float, var: _Variant,
                 heads: bool = False) -> _Launch:
    """The kernel's arguments for a variant whose JAX wrapper pads ``seq`` to
    ``seq_pad`` and scales q by ``scale``. The masking variants score only
    the real columns; padfix scores the zero pad keys, which the kernel reads
    as TMA's zero fill past the unpadded k and v, and masks nothing below
    seq_pad. K^T's rows are padded to 8 columns, TMA's 16-byte row stride."""
    padfix = var.mask == _MASK_NONE
    return _Launch(sq=seq, kv_end=seq_pad if padfix else seq,
                   pad=seq_pad - seq if padfix else 0, qscale=scale, exp2=var.exp2,
                   mask=var.mask, k_row=-(-seq // 8) * 8 if var.kt else 0,
                   hper=var.hper if heads else 0)


def _v2_seq_pad(seq: int, block_q: int, block_k: int) -> int:
    """``flash_v2`` / ``flash_x``'s padded length (bench_flash_variants.py:117-120)."""
    seq_pad = -(-seq // block_q) * block_q
    seq_pad = -(-seq_pad // block_k) * block_k
    if seq_pad % block_q:
        seq_pad += block_q - seq_pad % block_q
    return seq_pad


def _scaled_padded(q, k, v, scale: float, seq_pad: int):
    """q times ``scale`` in f32, rounded to q's dtype; q, k, v zero-padded
    to ``seq_pad`` tokens and flattened to [B*H, seq_pad, D]."""
    b, h, seq, dim = q.shape
    q = (q.float() * scale).to(q.dtype)

    def pad(x):
        if seq_pad != seq:
            x = torch.nn.functional.pad(x, (0, 0, 0, seq_pad - seq))
        return x.reshape(b * h, seq_pad, dim)

    return pad(q), pad(k), pad(v)


def _online_loop(qp, kp, vp, *, seq: int, block_q: int, block_k: int,
                 var: _Variant) -> torch.Tensor:
    """The Pallas body, literally: per head group and q block, one block_k of
    columns at a time, m from -inf, the variant's mask and exponent, p cast
    to v's dtype for PV only while l sums the f32 p, the padfix correction
    and the guard at the store. ``kp`` is [bh, d, S] when ``var.kt``.
    Heads are independent, so several head groups share one batched step,
    keeping each score tensor near 2**26 elements. Returns [bh, seq_pad, d]
    in q's dtype."""
    bh, seq_pad, dim = qp.shape
    num_kv = seq_pad // block_k
    needs_mask = seq < num_kv * block_k
    exp = torch.exp2 if var.exp2 else torch.exp
    dev = qp.device
    out = torch.empty_like(qp)
    step = var.hper * max(1, 2**26 // (var.hper * block_q * block_k))
    for g0 in range(0, bh, step):
        heads = slice(g0, g0 + step)
        for r0 in range(0, seq_pad, block_q):
            qb = qp[heads, r0:r0 + block_q].float()
            n, rows = qb.shape[:2]
            m = torch.full((n, rows, 1), float("-inf"), device=dev)
            l = torch.zeros((n, rows, 1), device=dev)
            acc = torch.zeros((n, rows, dim), device=dev)
            for ki in range(num_kv):
                cols = slice(ki * block_k, (ki + 1) * block_k)
                kb = kp[heads, :, cols] if var.kt else kp[heads, cols].transpose(1, 2)
                s = torch.matmul(qb, kb.float())
                if needs_mask and (var.mask == _MASK_ALL or (
                        var.mask == _MASK_LAST and ki == num_kv - 1)):
                    col = torch.arange(ki * block_k, (ki + 1) * block_k, device=dev)
                    s = s.masked_fill(col >= seq, _NEG_INF)
                m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                alpha = exp(m - m_next)
                p = exp(s - m_next)
                l = alpha * l + p.sum(dim=-1, keepdim=True)
                m = m_next
                pv = torch.matmul(p.to(vp.dtype).float(), vp[heads, cols].float())
                acc = acc * alpha + pv
            pad = num_kv * block_k - seq
            if var.mask == _MASK_NONE and pad:
                l = l - pad * exp(-m)
            zero = l <= 0.0 if var.guard_le else l == 0.0
            l_inv = torch.where(zero, torch.ones_like(l), 1.0 / l)
            out[heads, r0:r0 + rows] = (acc * l_inv).to(qp.dtype)
    return out


def _kernel_operands(q, k, v, args: _Launch):
    """q, k, v [B, H, S, 64] bf16 on one CUDA device as the kernel takes them:
    [B*H, S, 64] contiguous, k as [B*H, 64, k_row] with zero columns past S
    when ``args.k_row`` (one transposing pass). Raises on what it does not take."""
    b, h, seq, dim = q.shape
    if dim != 64:
        raise NotImplementedError(
            f"K7-K9 take head_dim 64 on CUDA, got {dim}: other head dims are "
            "later work (ROADMAP.md, Queue 2)")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K7-K9 take bf16 q/k/v on CUDA, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("K7-K9 operands must lie on one device")
    qh, kh, vh = (t.reshape(b * h, seq, dim).contiguous() for t in (q, k, v))
    if args.k_row:
        kh = torch.nn.functional.pad(kh.transpose(1, 2), (0, args.k_row - seq)).contiguous()
    return qh, kh, vh


def _kernel_launch(qh, kh, vh, out, args: _Launch) -> None:
    """``aether_flash_variants`` alone on prepared operands (``_kernel_operands``);
    out [B*H, S, 64] bf16."""
    bh, seq, _ = qh.shape
    rc = _build.lib().aether_flash_variants(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(), bh, seq, seq,
        args.kv_end, args.pad, args.hper, int(args.exp2), args.mask, args.k_row,
        args.qscale, _build.stream_ptr(qh.device))
    _build.check(rc, "aether_flash_variants")


def _launch(q, k, v, args: _Launch) -> torch.Tensor:
    """The kernel on [B, H, S, 64] bf16 CUDA q, k, v; returns [B, H, S, 64]."""
    qh, kh, vh = _kernel_operands(q, k, v, args)
    out = torch.empty_like(qh)
    _kernel_launch(qh, kh, vh, out, args)
    return out.view(q.shape)


def _finish(out: torch.Tensor, shape) -> torch.Tensor:
    """[bh, seq_pad, d] -> [B, H, seq, d]."""
    b, h, seq, dim = shape
    return out[:, :seq].reshape(b, h, seq, dim)


# ---------------------------------------------------------------------------
# K7: flash_v2 (bench_flash_variants.py)
# ---------------------------------------------------------------------------


def _v2_config(seq, dim, sm_scale, block_q, block_k, mask_last_only, kt):
    """(seq_pad, q scale, variant) of ``flash_v2``, as its JAX wrapper has them."""
    if sm_scale is None:
        sm_scale = 1.0 / (dim ** 0.5)
    seq_pad = _v2_seq_pad(seq, block_q, block_k)
    if mask_last_only and not seq_pad - seq < block_k:
        # the JAX wrapper's assertion: the padding must fit in the last block
        raise ValueError(f"mask_last_only needs seq_pad - seq < block_k: "
                         f"{(seq_pad, seq, block_k)}")
    var = _Variant(exp2=True, mask=_MASK_LAST if mask_last_only else _MASK_ALL,
                   kt=kt, guard_le=False, hper=1)
    return seq_pad, sm_scale * _LOG2E, var


def _v2_args(q, sm_scale=None, block_q=1024, block_k=1024, mask_last_only=True,
             kt=False) -> _Launch:
    """``flash_v2``'s kernel arguments for q of q's shape."""
    seq = q.shape[2]
    return _launch_args(seq, *_v2_config(seq, q.shape[3], sm_scale, block_q, block_k,
                                         mask_last_only, kt))


def flash_v2_plain(q, k, v, sm_scale: Optional[float] = None, block_q: int = 1024,
                   block_k: int = 1024, mask_last_only: bool = True,
                   kt: bool = False) -> torch.Tensor:
    """Plain PyTorch K7; the arguments and result of :func:`flash_v2`."""
    seq_pad, scale, var = _v2_config(q.shape[2], q.shape[3], sm_scale, block_q, block_k,
                                     mask_last_only, kt)
    qp, kp, vp = _scaled_padded(q, k, v, scale, seq_pad)
    if kt:
        kp = kp.transpose(1, 2).contiguous()  # (bh, d, S) once, outside the kernel
    out = _online_loop(qp, kp, vp, seq=q.shape[2], block_q=block_q,
                       block_k=block_k, var=var)
    return _finish(out, q.shape)


def flash_v2(q, k, v, sm_scale: Optional[float] = None, block_q: int = 1024,
             block_k: int = 1024, mask_last_only: bool = True,
             kt: bool = False) -> torch.Tensor:
    """K7: exp2 online softmax, q [B, H, S, D] -> [B, H, S, D].

    q is scaled by ``sm_scale * log2(e)`` (default ``1/sqrt(D)``) and rounded
    to its dtype; the sequence is padded as the JAX wrapper pads it.
    ``mask_last_only`` masks only the last kv block and raises ``ValueError``
    unless the padding is shorter than ``block_k`` (the JAX wrapper's
    assertion); ``kt`` hands the kernel K transposed, [B*H, D, S] with its rows
    padded to a multiple of 8 columns. A zero denominator divides by 1.

    A CPU tensor runs :func:`flash_v2_plain`. A CUDA tensor launches
    ``csrc/flash_variants.cu`` (bf16, head_dim 64) or raises.
    """
    if not q.is_cuda:
        return flash_v2_plain(q, k, v, sm_scale, block_q, block_k, mask_last_only, kt)
    out = _launch(q, k, v, _v2_args(q, sm_scale, block_q, block_k, mask_last_only, kt))
    _build.count_launch(flash_v2)
    return out


# wrapper calls that launched the Hopper kernel (a plain integer)
flash_v2.launches = 0


# ---------------------------------------------------------------------------
# K8: flash_mh (bench_flash_multihead.py)
# ---------------------------------------------------------------------------


def _mh_config(shape, block_q, block_k, hper):
    """(seq_pad, q scale, variant) of ``flash_mh``, as its JAX wrapper has them."""
    b, h, seq, dim = shape
    if hper <= 0 or (b * h) % hper:
        # the JAX grid (bh // hper) would leave the last heads unwritten
        raise ValueError(f"flash_mh needs B*H ({b * h}) divisible by hper ({hper})")
    step = math.lcm(block_q, block_k)
    seq_pad = -(-seq // step) * step
    var = _Variant(exp2=True, mask=_MASK_ALL, kt=False, guard_le=True, hper=hper)
    return seq_pad, 1.0 / dim ** 0.5 * _LOG2E, var


def _mh_args(q, block_q=1024, block_k=1024, hper=2) -> _Launch:
    """``flash_mh``'s kernel arguments for q of q's shape."""
    return _launch_args(q.shape[2], *_mh_config(q.shape, block_q, block_k, hper), heads=True)


def flash_mh_plain(q, k, v, block_q: int = 1024, block_k: int = 1024,
                   hper: int = 2) -> torch.Tensor:
    """Plain PyTorch K8; the arguments and result of :func:`flash_mh`."""
    seq_pad, scale, var = _mh_config(q.shape, block_q, block_k, hper)
    qp, kp, vp = _scaled_padded(q, k, v, scale, seq_pad)
    out = _online_loop(qp, kp, vp, seq=q.shape[2], block_q=block_q,
                       block_k=block_k, var=var)
    return _finish(out, q.shape)


def flash_mh(q, k, v, block_q: int = 1024, block_k: int = 1024,
             hper: int = 2) -> torch.Tensor:
    """K8: the exp2 online softmax with ``hper`` heads per grid cell.

    q is scaled by ``log2(e) / sqrt(D)``; the sequence is padded to a
    multiple of ``lcm(block_q, block_k)``; every kv block is masked; an
    ``l <= 0`` denominator divides by 1. B*H must be a multiple of ``hper``:
    the JAX grid (``bh // hper``) would leave the last heads unwritten, so
    this raises ``ValueError`` instead.

    A CPU tensor runs :func:`flash_mh_plain`. A CUDA tensor launches
    ``csrc/flash_variants.cu`` with ``hper`` heads per CTA (bf16, head_dim
    64) or raises.
    """
    if not q.is_cuda:
        return flash_mh_plain(q, k, v, block_q, block_k, hper)
    out = _launch(q, k, v, _mh_args(q, block_q, block_k, hper))
    _build.count_launch(flash_mh)
    return out


# wrapper calls that launched the Hopper kernel (a plain integer)
flash_mh.launches = 0


# ---------------------------------------------------------------------------
# K9: flash_x (bench_flash_bisect.py)
# ---------------------------------------------------------------------------


def _x_config(seq, dim, block_q, block_k, mode):
    """(seq_pad, q scale, variant) of ``flash_x``, as its JAX wrapper has them."""
    if mode not in FLASH_X_MODES:
        raise ValueError(f"mode must be one of {FLASH_X_MODES}, got {mode!r}")
    use_exp = mode in ("fold", "padfix_exp")
    scale = 1.0 / dim ** 0.5
    if not use_exp:
        scale = scale * _LOG2E
    seq_pad = _v2_seq_pad(seq, block_q, block_k)
    padfix = mode in ("padfix", "padfix_exp")
    var = _Variant(exp2=not use_exp, mask=_MASK_NONE if padfix else _MASK_ALL,
                   kt=False, guard_le=True, hper=1)
    return seq_pad, scale, var


def _x_args(q, block_q=1024, block_k=1024, mode="fold") -> _Launch:
    """``flash_x``'s kernel arguments for q of q's shape."""
    seq = q.shape[2]
    return _launch_args(seq, *_x_config(seq, q.shape[3], block_q, block_k, mode))


def flash_x_plain(q, k, v, block_q: int = 1024, block_k: int = 1024,
                  mode: str = "fold") -> torch.Tensor:
    """Plain PyTorch K9; the arguments and result of :func:`flash_x`."""
    seq_pad, scale, var = _x_config(q.shape[2], q.shape[3], block_q, block_k, mode)
    qp, kp, vp = _scaled_padded(q, k, v, scale, seq_pad)
    out = _online_loop(qp, kp, vp, seq=q.shape[2], block_q=block_q,
                       block_k=block_k, var=var)
    return _finish(out, q.shape)


def flash_x(q, k, v, block_q: int = 1024, block_k: int = 1024,
            mode: str = "fold") -> torch.Tensor:
    """K9: the online softmax in one of four modes.

    ``fold``: exp, q scaled by ``1/sqrt(D)``, padded keys masked.
    ``fold2``: exp2, q scaled by ``log2(e)/sqrt(D)``, masked. ``padfix``:
    exp2, no mask; the zero pad keys score 0, so the final denominator drops
    ``pad * exp2(-m)`` (pad = seq_pad - seq, however many kv blocks it
    spans). ``padfix_exp``: the same with exp and ``1/sqrt(D)``. An ``l <= 0``
    denominator divides by 1: when every real score sits far below 0 the
    correction cancels l to 0 or below and the output is about 0, as in JAX.

    A CPU tensor runs :func:`flash_x_plain`. A CUDA tensor launches
    ``csrc/flash_variants.cu`` (bf16, head_dim 64) or raises.
    """
    if not q.is_cuda:
        return flash_x_plain(q, k, v, block_q, block_k, mode)
    out = _launch(q, k, v, _x_args(q, block_q, block_k, mode))
    _build.count_launch(flash_x)
    return out


# wrapper calls that launched the Hopper kernel (a plain integer)
flash_x.launches = 0

"""Flash attention: kernels K2, K3, K4 and K6.

Port of ``aether_tpu/ops/flash_attention.py``. Hopper kernels (CUDA C++,
sm_90a, bound with ctypes through ``ops/_build.py``) replace four Pallas
kernels; each has a plain PyTorch version here, which CPU tensors take and
which ``chip_smoke.py`` holds the kernel against on the card.

K3, :func:`flash_attention_fixed_max` (``flash_attention(fixed_max=True)``):
``csrc/flash_fixed_max.cu`` replaces ``_flash_kernel_fixed_max`` with bf16 v
at every head dim below 128, the attention of the unfused
DiT path (``AETHER_ATTN_FUSED=0``) and of the ring merge (``unnormalized``
with a shared ``score_bound``); q, k and v go to the kernel with their rows
unpadded (TMA reads rows past the ends as zeros). K6,
:func:`flash_attention_pv8` (``pv_int8=True``): ``csrc/flash_pv8.cu``
replaces ``_flash_kernel_pv8`` at the same head dims. Both are ``wgmma`` +
TMA kernels templated over the head dim; at head dims other than 64 their
launches count on :func:`flash_attention_fixed_max_hd` and
:func:`flash_attention_pv8_hd`. The wrapper's preparation is the JAX
wrapper's (:func:`_fixed_max_operands`): the ``kv_valid`` tail zeroed, the
``sm_scale * log2e`` fold, the per-head-group Cauchy-Schwarz bound, the
whole-sequence per-group symmetric int8 quantization of q and k (and of v for
K6) with one combined dequantization scalar per group, and the ``noshift``
choice made on the device.

K4, :func:`flash_attention` (``fixed_max=False``) replaces ``_flash_kernel``.
In bf16 (the attention at ``AETHER_ATTN_FIXED_MAX=0``, at head_dim 128 and
above at the defaults, and the bench baseline) ``csrc/flash_online_bf16.cu``
runs at every head dim up to 256: the ``wgmma`` + TMA online-softmax cell of
``csrc/online_cell.cuh`` templated over the head dim; above 256
``csrc/flash_online_wide_bf16.cu``, one kernel with the head dim read at run
time: a thread-block cluster a q tile of 128 rows splits the head dim in
slices of at most 256 columns (:func:`_wide_plan`), each CTA sums its slice's
part of S (its slice of q resident in shared memory), the cluster adds the
parts through distributed shared memory so that every CTA holds the same S,
and each CTA runs the softmax and P V over its slice's output columns. Its
launches count here at 64 and on :func:`flash_attention_hd` at the others.
In f32 (the forward of the training path) ``csrc/flash_online.cu`` runs at
every head dim up to 128: the split-TF32 (3xTF32) ``wgmma`` + TMA cell of
``csrc/tf32x3_cell.cuh``; above 128 ``csrc/flash_online_wide.cu``, the same
cluster plan in 3xTF32 with slices of at most 128 columns, each CTA on the
cell's 128-column plan (q_hi resident, q_lo in registers): from 160 to 256 a
pair of CTAs on slices in units of 32 columns, above 256 in units of 64. Its
launches count here at 64 and on :func:`flash_attention_f32_hd` at the
others.
Both keep the JAX preparation: ``sm_scale * log2e`` folded into q and rounded
to q's dtype (by the wrapper for f32, in the kernel for bf16) and the
``kv_valid`` tail zeroed; neither pads tokens (TMA reads rows past the ends
as zeros). Each runs a base-2 online softmax with kv columns ``>= kv_len``
masked to ``-0.7 * f32max``.
The denominator follows the TPU kernel: at head_dim < 128 (``denom="mxu"``)
it sums p rounded to v's dtype, because the TPU summed p through a ones
column of the PV matmul; at head_dim >= 128 (``"vpu"``) it sums unrounded p.
A zero denominator divides by 1.

K3 in f32 at every head dim (:func:`flash_attention_fixed_max_f32`) runs
``csrc/flash_fixed_max_hd.cu``, the same 3xTF32 cell. The f32 kernels take
their operands split by :func:`_tf32_operands`: every f32 x as ``x_hi =
tf32(x)`` and ``x_lo = tf32(x - x_hi)``, v transposed with its kv order
permuted in groups of 8; the cell keeps three of the four products (hi.hi,
hi.lo, lo.hi), f32-accurate to about 2**-22 of a product, and no product is a
single TF32 pass.

K2, :func:`flash_attention_prepacked`: ``csrc/flash_prepacked.cu`` replaces
``_flash_kernel_prepacked``, both its int8 and its float (``AETHER_ATTN_QK8=0``)
branch. K2 and K3 are one Hopper kernel, the fixed-shift cell of
``csrc/fixed_cell.cuh`` (``wgmma`` for both products, a TMA ring, p kept in
registers between them, no running max) templated over the head dim; on the
H100 it is bound by the SFU's exp2 (int8) or by bf16 operations (1.1e10 exp2
and 2.8e12 operations per K2 call at 48 heads x 15076 valid tokens and head_dim
64); the sources carry the full note. K2 takes the cell at every head dim up
to 128, its launches counted here at 64 and on
:func:`flash_attention_prepacked_hd` at the others.

Head dims. Every kernel is built at the widths 16 to 128 in steps of 16, K4
also at 160 to 256 in steps of 32, and above 256 K4's wide kernels take any
multiple of 64 as a run-time width. A head dim between two widths runs the
instance of the next width up (:func:`head_dim_width`) on operands with zero
columns up to it:
the wrappers pad q, k and v (one copy; K3 and K6 quantize straight into the
wider codes; K2 reads ``qkv_prologue``'s outputs, which the prologue writes
that wide, in place), the kernel's output keeps its first D columns, and
``sm_scale`` and every fold come from the true D. Zero columns change no
score, no norm, no group maximum and no sum, so the result is the function
at D. K3 and K6 take every head dim below 128 (the JAX wrapper turns the
fixed max off at 128 and above), K2 every one up to 128 (above, it raises
``NotImplementedError``; the JAX wrapper sends those to K4) and K4 every
head dim from 1 up, as the JAX wrapper does.

K2's math (log2 domain, non-causal, one fixed shift per head group):

    s   = f32(q8 . k8^T) * (qsc[g, row tile] * ksc[g, col tile])   (int8 q/k)
    s   = q . k^T                                                   (float q/k)
    p   = exp2(s - max_t qn[g, t] * max_t kn[g, t])   (the shift 0 under
          ``noshift``; under ``noshift=None`` when every group's is < 96)
    out = sum_j p_j v_j / sum_j p_j,   p rounded to v's dtype in both sums,
          a zero denominator divides by 1

Columns ``>= s_valid`` are masked out of the numerator and the denominator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from aether_tpu_torch.ops import _build

_NEG_INF = -0.7 * torch.finfo(torch.float32).max
_LOG2E = 1.4426950408889634
_NOSHIFT_BELOW = 96.0   # noshift=None drops the shift when max(bound) < this


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


_NOSHIFT_CODES = {False: 0, True: 1, None: 2}  # K2's C argument
# the largest head dim K3 and K6 take on CUDA (the JAX wrapper turns the
# fixed max off at 128 and above), and K2 (K4 takes every one)
FIXED_MAX_TOP, PREPACKED_TOP = 127, 128
# K4's head dims above these run the wide kernels (the width at run time):
# bf16 above online_cell's 256, f32 above tf32x3_cell's 128
ONLINE_CELL_TOP = 256
_WIDE_FROM = {torch.bfloat16: ONLINE_CELL_TOP, torch.float32: 128}


class WidePlan(NamedTuple):
    """The launch plan of K4's wide kernels at one width (:func:`_wide_plan`)."""

    cluster: int            # CTAs of a thread-block cluster, which split S's head dim
    groups: int             # clusters along the grid's y axis (each computes S)
    score_cols: tuple       # head-dim columns of S summed by each rank of a cluster
    out_cols: tuple         # output columns of each CTA along y (cluster * groups)


# the wide kernels' largest slice of the head dim a CTA (kC in
# csrc/flash_online_wide_bf16.cu / flash_online_wide.cu) and largest cluster
# (hopper.cuh's kWideCluster, the portable size)
_WIDE_SLICE = {torch.bfloat16: 256, torch.float32: 128}
_WIDE_CLUSTER = 8


def _split_units(units: int, parts: int, unit: int) -> tuple:
    """``units`` units of ``unit`` columns dealt out over ``parts`` in order,
    the first ``units % parts`` one more (hopper.cuh's part_count), in
    columns."""
    return tuple(unit * (units // parts + (i < units % parts)) for i in range(parts))


def _wide_plan(dp: int, dtype: torch.dtype) -> WidePlan:
    """The cluster plan of K4's wide kernels at width ``dp`` for q of
    ``dtype``, as ``csrc/hopper.cuh``'s wide_cluster and wide_groups compute
    it over ``slice_unit`` columns a unit (the C entries refuse another): a
    cluster of ceil(dp / slice) CTAs, at most 8, splits the head dim of a q
    tile for S, slices of at most 256 columns in bf16 and 128 in f32, dealt
    out evenly in units of 64 columns (dp a multiple of 64 above 256), or in
    f32 from 160 to 256 (a multiple of 32) in units of 32: a pair, 160 96 +
    64, 192 96 + 96, 224 128 + 96, 256 128 + 128; uneven where the units do
    not divide (320: bf16 192 + 128, f32 128 + 128 + 64); above 8 slices
    ``groups`` clusters along y each compute S so and share the output
    columns evenly, at most one slice each."""
    low = _WIDE_FROM[dtype]
    unit = 32 if dp <= ONLINE_CELL_TOP else 64
    if dp <= low or dp % unit:
        raise ValueError(f"the wide kernels in {str(dtype)[6:]} take a multiple of 32 "
                         f"up to 256 or of 64 above, above {low}, not {dp}")
    units, top = dp // unit, _WIDE_SLICE[dtype] // unit
    cluster = min(_WIDE_CLUSTER, -(-units // top))
    groups = -(-units // (cluster * top))
    return WidePlan(cluster, groups, _split_units(units, cluster, unit),
                    _split_units(units, cluster * groups, unit))


def head_dim_width(head_dim: int) -> int:
    """The width of the kernel instance that runs ``head_dim``: up to 128 the
    head dim itself at a multiple of 16, else the next one up; above 128 the
    next multiple of 32 (160, 192, 224 or 256 for K4); above 256 the next
    multiple of 64 (K4's wide kernels, which read the width at run time)."""
    step = 16 if head_dim <= 128 else 32 if head_dim <= ONLINE_CELL_TOP else 64
    return -(-head_dim // step) * step


def _check_head_dim(kernel: str, head_dim: int, top: Optional[int] = None) -> int:
    """The width of ``head_dim``'s instance (:func:`head_dim_width`);
    ``NotImplementedError`` outside 1 to ``top`` (no upper limit where
    ``top`` is None)."""
    if head_dim < 1 or (top is not None and head_dim > top):
        raise NotImplementedError(
            f"{kernel} takes head_dim 1 to {top} on CUDA, got {head_dim} (the JAX "
            "wrapper sends no other head dim to it)")
    return head_dim_width(head_dim)


def _pad_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` [..., D] with zero columns up to ``width`` (one copy), or ``t``
    itself where D is the width."""
    d = t.shape[-1]
    if d == width:
        return t
    out = t.new_zeros((*t.shape[:-1], width))
    out[..., :d] = t
    return out


def _prepacked_rows(ts, d: int, width: int) -> int:
    """The row stride (elements) at which K2's kernel reads q, k and v: ``d``
    where they are contiguous, ``width`` where each is the first ``d``
    columns of a contiguous [BH, S, width] buffer (``qkv_prologue``'s outputs
    at a head dim below their width). ``ValueError`` otherwise."""
    if all(t.is_contiguous() for t in ts):
        return d
    if d != width and all(t.stride() == (t.shape[1] * width, width, 1) for t in ts):
        return width
    raise ValueError("K2 operands must be contiguous on one device (or qkv_prologue's "
                     "column views of a wider buffer)")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous with a 16-byte aligned start (the kernels' 16-byte
    loads); a view that starts elsewhere is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _shift_or_zero(bounds: torch.Tensor, noshift: Optional[bool]) -> torch.Tensor:
    """The per-group softmax shift: ``bounds``, or 0 where ``noshift`` drops
    it; ``noshift=None`` decides on the device, without a host sync: 0 when
    ``max(bounds) < 96``."""
    if noshift is None:
        return torch.where(bounds.amax() < _NOSHIFT_BELOW, torch.zeros_like(bounds), bounds)
    return torch.zeros_like(bounds) if noshift else bounds


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
    noshift: Optional[bool] = False,
) -> torch.Tensor:
    """Plain PyTorch K2: loops over head groups and q tiles so no score tensor
    is larger than (heads_per_cell, block, S_pad) in f32."""
    bh, s_pad, d = q.shape
    s_valid = s_pad if s_valid is None else s_valid
    block, hper = _check_grid(q, qsc, block_q, heads_per_cell)
    qk_int8 = q.dtype == torch.int8
    bounds = _shift_or_zero(qn.amax(dim=-1) * kn.amax(dim=-1), noshift)  # [G]
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
    noshift: Optional[bool] = False,
) -> torch.Tensor:
    """Fixed-max attention over ``qkv_prologue``'s outputs -> [B*H, S_pad, D].

    Args:
        q / k: [B*H, S_pad, D] int8 (per-(group, tile) scales) or a float
            dtype carrying the ``sm_scale*log2e`` fold on q (bf16 on CUDA).
        v: [B*H, S_pad, D] plain values, rows >= s_valid zeroed.
        qsc / ksc / qn / kn: [G, T] f32 scales and L2-norm maxima.
        s_valid: number of real tokens; later kv columns are masked.
        noshift: True drops the shift (p = exp2(s)); None drops it, decided
            on the device, when every group's bound is below 96.

    A CPU tensor runs :func:`flash_attention_prepacked_plain`. A CUDA tensor
    launches the Hopper kernel at any head dim up to 128 (counted here at
    64, on :func:`flash_attention_prepacked_hd` at the others) or raises;
    there is no fallback. Below its instance's width the kernel reads q, k
    and v D columns wide, zero-filled to the width: ``qkv_prologue``'s
    column views in place, contiguous operands where their rows are 16-byte
    aligned, else zero-padded copies; the output is the first D columns of a
    [B*H, S_pad, width] buffer.
    """
    if noshift not in _NOSHIFT_CODES:
        raise ValueError(f"noshift must be False, True or None, got {noshift!r}")
    if not q.is_cuda:
        return flash_attention_prepacked_plain(
            q, k, v, qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=s_valid,
            block_q=block_q, heads_per_cell=heads_per_cell, noshift=noshift)
    bh, s_pad, d = q.shape
    s_valid = s_pad if s_valid is None else s_valid
    if q.dtype not in (torch.int8, torch.bfloat16) or k.dtype != q.dtype:
        raise TypeError(f"K2 takes int8 or bf16 q/k of one dtype on CUDA, got "
                        f"{q.dtype}/{k.dtype}")
    width = _check_head_dim("K2", d, PREPACKED_TOP)
    if v.dtype != torch.bfloat16:
        raise TypeError(f"K2 takes bf16 v, got {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (bh, s_pad, d):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(bh, s_pad, d)}")
    block, hper = _check_grid(q, qsc, block_q, heads_per_cell)
    if block % 128:  # a 128-column kv tile must lie in one quantization block
        raise ValueError(f"K2 needs a block that is a multiple of 128, got {block}")
    if not 0 < s_valid <= s_pad:
        raise ValueError(f"s_valid {s_valid} outside (0, {s_pad}]")
    for t in (q, k, v, qsc, ksc, qn, kn):
        if t.device != q.device:
            raise ValueError("K2 operands must be contiguous on one device")
    for t in (qsc, ksc, qn, kn):
        if not t.is_contiguous():
            raise ValueError("K2 operands must be contiguous on one device")
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(qsc.shape):
            raise ValueError("K2 stats must be [G, T] float32")
    ld = _prepacked_rows((q, k, v), d, width)
    if any(ld * t.element_size() % 16 for t in (q, v)):  # rows TMA cannot take
        q, k, v = (_pad_cols(t, width) for t in (q, k, v))
        ld = width
    out = torch.empty((bh, s_pad, width), dtype=torch.bfloat16, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qsc.data_ptr(), ksc.data_ptr(),
            qn.data_ptr(), kn.data_ptr(), out.data_ptr(), bh, s_pad, s_valid, hper, block,
            s_pad // block, int(q.dtype == torch.int8), _NOSHIFT_CODES[noshift])
    if d != 64:
        flash_attention_prepacked_hd(args, width, d, ld, q.device)
    else:
        _prepacked_launch(args, width, d, ld, q.device)
        _build.count_launch(flash_attention_prepacked)
    return out if width == d else out[..., :d]


# wrapper calls that launched the Hopper kernel at head_dim 64 (a plain integer)
flash_attention_prepacked.launches = 0


def _prepacked_launch(args: tuple, width: int, cols: int, ld: int, device) -> None:
    """K2's kernel (``csrc/flash_prepacked.cu``, the instance of ``width``)
    alone, uncounted, on the C arguments :func:`flash_attention_prepacked`
    makes of its checked operands: q, k and v ``cols`` columns of rows ``ld``
    elements apart."""
    rc = _build.lib().aether_flash_prepacked(*args, width, cols, ld,
                                             _build.stream_ptr(device))
    _build.check(rc, "aether_flash_prepacked")


def flash_attention_prepacked_hd(args: tuple, width: int, cols: int, ld: int,
                                 device) -> None:
    """K2 at a head dim other than 64: :func:`_prepacked_launch` (the same
    ``wgmma`` + TMA kernel as at 64), its launches counted here.
    ``.launches`` counts them."""
    _prepacked_launch(args, width, cols, ld, device)
    _build.count_launch(flash_attention_prepacked_hd)


flash_attention_prepacked_hd.launches = 0


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


def _online_fold(sm_scale: Optional[float], dim: int) -> float:
    """The factor folded into q: ``sm_scale * log2e``, sm_scale 1/sqrt(dim)
    by default."""
    if sm_scale is None:
        sm_scale = 1.0 / (dim ** 0.5)
    return sm_scale * _LOG2E


def _online_kv(k, v, kv_valid):
    """The k/v rows at or past ``kv_valid`` zeroed. Returns (k, v, kv_len)."""
    kv_len_in = k.shape[2]
    kv_len = kv_len_in if kv_valid is None else min(kv_valid, kv_len_in)
    if kv_len < 0:
        raise ValueError(f"kv_valid {kv_valid} < 0")
    if kv_len < kv_len_in:
        tail = (torch.arange(kv_len_in, device=k.device) >= kv_len)[:, None]
        k = k.masked_fill(tail, 0)
        v = v.masked_fill(tail, 0)
    return k, v, kv_len


def _online_operands(q, k, v, sm_scale, kv_valid):
    """The JAX wrapper's preparation: q times ``sm_scale * log2e`` rounded to
    q's dtype, and the k/v rows at or past ``kv_valid`` zeroed.

    Returns (q, k, v, kv_len)."""
    k, v, kv_len = _online_kv(k, v, kv_valid)
    q = (q.float() * _online_fold(sm_scale, q.shape[-1])).to(q.dtype)
    return q, k, v, kv_len


def _online_kernel_operands(q, k, v, sm_scale, kv_valid):
    """K4's operands as its CUDA path hands them to the kernels: q, k and v
    [BH, S, width] (``head_dim_width`` of the head dim D, zero columns past
    D; contiguous, 16-byte aligned), the k/v rows at or past ``kv_valid``
    zeroed, q not yet folded. Returns (q, k, v, kv_len, fold), the fold
    ``sm_scale * log2e`` of the true D."""
    b, h, _, dim = q.shape
    width = head_dim_width(dim)
    k, v, kv_len = _online_kv(k, v, kv_valid)
    qh, kh, vh = (_aligned(_pad_cols(t.reshape(b * h, t.shape[2], dim), width))
                  for t in (q, k, v))
    return qh, kh, vh, kv_len, _online_fold(sm_scale, dim)


def _online_bf16_launch(qh, kh, vh, out, kv_len: int, round_l: bool, fold: float) -> None:
    """The K4 bf16 kernel alone, uncounted, on prepared operands: q [BH, Sq,
    D] (not yet folded; the kernel rounds bf16(q * fold)), k/v [BH, Skv, D]
    with rows >= kv_len zeroed, out [BH, Sq, D]; all bf16, contiguous and
    16-byte aligned, D a width: 16 to 128 in steps of 16 and 160 to 256 in
    steps of 32 (``csrc/flash_online_bf16.cu``), or above 256 any multiple of
    64 (``csrc/flash_online_wide_bf16.cu`` on :func:`_wide_plan`'s clusters,
    "vpu" only: ``ValueError`` on ``round_l``)."""
    bh, sq, dim = qh.shape
    stream = _build.stream_ptr(qh.device)
    if dim > ONLINE_CELL_TOP:
        if round_l:
            raise ValueError("K4 above head_dim 256 takes the 'vpu' denominator only "
                             "(the JAX wrapper forces it at head_dim >= 128)")
        plan = _wide_plan(dim, torch.bfloat16)
        rc = _build.lib().aether_flash_online_wide_bf16(
            qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
            bh, sq, kh.shape[1], kv_len, fold, dim, plan.cluster, plan.groups, stream)
        _build.check(rc, "aether_flash_online_wide_bf16")
        return
    rc = _build.lib().aether_flash_online_bf16(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), out.data_ptr(),
        bh, sq, kh.shape[1], kv_len, int(round_l), fold, dim, stream)
    _build.check(rc, "aether_flash_online_bf16")


def flash_attention_hd(qh, kh, vh, out, kv_len: int, round_l: bool, fold: float) -> None:
    """K4 in bf16 at a head dim other than 64: :func:`_online_bf16_launch`
    (the same ``wgmma`` + TMA kernel as at 64), its launches counted here.
    ``.launches`` counts them."""
    _online_bf16_launch(qh, kh, vh, out, kv_len, round_l, fold)
    _build.count_launch(flash_attention_hd)


flash_attention_hd.launches = 0


# ---- the f32 kernels' operands: split TF32 (csrc/tf32x3_cell.cuh) ----

_TF32_HALF, _TF32_MASK = 0x1000, -0x2000  # half of tf32's last place; the low 13 bits off
# the kv order inside every group of 8 columns of V^T: column 8 g + i holds kv
# row 8 g + _TF32_KV_ORDER[i], the order in which a thread of the cell holds
# p as the A operand of P V (its S accumulator columns 2c, 2c + 1 of a group
# are the A fragment's columns c, c + 4)
_TF32_KV_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 (a 10-bit mantissa), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds and the cell's
    ``tf32_rna`` computes: an integer add and and on the f32 bits (a carry out
    of the mantissa rounds the exponent up), the low 13 bits zero. Returns a
    new contiguous tensor."""
    bits = x.contiguous().view(torch.int32) + _TF32_HALF
    return bits.bitwise_and_(_TF32_MASK).view(torch.float32)


def _tf32_split(x: torch.Tensor):
    """(hi, lo) = (tf32(x), tf32(x - hi)), both contiguous f32: hi + lo is x
    to 2**-22 of |x| (x - hi is exact in f32; lo is rounded in place)."""
    x = x.contiguous()
    hi = _tf32_round(x)
    lo = x - hi
    lo.view(torch.int32).add_(_TF32_HALF).bitwise_and_(_TF32_MASK)
    return hi, lo


def _tf32_vt(v: torch.Tensor) -> torch.Tensor:
    """[BH, Skv, D] -> [BH, D, Skv8], Skv8 = Skv rounded up to 8 (TMA's
    16-byte row stride): v transposed, kv contiguous (tf32 ``wgmma`` reads B
    only K-major), the kv order permuted by ``_TF32_KV_ORDER`` inside every
    group of 8, the columns past Skv zero. The sum over kv is unchanged."""
    bh, skv, dim = v.shape
    skv8 = -(-skv // 8) * 8
    vt = v.new_zeros((bh, dim, skv8))
    vt[:, :, :skv] = v.transpose(1, 2)
    order = torch.tensor(_TF32_KV_ORDER, device=v.device)
    return vt.view(bh, dim, skv8 // 8, 8).index_select(3, order).view(bh, dim, skv8)


class _Tf32Operands(NamedTuple):
    """The f32 kernels' operands (csrc/tf32x3_cell.cuh), split by
    :func:`_tf32_operands`; all contiguous, 16-byte aligned."""

    q_hi: torch.Tensor   # [BH, Sq, D] f32, or the int8 codes
    q_lo: torch.Tensor   # [BH, Sq, D] f32 (the codes again: unread)
    k_hi: torch.Tensor   # [BH, Skv, D] f32, or the int8 codes
    k_lo: torch.Tensor   # [BH, Skv, D] f32 (the codes again: unread)
    vt_hi: torch.Tensor  # [BH, D, Skv8] f32 (``_tf32_vt``)
    vt_lo: torch.Tensor


def _tf32_operands(qh, kh, vh) -> _Tf32Operands:
    """Split f32 q, k ([BH, S, D]; int8 codes pass as they are) and v ([BH,
    Skv, D] f32, rows >= kv_len already zero) into the 3xTF32 cell's hi/lo
    operands, v as :func:`_tf32_vt`."""
    if qh.dtype == torch.int8:
        (q_hi, q_lo), (k_hi, k_lo) = ((_aligned(t),) * 2 for t in (qh, kh))
    else:
        (q_hi, q_lo), (k_hi, k_lo) = _tf32_split(qh), _tf32_split(kh)
    vt_hi, vt_lo = _tf32_split(_tf32_vt(vh))
    return _Tf32Operands(*(_aligned(t) for t in (q_hi, q_lo, k_hi, k_lo, vt_hi, vt_lo)))


def _online_f32_launch(t: _Tf32Operands, out: torch.Tensor, kv_len: int) -> None:
    """The K4 f32 kernel alone, uncounted, on :func:`_tf32_operands` of
    :func:`_online_operands`' result (q folded, k/v rows >= kv_len zeroed);
    out [BH, Sq, D] f32, D a width: 16 to 128 in steps of 16
    (``csrc/flash_online.cu``), or above 128 160 to 256 in steps of 32 and
    any multiple of 64 above (``csrc/flash_online_wide.cu`` on
    :func:`_wide_plan`'s clusters)."""
    bh, sq, dim = t.q_hi.shape
    args = [*(x.data_ptr() for x in t), out.data_ptr(), bh, sq, t.k_hi.shape[1], kv_len, dim]
    name = "aether_flash_online"
    if dim > _WIDE_FROM[torch.float32]:
        name = "aether_flash_online_wide"
        args += _wide_plan(dim, torch.float32)[:2]
    rc = getattr(_build.lib(), name)(*args, _build.stream_ptr(out.device))
    _build.check(rc, name)


def flash_attention_f32_hd(t: _Tf32Operands, out: torch.Tensor, kv_len: int) -> None:
    """K4 in f32 at a head dim other than 64: :func:`_online_f32_launch` (the
    same 3xTF32 kernel as at 64), counted here. ``.launches`` counts its
    launches."""
    _online_f32_launch(t, out, kv_len)
    _build.count_launch(flash_attention_f32_hd)


flash_attention_f32_hd.launches = 0


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
    if dim >= 128:
        denom = "vpu"
    if denom not in ("mxu", "vpu"):
        raise ValueError(f"denom must be 'mxu' or 'vpu', got {denom!r}")
    k, v, kv_len = _online_kv(k, v, kv_valid)
    qh, kh, vh = (t.reshape(b * h, t.shape[2], dim) for t in (q, k, v))
    out = _online_loop(qh, kh, vh, kv_len, _online_fold(sm_scale, dim), denom, block_q,
                       block_k, heads_per_cell)
    return out.reshape(b, h, sq, dim)


def _online_loop(qh, kh, vh, kv_len: int, fold: float, denom: str, block_q: int,
                 block_k: int, heads_per_cell: int) -> torch.Tensor:
    """Plain K4 over q [BH, Sq, D] (not yet folded: q times ``fold`` rounded
    to q's dtype first, as the JAX wrapper does) and k/v [BH, Skv, D] with
    rows >= ``kv_len`` zeroed (:func:`flash_attention_plain`'s loop, or the
    kernels' operands of :func:`_online_kernel_operands`). Returns [BH, Sq,
    D]."""
    bh, sq, dim = qh.shape
    qh = (qh.float() * fold).to(qh.dtype)
    block_k = _pick_block(kh.shape[1], block_k)
    block_q = _pick_block(sq, block_q)
    hper = _heads_per_cell(bh, heads_per_cell)
    dev = qh.device
    out = torch.empty((bh, sq, dim), dtype=qh.dtype, device=dev)
    for g0 in range(0, bh, hper):
        heads = slice(g0, g0 + hper)
        for r0 in range(0, sq, block_q):
            qb = qh[heads, r0:r0 + block_q].float()
            rows = qb.shape[1]
            m = torch.full((hper, rows, 1), float("-inf"), device=dev)
            l = torch.zeros((hper, rows, 1), device=dev)
            acc = torch.zeros((hper, rows, dim), device=dev)
            # blocks wholly past kv_len leave m, l and acc exactly unchanged
            # (alpha = 1, p = 0), so the loop stops at kv_len
            for c0 in range(0, kv_len, block_k):
                kb = kh[heads, c0:c0 + block_k].float()
                s = torch.matmul(qb, kb.transpose(1, 2))
                if c0 + s.shape[-1] > kv_len:
                    col = torch.arange(c0, c0 + s.shape[-1], device=dev)
                    s = s.masked_fill(col >= kv_len, _NEG_INF)
                m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                alpha = torch.exp2(m - m_next)
                m = m_next
                p = torch.exp2(s - m_next)
                p_v = p.to(vh.dtype).float()
                l_cur = p_v if denom == "mxu" else p
                l = l * alpha + l_cur.sum(dim=-1, keepdim=True)
                acc = acc * alpha + torch.matmul(p_v, vh[heads, c0:c0 + block_k].float())
            l_inv = torch.where(l <= 0.0, torch.ones_like(l), 1.0 / l)
            out[heads, r0:r0 + rows] = (acc * l_inv).to(qh.dtype)
    return out


# ---------------------------------------------------------------------------
# K3 and K6: the fixed-max family (``flash_attention(fixed_max=True)``)
# ---------------------------------------------------------------------------

_FIXED_TILE = 64        # K6's wrapper pads q rows to a multiple of this
_PV8_NEG = -1e9         # K6's padding bias and initial running max


class _FixedMaxOperands(NamedTuple):
    """The fixed-max kernels' operands, prepared as the JAX wrapper does."""

    q: torch.Tensor        # [BH, Sq, D] int8, or float carrying the fold
    k: torch.Tensor        # [BH, Skv, D] int8 or float, rows >= kv_len zero
    v: torch.Tensor        # [BH, Skv, D] float (K3) or int8 (K6), rows >= kv_len zero
    kv_len: int
    hper: int
    shift: torch.Tensor    # [G] f32 softmax shift, 0 where the shift is dropped
    scale: torch.Tensor    # [G] f32 dequantization of int8 scores (1 for float)
    vscale: Optional[torch.Tensor]  # [G] f32 max |v| of the group (K6)
    out_dtype: torch.dtype


def _group_absmax(x: torch.Tensor, hper: int) -> torch.Tensor:
    """[BH, S, D] -> [BH / hper] f32: max |x| over each head group, floored
    at 1e-30 (the symmetric quantization's max-abs scale). One pass over x
    in its own dtype: max |x| = max(max x, -min x), exactly."""
    lo, hi = torch.aminmax(x.reshape(x.shape[0] // hper, -1), dim=-1)
    return torch.maximum(hi.float(), -lo.float()).clamp_min(1e-30)


def _quantize_groups(x: torch.Tensor, absmax: torch.Tensor, hper: int,
                     width: Optional[int] = None) -> torch.Tensor:
    """Symmetric int8 codes ``rint(x * r)``, ``r = 127 / absmax[group]``
    correctly rounded in f32, as XLA divides (torch's ``127.0 / t`` is
    ``127 * reciprocal(t)``, two roundings, which can move a code that lies
    on a half-way point). ``width``: the codes written straight into a
    [BH, S, width] buffer of zeros (the kernels' padded operand)."""
    r = (torch.full_like(absmax, 127.0) / absmax).repeat_interleave(hper)[:, None, None]
    codes = (x * r).round_()  # x * r in f32 (type promotion)
    if width is None or width == x.shape[-1]:
        return codes.to(torch.int8)
    out = torch.zeros((*x.shape[:-1], width), dtype=torch.int8, device=x.device)
    out[..., :x.shape[-1]] = codes
    return out


def _fixed_max_operands(q, k, v, *, sm_scale, kv_valid, heads_per_cell,
                        noshift, qk_int8, pv_int8, score_bound,
                        unnormalized, width: Optional[int] = None) -> _FixedMaxOperands:
    """The JAX wrapper's preparation (``flash_attention``, :499-680) in plain
    torch ops, run outside the kernel as XLA ran it. ``width``: q, k and v
    come out [BH, S, width] with zero columns past the head dim D (the
    kernel instance's operands; int8 codes quantized straight into them),
    everything else computed at D: the default ``sm_scale`` 1/sqrt(D), the
    fold, the bounds and the group maxima.

    The per-group shift is the Cauchy-Schwarz bound ``max_h(max_t |q_t| *
    max_t |k_t|)`` over the group's heads (log2 domain), or ``score_bound``.
    ``noshift=None`` decides on the device, without a host sync: shift 0
    when ``max(bound) < 96``, else the bound. K6 ignores the shift."""
    b, h, _, dim = q.shape
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (dim ** 0.5)
    fold = sm_scale * _LOG2E
    kv_len = skv if kv_valid is None else min(kv_valid, skv)
    if kv_len < 0:
        raise ValueError(f"kv_valid {kv_valid} < 0")
    if kv_len < skv:
        tail = (torch.arange(skv, device=k.device) >= kv_len)[:, None]
        k = k.masked_fill(tail, 0)
        v = v.masked_fill(tail, 0)
    out_dtype = q.dtype
    if not qk_int8:
        q = (q.float() * fold).to(q.dtype)
    bh = b * h
    hper = _heads_per_cell(bh, heads_per_cell)
    groups = bh // hper
    qh, kh, vh = (t.reshape(bh, t.shape[2], dim) for t in (q, k, v))
    if score_bound is not None:
        bounds = torch.as_tensor(score_bound, dtype=torch.float32,
                                 device=q.device).reshape(()).repeat(groups)
    elif pv_int8:  # K6 derives its own integer max and reads no shift
        bounds = torch.zeros(groups, dtype=torch.float32, device=q.device)
    else:
        qn = qh.float().square().sum(dim=-1).sqrt().amax(dim=-1)
        kn = kh.float().square().sum(dim=-1).sqrt().amax(dim=-1)
        bounds = (qn * kn).reshape(groups, hper).amax(dim=-1)
    if qk_int8:
        if score_bound is None:
            bounds = bounds * fold
        aq, ak = _group_absmax(qh, hper), _group_absmax(kh, hper)
        scale = aq * ak * (fold / (127.0 * 127.0))
        qh, kh = _quantize_groups(qh, aq, hper, width), _quantize_groups(kh, ak, hper, width)
    else:
        scale = torch.ones_like(bounds)
    vscale = None
    if pv_int8:
        vscale = _group_absmax(vh, hper)
        vh = _quantize_groups(vh, vscale, hper, width)
    if width is not None:
        qh, kh, vh = (_pad_cols(t, width) for t in (qh, kh, vh))
    # the ring merge always takes the shared bound as its shift
    shift = bounds if unnormalized else _shift_or_zero(bounds, noshift)
    return _FixedMaxOperands(qh, kh, vh, kv_len, hper, shift.contiguous(),
                             scale.contiguous(), vscale, out_dtype)


def _fixed_max_loop(ops: _FixedMaxOperands, block_q: int, unnormalized: bool):
    """Plain K3 over prepared operands: head groups and q blocks looped, no
    score tensor larger than (hper, block_q, Skv) in f32. Returns (out, l),
    l None unless ``unnormalized``."""
    qh, kh, vh = ops.q, ops.k, ops.v
    bh, sq, dim = qh.shape
    block = _pick_block(sq, block_q)
    col_ok = torch.arange(kh.shape[1], device=qh.device) < ops.kv_len
    zero = torch.zeros((), dtype=torch.float32, device=qh.device)
    out = torch.empty((bh, sq, dim), dtype=ops.out_dtype, device=qh.device)
    l_out = (torch.empty((bh, sq, 1), dtype=torch.float32, device=qh.device)
             if unnormalized else None)
    for g in range(bh // ops.hper):
        heads = slice(g * ops.hper, (g + 1) * ops.hper)
        kt = kh[heads].float().transpose(1, 2)
        vf = vh[heads].float()
        for r0 in range(0, sq, block):
            rows = slice(r0, r0 + block)
            s = torch.matmul(qh[heads, rows].float(), kt)
            if qh.dtype == torch.int8:
                s = s * ops.scale[g]
            p = torch.exp2(s - ops.shift[g])
            p = torch.where(col_ok, p, zero).to(vh.dtype).float()
            num = torch.matmul(p, vf)
            den = p.sum(dim=-1, keepdim=True)
            if unnormalized:
                out[heads, rows] = num.to(ops.out_dtype)
                l_out[heads, rows] = den
            else:
                inv = torch.where(den <= 0.0, torch.ones_like(den), 1.0 / den)
                out[heads, rows] = (num * inv).to(ops.out_dtype)
    return out, l_out


def _finish_heads(x: torch.Tensor, b: int, h: int, rows: int) -> torch.Tensor:
    """[BH, >= rows, C] -> [B, H, rows, C]."""
    return x[:, :rows].reshape(b, h, rows, x.shape[-1])


def flash_attention_fixed_max_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    kv_valid: Optional[int] = None,
    block_q: int = 1024,
    heads_per_cell: int = 4,
    noshift: Optional[bool] = False,
    qk_int8: bool = False,
    score_bound=None,
    unnormalized: bool = False,
):
    """Plain PyTorch K3, q [B, H, Sq, D] x k/v [B, H, Skv, D]; the arguments
    of :func:`flash_attention_fixed_max`.

    In the log2 domain, per head group g:

        s   = f32(int32(q8 . k8^T)) * scale_g     (int8 q/k)
        s   = f32(q . k^T), q carrying the fold   (float q/k)
        p   = exp2(s - shift_g), 0 at columns >= kv_len
        out = sum_j v(p_j) v_j / sum_j v(p_j)     (v(p): p rounded to v's
              dtype, as the TPU's ones column of the PV matmul summed it;
              a zero denominator divides by 1)

    ``unnormalized=True`` returns ``(numerator in q's dtype, denominator in
    f32 [B, H, Sq, 1])`` for the ring merge instead."""
    b, h, sq, _ = q.shape
    ops = _fixed_max_operands(
        q, k, v, sm_scale=sm_scale, kv_valid=kv_valid,
        heads_per_cell=heads_per_cell, noshift=noshift, qk_int8=qk_int8,
        pv_int8=False, score_bound=score_bound, unnormalized=unnormalized)
    out, l_out = _fixed_max_loop(ops, block_q, unnormalized)
    if unnormalized:
        return _finish_heads(out, b, h, sq), _finish_heads(l_out, b, h, sq)
    return _finish_heads(out, b, h, sq)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """[BH, S, D] zero-padded to [BH, rows, D], contiguous (K6's operands)."""
    if t.shape[1] == rows:
        return t.contiguous()
    buf = t.new_zeros((t.shape[0], rows, t.shape[2]))
    buf[:, :t.shape[1]] = t
    return buf


def _fixed_max_launch(ops: _FixedMaxOperands, out: torch.Tensor,
                      l_out: Optional[torch.Tensor]) -> None:
    """The K3 kernel (``csrc/flash_fixed_max.cu``, bf16 v, any width,
    16 to 128 in steps of 16) alone, uncounted, on :func:`_fixed_max_operands`'
    result (int8 or bf16 q/k, [BH, S, D] with D a width; rows unpadded): out
    [BH, Sq, D] bf16, l_out [BH, Sq, 1] f32 or None (normalized)."""
    qh, kh, vh = (_aligned(t) for t in (ops.q, ops.k, ops.v))
    bh, sq, dim = qh.shape
    rc = _build.lib().aether_flash_fixed_max(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), ops.shift.data_ptr(),
        ops.scale.data_ptr(), out.data_ptr(),
        None if l_out is None else l_out.data_ptr(),
        bh, sq, kh.shape[1], ops.kv_len, ops.hper, int(qh.dtype == torch.int8), dim,
        _build.stream_ptr(qh.device))
    _build.check(rc, "aether_flash_fixed_max")


def flash_attention_fixed_max_hd(ops: _FixedMaxOperands, out: torch.Tensor,
                                 l_out: Optional[torch.Tensor]) -> None:
    """K3 with bf16 v at a head dim other than 64: :func:`_fixed_max_launch`,
    counted here. ``.launches`` counts its launches."""
    _fixed_max_launch(ops, out, l_out)
    _build.count_launch(flash_attention_fixed_max_hd)


flash_attention_fixed_max_hd.launches = 0


def _fixed_max_f32_launch(t: _Tf32Operands, ops: _FixedMaxOperands, out: torch.Tensor,
                          l_out: Optional[torch.Tensor]) -> None:
    """The K3 f32 kernel (``csrc/flash_fixed_max_hd.cu``, the 3xTF32 cell)
    alone, uncounted, on :func:`_tf32_operands` of :func:`_fixed_max_operands`'
    result (int8 or f32 q/k, f32 v): out [BH, Sq, D] f32, l_out [BH, Sq, 1]
    f32 or None (normalized)."""
    bh, sq, dim = t.q_hi.shape
    rc = _build.lib().aether_flash_fixed_max_f32(
        *(x.data_ptr() for x in t), ops.shift.data_ptr(), ops.scale.data_ptr(),
        out.data_ptr(), None if l_out is None else l_out.data_ptr(),
        bh, sq, t.k_hi.shape[1], ops.kv_len, ops.hper, int(t.q_hi.dtype == torch.int8), dim,
        _build.stream_ptr(out.device))
    _build.check(rc, "aether_flash_fixed_max_f32")


def flash_attention_fixed_max_f32(ops: _FixedMaxOperands, out: torch.Tensor,
                                  l_out: Optional[torch.Tensor]) -> None:
    """K3 in f32 at any head dim it takes on :func:`_fixed_max_operands`'
    result (int8 or f32 q/k, f32 v): the operands split
    (:func:`_tf32_operands`), then :func:`_fixed_max_f32_launch`; out [BH,
    Sq, D] f32, l_out [BH, Sq, 1] f32 or None. ``.launches`` counts its
    launches."""
    _fixed_max_f32_launch(_tf32_operands(ops.q, ops.k, ops.v), ops, out, l_out)
    _build.count_launch(flash_attention_fixed_max_f32)


flash_attention_fixed_max_f32.launches = 0


def _check_fixed_max_inputs(name: str, q, k, v, dtypes) -> int:
    """The checks of K3's and K6's CUDA path; returns the width of the head
    dim's instance."""
    b, h, _, dim = q.shape
    width = _check_head_dim(name, dim, FIXED_MAX_TOP)
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes {' or '.join(map(str, dtypes))} q/k/v of "
                        f"one dtype on CUDA, got {q.dtype}/{k.dtype}/{v.dtype}")
    skv = k.shape[2]
    for label, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, h, skv, dim) or t.device != q.device:
            raise ValueError(f"{label} {tuple(t.shape)} on {t.device} does not "
                             f"match ({b}, {h}, {skv}, {dim}) on {q.device}")
    return width


def flash_attention_fixed_max(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    kv_valid: Optional[int] = None,
    block_q: int = 1024,
    heads_per_cell: int = 4,
    noshift: Optional[bool] = False,
    qk_int8: bool = False,
    score_bound=None,
    unnormalized: bool = False,
):
    """K3: fixed-shift attention, q [B, H, Sq, D] x k/v [B, H, Skv, D].

    Sq may differ from Skv (a sequence-parallel q stripe against the full
    K/V). ``qk_int8`` quantizes q and k per head group over the whole
    sequence; ``noshift`` True / False / None drops, keeps or decides the
    shift; ``score_bound`` replaces the bound (ring merge) and
    ``unnormalized`` returns ``(o, l)``: o in q's dtype, l f32
    [B, H, Sq, 1].

    A CPU tensor runs :func:`flash_attention_fixed_max_plain`. A CUDA tensor
    (bf16 or f32 q/k/v, any lengths, a head dim below 128) launches a Hopper
    kernel or raises: bf16 ``csrc/flash_fixed_max.cu``, counted here at
    head_dim 64 and on :func:`flash_attention_fixed_max_hd` at the others;
    f32 at every head dim :func:`flash_attention_fixed_max_f32`; both on
    :func:`_fixed_max_operands` at the width of the head dim's instance.
    """
    opts = dict(sm_scale=sm_scale, kv_valid=kv_valid,
                heads_per_cell=heads_per_cell, noshift=noshift,
                qk_int8=qk_int8, score_bound=score_bound,
                unnormalized=unnormalized)
    if not q.is_cuda:
        return flash_attention_fixed_max_plain(q, k, v, block_q=block_q, **opts)
    width = _check_fixed_max_inputs("K3", q, k, v, (torch.bfloat16, torch.float32))
    b, h, sq, dim = q.shape
    ops = _fixed_max_operands(q, k, v, pv_int8=False, width=width, **opts)
    out = torch.empty((b * h, sq, width), dtype=q.dtype, device=q.device)
    l_out = (torch.empty((b * h, sq, 1), dtype=torch.float32, device=q.device)
             if unnormalized else None)
    if q.dtype == torch.float32:
        flash_attention_fixed_max_f32(ops, out, l_out)
    elif dim != 64:
        flash_attention_fixed_max_hd(ops, out, l_out)
    else:
        _fixed_max_launch(ops, out, l_out)
        _build.count_launch(flash_attention_fixed_max)
    out = out[..., :dim]
    if unnormalized:
        return _finish_heads(out, b, h, sq), _finish_heads(l_out, b, h, sq)
    return _finish_heads(out, b, h, sq)


# wrapper calls that launched the Hopper kernel at head_dim 64 in bf16 (a
# plain integer)
flash_attention_fixed_max.launches = 0


def _pv8_loop(ops: _FixedMaxOperands, block_q: int, block_k: int) -> torch.Tensor:
    """Plain K6 over prepared operands. The running max moves once per kv
    block of ``_pick_block(Skv, block_k)`` columns, as in the TPU kernel, so
    p8 is rounded against the same max; every product and per-block sum is
    an exact integer below 2**24."""
    qh, kh, vh = ops.q, ops.k, ops.v
    bh, sq, dim = qh.shape
    skv = kh.shape[1]
    bk = _pick_block(skv, block_k)
    kv_pad = -(-skv // bk) * bk
    kh, vh = _pad_rows(kh, kv_pad), _pad_rows(vh, kv_pad)
    bias = None
    if kv_pad > ops.kv_len:
        bias = torch.where(torch.arange(kv_pad, device=qh.device) < ops.kv_len,
                           0.0, _PV8_NEG).to(torch.float32)
    block = _pick_block(sq, block_q)
    out = torch.empty((bh, sq, dim), dtype=ops.out_dtype, device=qh.device)
    for g in range(bh // ops.hper):
        heads = slice(g * ops.hper, (g + 1) * ops.hper)
        kt = kh[heads].float().transpose(1, 2)
        vf = vh[heads].float()
        for r0 in range(0, sq, block):
            qb = qh[heads, r0:r0 + block].float()
            shape = (ops.hper, qb.shape[1], 1)
            m = torch.full(shape, _PV8_NEG, device=qh.device)
            l = torch.zeros(shape, device=qh.device)
            acc = torch.zeros((ops.hper, qb.shape[1], dim), device=qh.device)
            for c0 in range(0, kv_pad, bk):
                s = torch.matmul(qb, kt[:, :, c0:c0 + bk]) * ops.scale[g]
                if bias is not None:
                    s = s + bias[c0:c0 + bk]
                m_next = torch.maximum(m, torch.ceil(s.amax(dim=-1, keepdim=True)))
                alpha = torch.exp2(m - m_next)  # an exact power of two
                m = m_next
                p8 = torch.round(torch.exp2(s - m_next) * 127.0)
                acc = acc * alpha + torch.matmul(p8, vf[:, c0:c0 + bk])
                # the TPU's ones column is 127 at valid rows; p8 is 0 elsewhere
                l = l * alpha + p8.sum(dim=-1, keepdim=True) * 127.0
            inv = torch.where(l <= 0.0, torch.ones_like(l), 1.0 / l)
            out[heads, r0:r0 + block] = (acc * inv * ops.vscale[g]).to(ops.out_dtype)
    return out


def flash_attention_pv8_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    kv_valid: Optional[int] = None,
    block_q: int = 1024,
    block_k: int = 1024,
    heads_per_cell: int = 4,
) -> torch.Tensor:
    """Plain PyTorch K6, q [B, H, Sq, D] x k/v [B, H, Skv, D] -> [B, H, Sq, D].

    Full-int8 attention: q, k and v quantized per head group; per kv block
    of ``_pick_block(Skv, block_k)`` columns, in the log2 domain,

        s    = f32(int32(q8 . k8^T)) * scale_g - 1e9 at columns >= kv_len
        m'   = max(m, ceil(rowmax s)),  m starting at -1e9
        p8   = rint(127 * exp2(s - m'))
        acc  = acc * exp2(m - m') + f32(int32(p8 . v8))
        l    = l * exp2(m - m') + 127 * sum p8
        out  = acc / l * vmax_g   (a zero l divides by 1)"""
    b, h, sq, _ = q.shape
    ops = _fixed_max_operands(
        q, k, v, sm_scale=sm_scale, kv_valid=kv_valid,
        heads_per_cell=heads_per_cell, noshift=False, qk_int8=True,
        pv_int8=True, score_bound=None, unnormalized=False)
    return _finish_heads(_pv8_loop(ops, block_q, block_k), b, h, sq)


def _pv8_v_layout(v8: torch.Tensor) -> torch.Tensor:
    """[BH, Skv, D] int8 (Skv a multiple of 32) -> [BH, D, Skv]: v8
    transposed so each output column's kv values are contiguous (the B
    operand of the int8 PV mma), with the kv order permuted inside every
    32-column chunk to the order in which K6's threads hold p8 (the s32
    accumulator layout of QK^T): logical k = 16 a + 4 t + j takes column
    16 a + 8 (j // 2) + 2 t + j % 2. The sum over k is unchanged."""
    kk = torch.arange(32)
    perm = (kk // 16) * 16 + ((kk % 4) // 2) * 8 + ((kk % 16) // 4) * 2 + kk % 2
    idx = (torch.arange(0, v8.shape[1], 32)[:, None] + perm[None, :]).reshape(-1)
    return v8.index_select(1, idx.to(v8.device)).transpose(1, 2).contiguous()


def _pv8_operands(q, k, v, *, sm_scale, kv_valid, block_k, heads_per_cell,
                  width: Optional[int] = None):
    """K6's prepared operands, as the wrapper hands them to the kernel:
    (q8 [BH, Sq_pad, D], k8 [BH, Skv_pad, D], v8 in ``_pv8_v_layout``,
    the prepared operands with their scales, span); ``width``: D is it, the
    codes zero past the head dim (:func:`_fixed_max_operands`)."""
    ops = _fixed_max_operands(q, k, v, sm_scale=sm_scale, kv_valid=kv_valid,
                              heads_per_cell=heads_per_cell, noshift=False,
                              qk_int8=True, pv_int8=True, score_bound=None,
                              unnormalized=False, width=width)
    skv = k.shape[2]
    span = _pick_block(skv, block_k)
    sq_pad = -(-q.shape[2] // _FIXED_TILE) * _FIXED_TILE
    skv_pad = -(-skv // span) * span
    return (_pad_rows(ops.q, sq_pad), _pad_rows(ops.k, skv_pad),
            _pv8_v_layout(_pad_rows(ops.v, skv_pad)), ops, span)


def _pv8_launch(qp, kp, vt, ops: _FixedMaxOperands, span: int, out) -> None:
    """The K6 kernel (``csrc/flash_pv8.cu``, any width, 16 to 128 in
    steps of 16) alone, uncounted, on :func:`_pv8_operands`' result; out [BH, Sq_pad, D]
    f32 or bf16."""
    rc = _build.lib().aether_flash_pv8(
        qp.data_ptr(), kp.data_ptr(), vt.data_ptr(), ops.scale.data_ptr(),
        ops.vscale.data_ptr(), out.data_ptr(), qp.shape[0], qp.shape[1], kp.shape[1],
        ops.kv_len, ops.hper, span, _PV8_DTYPES[out.dtype], qp.shape[2],
        _build.stream_ptr(qp.device))
    _build.check(rc, "aether_flash_pv8")


_PV8_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # K6's C argument


def flash_attention_pv8_hd(qp, kp, vt, ops: _FixedMaxOperands, span: int, out) -> None:
    """K6 at a head dim other than 64: :func:`_pv8_launch`, counted here.
    ``.launches`` counts its launches."""
    _pv8_launch(qp, kp, vt, ops, span, out)
    _build.count_launch(flash_attention_pv8_hd)


flash_attention_pv8_hd.launches = 0


def flash_attention_pv8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    kv_valid: Optional[int] = None,
    block_q: int = 1024,
    block_k: int = 1024,
    heads_per_cell: int = 4,
) -> torch.Tensor:
    """K6: full-int8 attention with an integer running max; the arguments of
    :func:`flash_attention_pv8_plain`.

    A CPU tensor runs :func:`flash_attention_pv8_plain`. A CUDA tensor (f32
    or bf16 q/k/v, a head dim below 128; :func:`_pv8_operands` at its
    instance's width) launches ``csrc/flash_pv8.cu``, counted here at
    head_dim 64 and on
    :func:`flash_attention_pv8_hd` at the others, moving the running max once
    per ``_pick_block(Skv, block_k)`` columns as the plain version does, or
    raises."""
    opts = dict(sm_scale=sm_scale, kv_valid=kv_valid, heads_per_cell=heads_per_cell)
    if not q.is_cuda:
        return flash_attention_pv8_plain(q, k, v, block_q=block_q,
                                         block_k=block_k, **opts)
    width = _check_fixed_max_inputs("K6", q, k, v, (torch.float32, torch.bfloat16))
    b, h, sq, dim = q.shape
    qp, kp, vt, ops, span = _pv8_operands(q, k, v, block_k=block_k, width=width, **opts)
    out = torch.empty((b * h, qp.shape[1], width), dtype=q.dtype, device=q.device)
    if dim != 64:
        flash_attention_pv8_hd(qp, kp, vt, ops, span, out)
    else:
        _pv8_launch(qp, kp, vt, ops, span, out)
        _build.count_launch(flash_attention_pv8)
    return _finish_heads(out[..., :dim], b, h, sq)


# wrapper calls that launched the Hopper kernel at head_dim 64 (a plain integer)
flash_attention_pv8.launches = 0


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
    noshift: Optional[bool] = False,
    kv_valid: Optional[int] = None,
    qk_int8: bool = False,
    pv_int8: bool = False,
    score_bound=None,
    unnormalized: bool = False,
):
    """Non-causal attention, q [B, H, Sq, D] x k/v [B, H, Skv, D] -> [B, H, Sq, D];
    the JAX ``flash_attention`` with its argument rules.

    ``fixed_max=False`` runs K4 (online softmax); ``fixed_max=True`` runs K3
    (:func:`flash_attention_fixed_max`), or K6 (:func:`flash_attention_pv8`)
    with ``pv_int8``. ``kv_valid`` treats only the first ``kv_valid`` k/v
    rows as real (the tail is zeroed and masked); ``block_q``, ``block_k``
    and ``heads_per_cell`` shape the plain versions' loops and K6's running
    max. At head_dim >= 128 the JAX wrapper turns ``fixed_max``, ``qk_int8``
    and ``pv_int8`` off and takes the "vpu" denominator; so does this one.
    ``unnormalized`` returns ``(o, l)`` (see :func:`flash_attention_fixed_max`).

    A CPU tensor runs the plain versions. A CUDA tensor launches a Hopper
    kernel or raises; there is no fallback: K4 in bf16 launches
    ``csrc/flash_online_bf16.cu`` at every head dim up to 256 and
    ``csrc/flash_online_wide_bf16.cu`` above, in f32 ``csrc/flash_online.cu``
    (the 3xTF32 cell) up to 256 and ``csrc/flash_online_wide.cu`` above, on
    :func:`_tf32_operands` (``flash_attention.launches`` counts either at
    64); at the other head dims the launches count on
    :func:`flash_attention_hd` (bf16) or :func:`flash_attention_f32_hd` (f32).
    Both take :func:`_online_kernel_operands`: a head dim between two widths
    runs the next width's instance (above 256: the next multiple of 64) on
    zero-padded q, k and v, the fold and the denominator of the true head
    dim. Every head dim from 1 up runs, as in the JAX wrapper.
    """
    if qk_int8 and not fixed_max:
        raise ValueError("qk_int8 requires fixed_max=True (the int8 "
                         "dequantization rides the fixed-max scalar prefetch)")
    if pv_int8 and not fixed_max:
        raise ValueError("pv_int8 requires fixed_max=True (it shares the "
                         "fixed-max family's scalar-prefetch scaffold)")
    if pv_int8 and not qk_int8:
        raise ValueError("pv_int8 requires qk_int8=True (the mixed "
                         "bf16-QK/int8-PV cell crashes the TPU compiler)")
    if (score_bound is not None or unnormalized) and (not fixed_max or pv_int8):
        raise ValueError("score_bound / unnormalized are fixed-max-family "
                         "options (the ring/sequence-parallel merge relies "
                         "on every stripe sharing one softmax shift; the "
                         "pv_int8 cell re-derives its own integer max)")
    dim = q.shape[-1]
    if dim >= 128:
        if unnormalized:
            raise ValueError("unnormalized (ring merge) needs the mxu "
                             "ones-column denominator, unavailable at "
                             "head_dim >= 128")
        denom, fixed_max, qk_int8, pv_int8 = "vpu", False, False, False
    if fixed_max and pv_int8:
        return flash_attention_pv8(q, k, v, sm_scale=sm_scale, kv_valid=kv_valid,
                                   block_q=block_q, block_k=block_k,
                                   heads_per_cell=heads_per_cell)
    if fixed_max:
        return flash_attention_fixed_max(
            q, k, v, sm_scale=sm_scale, kv_valid=kv_valid, block_q=block_q,
            heads_per_cell=heads_per_cell, noshift=noshift, qk_int8=qk_int8,
            score_bound=score_bound, unnormalized=unnormalized)
    if denom not in ("mxu", "vpu"):
        raise ValueError(f"denom must be 'mxu' or 'vpu', got {denom!r}")
    if not q.is_cuda:
        return flash_attention_plain(
            q, k, v, sm_scale=sm_scale, kv_valid=kv_valid, block_k=block_k,
            denom=denom, block_q=block_q, heads_per_cell=heads_per_cell)
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    width = _check_head_dim("K4", dim)
    if (q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"K4 takes f32 or bf16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, h, skv, dim) or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does not "
                             f"match ({b}, {h}, {skv}, {dim}) on {q.device}")
    qh, kh, vh, kv_len, fold = _online_kernel_operands(q, k, v, sm_scale, kv_valid)
    out = torch.empty((b * h, sq, width), dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        # the fold happens in the kernel; TMA reads rows past the ends as zeros
        if dim != 64:
            flash_attention_hd(qh, kh, vh, out, kv_len, denom == "mxu", fold)
        else:
            _online_bf16_launch(qh, kh, vh, out, kv_len, denom == "mxu", fold)
            _build.count_launch(flash_attention)
    else:
        # f32: q folded as the JAX wrapper folds it, then split for the
        # 3xTF32 cell; TMA reads rows past the ends as zeros
        split = _tf32_operands((qh * fold).to(qh.dtype), kh, vh)
        if dim != 64:
            flash_attention_f32_hd(split, out, kv_len)
        else:
            _online_f32_launch(split, out, kv_len)
            _build.count_launch(flash_attention)
    return out[..., :dim].reshape(b, h, sq, dim)


# wrapper calls that launched the Hopper kernel at head_dim 64 (a plain integer)
flash_attention.launches = 0


# ---------------------------------------------------------------------------
# ring attention: the sequence-parallel merge of K3 calls
# ---------------------------------------------------------------------------


def _row_norm_max(x: torch.Tensor) -> torch.Tensor:
    """sqrt of the largest squared row norm of x, over every row (f32)."""
    return x.float().square().sum(dim=-1).amax().sqrt()


def ring_step(q, k, v, bound, *, sm_scale=None, qk_int8: bool = False,
              heads_per_cell: int = 4):
    """One stripe of the ring: K3 over q against one K/V stripe, unnormalized,
    shifted by the shared ``bound``. Returns (o, l): the numerator in q's
    dtype and the f32 denominator [B, H, Sq, 1]."""
    return flash_attention(q, k, v, sm_scale=sm_scale, fixed_max=True, noshift=False,
                           qk_int8=qk_int8, score_bound=bound, unnormalized=True,
                           heads_per_cell=heads_per_cell)


def ring_finish(num: torch.Tensor, den: torch.Tensor, bound, n_pad: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Normalize the merged stripes: the exact pad correction ``den -= n_pad *
    2^-bound`` (each zero k row scored 0 and added 2^-bound to every
    denominator; its zero v row added nothing), a denominator <= 0 divides by
    1, the quotient in ``dtype``."""
    if n_pad:
        den = den - n_pad * torch.exp2(-torch.as_tensor(bound, dtype=torch.float32,
                                                       device=den.device))
    den = torch.where(den <= 0.0, torch.ones_like(den), den)
    return (num / den).to(dtype)


def ring_rotate(k: torch.Tensor, v: torch.Tensor, group):
    """One hop of the ring: send k and v to the previous rank of ``group``,
    receive the next rank's (JAX's ``ppermute`` with perm j -> j - 1), through
    one ``batch_isend_irecv``."""
    import torch.distributed as dist

    n, me = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (me - 1) % n)
    src = dist.get_global_rank(group, (me + 1) % n)
    k, v = k.contiguous(), v.contiguous()
    k_next, v_next = torch.empty_like(k), torch.empty_like(v)
    ops = [dist.P2POp(dist.isend, k, dst, group),
           dist.P2POp(dist.isend, v, dst, group),
           dist.P2POp(dist.irecv, k_next, src, group),
           dist.P2POp(dist.irecv, v_next, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return k_next, v_next


def ring_attention(q, k, v, group, *, n_pad: int = 0, sm_scale=None,
                   qk_int8: bool = False, heads_per_cell: int = 4) -> torch.Tensor:
    """Ring (sequence-parallel) attention over the ranks of ``group``.

    Port of ``aether_tpu/ops/flash_attention.py::ring_attention``. q/k/v
    [B, H, S/n, D] are this rank's token stripe of a sequence striped over
    the n ranks (the padded sequence's ``n_pad`` zero rows lie in the last
    stripe). One shared Cauchy-Schwarz bound (the local q row-norm max times
    the k row-norm max over the group, one ``all_reduce(MAX)``; log2 domain)
    shifts every stripe's K3 call alike, so the stripes' numerators and
    denominators add in f32 with no rescaling. K/V rotate one hop a step
    (:func:`ring_rotate`). Then :func:`ring_finish`. ``qk_int8`` quantizes
    each stripe by itself."""
    import torch.distributed as dist

    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    nk = _row_norm_max(k)
    dist.all_reduce(nk, op=dist.ReduceOp.MAX, group=group)
    bound = _row_norm_max(q) * nk * (sm_scale * _LOG2E)
    n = dist.get_world_size(group)
    num = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    den = torch.zeros((*q.shape[:3], 1), dtype=torch.float32, device=q.device)
    for step in range(n):
        o, l = ring_step(q, k, v, bound, sm_scale=sm_scale, qk_int8=qk_int8,
                         heads_per_cell=heads_per_cell)
        num, den = num + o.float(), den + l
        if step != n - 1:
            k, v = ring_rotate(k, v, group)
    return ring_finish(num, den, bound, n_pad, q.dtype)


def ring_attention_stripes(qs, ks, vs, *, n_pad: int = 0, sm_scale=None,
                           qk_int8: bool = False, heads_per_cell: int = 4):
    """The ring's arithmetic in one process, with no process group: the
    stripes ``qs`` / ``ks`` / ``vs`` of one sequence (lists, in order) go
    through :func:`ring_step` and the merge exactly as the ranks of
    :func:`ring_attention` would run them (stripe i meets the K/V stripes i,
    i + 1, ... in that order). Returns the output stripes."""
    if sm_scale is None:
        sm_scale = 1.0 / (qs[0].shape[-1] ** 0.5)
    n = len(qs)
    nk = torch.stack([_row_norm_max(k) for k in ks]).amax()
    outs = []
    for i, q in enumerate(qs):
        bound = _row_norm_max(q) * nk * (sm_scale * _LOG2E)
        num = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        den = torch.zeros((*q.shape[:3], 1), dtype=torch.float32, device=q.device)
        for step in range(n):
            j = (i + step) % n
            o, l = ring_step(q, ks[j], vs[j], bound, sm_scale=sm_scale, qk_int8=qk_int8,
                             heads_per_cell=heads_per_cell)
            num, den = num + o.float(), den + l
        outs.append(ring_finish(num, den, bound, n_pad, q.dtype))
    return outs

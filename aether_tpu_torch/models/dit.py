"""CogVideoX-class diffusion transformer (DiT) as a PyTorch ``nn.Module``.

Port of ``aether_tpu/models/dit.py``. Structure per block (joint text+video
stream, text first): adaLN-Zero -> joint self-attention with per-head QK
LayerNorm and 3D RoPE on video tokens -> gated residual -> adaLN-Zero -> 4x
GELU(tanh) MLP -> gated residual. The 42 blocks are a Python loop over a
``ModuleList``; ``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``).

Attention takes one of two paths, as in the JAX module:
- the default inference path (``attn_impl="flash"`` with the fixed max on):
  the fused QKV projection, the attention prologue (kernel K1) and the
  prepacked fixed-max flash attention (kernel K2);
- the unfused path (``_attention``'s general branch): q/k/v from the fused
  projection, per-head QK LayerNorm, RoPE, then ``attn_impl`` picks the
  attention: "flash" (kernel K4, when the fixed max is off), "flash_train"
  (K4 forward, blockwise backward), "chunked" or "xla" (plain PyTorch).

Over a device mesh (``parallel.shard_params``) the same forward runs the
JAX module's mesh branches (``dit.py:552-825``) in PyTorch's SPMD idiom: a
block at tp > 1 does two all-reduces, after ``attn.o`` and after
``mlp.w2`` (under w8a8 each is preceded by an all-reduce of the per-token
activation maximum, [B, S, 1]); under sp each attention gathers K/V over sp
(two all-gathers) or runs the ring. Training over a mesh needs those
collectives to carry gradients (``parallel/mesh.py``), and pipeline
parallelism replaces the block loop with an executor
(``DiT.forward(block_scan=...)``, ``parallel/pipeline.py``).

Numerics follow the JAX module: LayerNorm is the shifted single-pass form in
f32; adaLN modulation, gates and GELU run in f32 and round to the compute
dtype; linear layers return the input dtype.

Weights use PyTorch's ``[out, in]`` layout; ``io/from_jax.py`` converts the JAX
parameter tree, and :func:`init_dit` draws seeded random weights on a device
with the JAX init's distributions.

Weight formats (``_linear`` / ``_linear_w8a8`` / ``quantize_dit_params`` /
``init_quantized_dit_params`` of the JAX module): :func:`quantize_dit` turns
every :class:`Linear` into a :class:`QuantLinear` (fp8 e4m3 or int8 codes with
per-output scales), and :func:`init_quantized_dit` draws that layout directly.
``DiT.forward(act_quant=True)`` quantizes the activations of the qkv, o, w1 and
w2 products to int8 per token where the codes are int8 (w8a8, through
:func:`int8_mm`); every other linear, and fp8 codes, stay weight-only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from aether_tpu_torch.config import DiTConfig
from aether_tpu_torch.ops import _build
from aether_tpu_torch.ops.attn_prologue import _pick_pad_and_block, fused_joint_attention
from aether_tpu_torch.ops.chunked_attention import (
    chunked_attention,
    flash_attention_trainable,
)
from aether_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
    ring_attention,
)
from aether_tpu_torch.utils.env import env_flag

ATTN_IMPLS = ("flash", "flash_train", "chunked", "xla")


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal embedding, [B] -> [B, dim] (f32)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def layer_norm(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last axis in f32 with single-pass moments shifted by
    the row's first element (the JAX formulation); returns x's dtype."""
    dtype = x.dtype
    x = x.float()
    y0 = x - x[..., :1]
    mean_y = y0.mean(dim=-1, keepdim=True)
    var = torch.clamp((y0 * y0).mean(dim=-1, keepdim=True) - mean_y * mean_y,
                      min=0.0)
    y = (y0 - mean_y) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


class Linear(nn.Module):
    """``y = x W^T + b`` in x's dtype (PyTorch weight layout [out, in]).
    ``a8`` asks for int8 activations, which only int8 codes take
    (:class:`QuantLinear`); a float weight ignores it, as JAX's ``_linear``
    does."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out))

    def forward(self, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


QUANT_DTYPES = (torch.float8_e4m3fn, torch.int8)


def int8_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_mm`: the exact int32 sums, taken through
    a float64 product (every partial sum is an integer of magnitude at most
    127**2 * k < 2**53, so float64 holds it exactly on any device)."""
    return (a.double() @ b.double()).to(torch.int32)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 ``a @ b`` of int8 ``a`` [m, k] (row-major) and int8 ``b`` [k, n].

    The w8a8 product of the JAX ``_linear_w8a8`` (``lax.dot_general`` with an
    int32 result). A CPU tensor takes :func:`int8_mm_plain`. A CUDA tensor runs
    ``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM), which needs m > 16
    and k, n multiples of 8, and is fast with ``b`` column-major (the ``.t()``
    of a row-major [n, k] code matrix); any other shape raises, never a float
    product."""
    if not a.is_cuda:
        return int8_mm_plain(a, b)
    m, k = a.shape
    n = b.shape[1]
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_mm takes int8 operands, got {a.dtype} and {b.dtype}")
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"torch._int_mm needs m > 16 and k, n multiples of 8; got "
                         f"m={m}, k={k}, n={n}")
    out = torch._int_mm(a, b)
    _build.count_launch(int8_mm)
    return out


# int8_mm calls that launched torch._int_mm (a plain integer)
int8_mm.launches = 0


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 codes of x and their f32 scales (JAX ``_linear_w8a8``):
    ``sx = max(max|x| over the last axis, 1e-6) / 127``, ``xq = clamp(round(x
    / sx), -127, 127)``, all in f32 (round half to even, as ``jnp.round``)."""
    xf = x.float()
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python scalar,
    # which is not the correctly rounded quotient the JAX function takes
    sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / xf.new_tensor(127.0)
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def _product_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` of x and the codes ``w`` cast to x's dtype, accumulated and
    returned in f32 (JAX ``jnp.dot(..., preferred_element_type=f32)``). On
    CUDA a bf16/f16 x runs ``torch.mm(..., out_dtype=float32)``; elsewhere the
    operands go up to f32, whose products of bf16 values are exact."""
    w = w.to(x.dtype)
    if x.is_cuda and x.dtype != torch.float32:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return torch.matmul(x.float(), w.float().t())


class QuantLinear(nn.Module):
    """A weight-quantized :class:`Linear`: codes ``q`` [out, in] (fp8 e4m3 or
    int8) and per-output scales ``s`` (f32, (out,)) held as buffers, W =
    q * s[:, None]. The counterpart of a ``{"q", "s"}`` leaf of the JAX tree.

    Weight-only (JAX ``_linear``'s dict branch): ``(x @ q.T)`` in f32, then
    ``* s``, ``+ b``, cast to x's dtype. With ``a8`` and int8 codes (JAX
    ``_linear_w8a8``): x is quantized per token, ``sx = max(absmax, 1e-6) /
    127``, ``xq = clamp(round(x / sx), -127, 127)``; the int32 product
    :func:`int8_mm`, then ``(y * sx) * s + b``. fp8 codes under ``a8`` take the
    weight-only branch, as in the JAX module."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        if q.dtype not in QUANT_DTYPES:
            raise TypeError(f"codes must be one of {QUANT_DTYPES}, got {q.dtype}")
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.bias = bias if isinstance(bias, nn.Parameter) else nn.Parameter(bias)

    def forward(self, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
        if a8 and self.q.dtype == torch.int8:
            xq, sx = quantize_activations(x)
            y = int8_mm(xq.reshape(-1, xq.shape[-1]), self.q.t())
            y = y.reshape(*x.shape[:-1], -1).float() * sx * self.s
        else:
            y = _product_f32(x, self.q) * self.s
        return (y + self.bias.float()).to(x.dtype)


class AdaLayerNormZero(nn.Module):
    """CogVideoXLayerNormZero: LN + per-stream shift/scale; returns gates too."""

    def __init__(self, te: int, d: int):
        super().__init__()
        self.linear = Linear(te, 6 * d)
        self.ln_scale = nn.Parameter(torch.empty(d))
        self.ln_bias = nn.Parameter(torch.empty(d))

    def forward(self, x, enc, temb, eps: float):
        ada = self.linear(F.silu(temb.float()).to(temb.dtype)).float()
        shift, scale, gate, e_shift, e_scale, e_gate = ada.chunk(6, dim=-1)
        x_n = layer_norm(x, self.ln_scale, self.ln_bias, eps)
        x_n = (x_n.float() * (1 + scale[:, None]) + shift[:, None]).to(x.dtype)
        e_n = layer_norm(enc, self.ln_scale, self.ln_bias, eps)
        e_n = (e_n.float() * (1 + e_scale[:, None]) + e_shift[:, None]).to(enc.dtype)
        return x_n, e_n, gate[:, None], e_gate[:, None]


def resolve_attention(fixed_max: Optional[bool] = None, qk_int8: Optional[bool] = None,
                      pv_int8: Optional[bool] = None, fused_qkv: Optional[bool] = None):
    """The attention settings as the JAX ``dit_forward`` resolves them
    (``dit.py:982-993``); an argument left None reads its variable.

    ``AETHER_ATTN_FIXED_MAX`` (default on) selects the fixed-max family; off,
    QK8, PV8 and FUSED no longer apply and the DiT runs K4. ``QK8`` (default
    on) gives int8 q/k; ``PV8`` (default off) the full-int8 K6, which implies
    the unfused path and needs QK8; ``FUSED`` (default on) the fused K1 + K2
    path, off the unfused path through K3. Returns (fixed_max, qk_int8,
    pv_int8, fused_qkv)."""
    if fixed_max is None:
        fixed_max = env_flag("AETHER_ATTN_FIXED_MAX", True)
    if qk_int8 is None:
        qk_int8 = env_flag("AETHER_ATTN_QK8", True) and fixed_max
    if pv_int8 is None:
        pv_int8 = env_flag("AETHER_ATTN_PV8", False) and fixed_max
    if fused_qkv is None:
        fused_qkv = env_flag("AETHER_ATTN_FUSED", True) and fixed_max and not pv_int8
    return bool(fixed_max), bool(qk_int8), bool(pv_int8), bool(fused_qkv)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation in f32. x: [B, H, S, D]; cos/sin: [S, D]
    with duplicated pairs (``cos[:, 2i] == cos[:, 2i+1]``); returns x's dtype."""
    xf = x.float().unflatten(-1, (-1, 2))
    e, o = xf[..., 0], xf[..., 1]
    c, s = cos[:, ::2], sin[:, ::2]
    out = torch.stack([e * c - o * s, o * c + e * s], dim=-1)
    return out.flatten(-2).to(x.dtype)


class Attention(nn.Module):
    """Joint attention: fused [q|k|v] projection -> attention -> o-projection.

    ``attn_impl`` "fused" runs K1 + K2 (``qk_int8`` picks their operands);
    the names in ``ATTN_IMPLS`` run the unfused path, where "flash" takes
    ``flash_attention`` with the ``fixed_max`` / ``qk_int8`` / ``pv_int8``
    options: K4, K3 or K6."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.qkv = Linear(d, 3 * d)
        self.o = Linear(d, d)
        self.norm_q_scale = nn.Parameter(torch.empty(cfg.head_dim))
        self.norm_q_bias = nn.Parameter(torch.empty(cfg.head_dim))
        self.norm_k_scale = nn.Parameter(torch.empty(cfg.head_dim))
        self.norm_k_bias = nn.Parameter(torch.empty(cfg.head_dim))
        self.cfg = cfg

    def forward(self, hidden, enc, rope_cos, rope_sin, attn_impl: str, attn_opts: dict,
                a8: bool = False, sp: Optional["SeqStripe"] = None):
        if attn_impl == "fused":
            out = self._fused(hidden, enc, rope_cos, rope_sin, attn_opts["qk_int8"], a8)
        else:
            out = self._unfused(hidden, enc, rope_cos, rope_sin, attn_impl, attn_opts, a8, sp)
        text_len = enc.shape[1]
        return out[:, text_len:], out[:, :text_len]

    def _fused(self, hidden, enc, rope_cos, rope_sin, qk_int8: bool, a8: bool):
        cfg = self.cfg
        s = enc.shape[1] + hidden.shape[1]
        # the token padding to the kernel's tile multiple rides the joint
        # concat, and the qkv matmul runs over the padded rows
        s_pad = _pick_pad_and_block(s, 1024)[0]
        parts = [enc, hidden]
        if s_pad != s:
            parts.append(hidden.new_zeros(hidden.shape[0], s_pad - s, hidden.shape[-1]))
        # [B, S_pad, 3D]; under tp this rank's [q_r | k_r | v_r], its heads
        y = self.qkv(torch.cat(parts, dim=1), a8)
        d = y.shape[-1] // 3
        attn = fused_joint_attention(
            y[..., :d], y[..., d:2 * d], y[..., 2 * d:],
            self.norm_q_scale, self.norm_q_bias,
            self.norm_k_scale, self.norm_k_bias, rope_cos, rope_sin,
            num_heads=d // cfg.head_dim, head_dim=cfg.head_dim, eps=cfg.qk_norm_eps,
            quantize=qk_int8, s_valid=s,
        )
        return self.o(attn[:, :s], a8)

    def _unfused(self, hidden, enc, rope_cos, rope_sin, attn_impl: str, attn_opts: dict,
                 a8: bool, sp: Optional["SeqStripe"] = None):
        cfg = self.cfg
        hd = cfg.head_dim
        x = torch.cat([enc, hidden], dim=1)  # text first
        b, s, _ = x.shape
        # under tp the fused projection holds this rank's heads only
        q, k, v = self.qkv(x, a8).chunk(3, dim=-1)
        nh = q.shape[-1] // hd

        def heads(t):
            return t.reshape(b, s, nh, hd).transpose(1, 2)

        q = layer_norm(heads(q), self.norm_q_scale, self.norm_q_bias, cfg.qk_norm_eps)
        k = layer_norm(heads(k), self.norm_k_scale, self.norm_k_bias, cfg.qk_norm_eps)
        v = heads(v)
        if rope_cos is not None:
            q = apply_rotary_emb(q, rope_cos, rope_sin)
            k = apply_rotary_emb(k, rope_cos, rope_sin)
        if sp is None:
            attn = _attend(q, k, v, attn_impl, attn_opts)
        else:
            attn = sp.attend(q, k, v, attn_impl, attn_opts)
        return self.o(attn.transpose(1, 2).reshape(b, s, nh * hd), a8)


def _attend(q, k, v, attn_impl: str, attn_opts: dict, kv_valid: Optional[int] = None):
    """The unfused path's attention by ``attn_impl``; ``kv_valid`` (the flash
    kernels only) treats the first ``kv_valid`` k/v rows as real."""
    if attn_impl == "flash":
        if kv_valid is not None:
            attn_opts = dict(attn_opts, kv_valid=kv_valid)
        return flash_attention(q, k, v, **attn_opts)
    if attn_impl == "flash_train":
        return flash_attention_trainable(q, k, v)
    if attn_impl == "chunked":
        return chunked_attention(q, k, v)
    if attn_impl == "xla":
        return attention_reference(q, k, v)
    raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``t`` of every rank of ``group`` concatenated along ``dim`` in rank
    order. It carries no gradient: where the ranks hold different gradients
    of the result (the sp K/V gather, dp's output gather) the transpose is a
    reduce-scatter, which no training path needs, so a ``t`` that needs a
    gradient raises. The tp patch embedding's differentiable gather is
    ``parallel.mesh.gather_from_tp``."""
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError("all_gather_cat carries no gradient: run an sp or dp mesh's "
                           "forward under torch.no_grad() (training splits tp, FSDP's "
                           "dp and pp)")
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


@dataclasses.dataclass(frozen=True)
class SeqStripe:
    """This rank's stripe of the joint token stream under an sp mesh
    (JAX ``_sp_token_constraint`` / ``_sharded_flash_attention``): the
    ``seq`` tokens, text first, padded to ``seq_pad`` (an sp multiple) and
    cut into ``size`` equal stripes; this rank holds stripe ``rank``.

    Every token-wise op runs on the stripe alone. The attention zeroes the
    stripe's pad rows (as JAX pads q/k/v with zeros) and then either
    gathers K/V over sp, the kernel masking the pad rows through
    ``kv_valid`` (the default), or, with ``ring`` (``AETHER_SP_RING=1``),
    where the fixed max is on and ``pv_int8`` off as at JAX ``:713``, runs
    :func:`ring_attention`."""

    group: object
    size: int
    rank: int
    seq: int
    seq_pad: int
    ring: bool

    @property
    def rows(self) -> int:
        return self.seq_pad // self.size

    @property
    def start(self) -> int:
        return self.rank * self.rows

    def attend(self, q, k, v, attn_impl: str, attn_opts: dict):
        """q/k/v [B, H, rows, D] of this stripe -> its attention output."""
        if self.seq_pad != self.seq:
            pos = torch.arange(self.start, self.start + self.rows, device=q.device)
            pad = (pos >= self.seq)[:, None]
            q, k, v = (t.masked_fill(pad, 0) for t in (q, k, v))
        if (self.ring and attn_impl == "flash" and attn_opts["fixed_max"]
                and not attn_opts["pv_int8"]):
            return ring_attention(q, k, v, self.group, n_pad=self.seq_pad - self.seq,
                                  qk_int8=attn_opts["qk_int8"])
        k = all_gather_cat(k, 2, self.group)
        v = all_gather_cat(v, 2, self.group)
        if attn_impl == "flash":
            kv_valid = self.seq if self.seq_pad != self.seq else None
            return _attend(q, k, v, attn_impl, attn_opts, kv_valid)
        return _attend(q, k[:, :, :self.seq], v[:, :, :self.seq], attn_impl, attn_opts)


def fused_mesh_ok(mesh, num_heads: int, batch: int) -> bool:
    """JAX ``_fused_mesh_ok``: a mesh where neither tp (heads divisible) nor
    dp (batch divisible) shards the attention takes the unfused path rather
    than the fused chain unsharded."""
    from aether_tpu_torch.parallel.mesh import axis_size

    tp, dp = axis_size(mesh, "tp"), axis_size(mesh, "dp")
    if tp <= 1 and dp <= 1:
        return True
    return (tp > 1 and num_heads % tp == 0) or (dp > 1 and batch % dp == 0)


class MLP(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.w1 = Linear(cfg.hidden_size, cfg.mlp_dim)
        self.w2 = Linear(cfg.mlp_dim, cfg.hidden_size)

    def forward(self, x, a8: bool = False):
        h = self.w1(x, a8)
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
        return self.w2(h, a8)


class Block(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.norm1 = AdaLayerNormZero(cfg.time_embed_dim, cfg.hidden_size)
        self.attn = Attention(cfg)
        self.norm2 = AdaLayerNormZero(cfg.time_embed_dim, cfg.hidden_size)
        self.mlp = MLP(cfg)
        self.eps = cfg.norm_eps

    def forward(self, hid, enc, temb, rope_cos, rope_sin, attn_impl: str,
                attn_opts: dict, act_quant: bool = False, sp: Optional[SeqStripe] = None):
        h_n, e_n, gate, e_gate = self.norm1(hid, enc, temb, self.eps)
        attn_h, attn_e = self.attn(h_n, e_n, rope_cos, rope_sin, attn_impl, attn_opts,
                                   act_quant, sp)
        hid = hid + (gate * attn_h.float()).to(hid.dtype)
        enc = enc + (e_gate * attn_e.float()).to(enc.dtype)

        h_n, e_n, gate, e_gate = self.norm2(hid, enc, temb, self.eps)
        ff = self.mlp(torch.cat([e_n, h_n], dim=1), act_quant)
        text_len = enc.shape[1]
        hid = hid + (gate * ff[:, text_len:].float()).to(hid.dtype)
        enc = enc + (e_gate * ff[:, :text_len].float()).to(enc.dtype)
        return hid, enc


class TimeEmbedding(nn.Module):
    def __init__(self, d_in: int, te: int):
        super().__init__()
        self.w1 = Linear(d_in, te)
        self.w2 = Linear(te, te)

    def forward(self, emb):
        return self.w2(F.silu(self.w1(emb).float()).to(emb.dtype))


class DiT(nn.Module):
    """The denoiser. ``forward`` mirrors ``aether_tpu.models.dit.dit_forward``:
    the fused prologue path by default, the unfused one at the other
    ``attn_impl`` values, with the fixed max off, under ``fused_qkv=False``
    (AETHER_ATTN_FUSED=0) or with ``pv_int8``.

    Over a mesh (``self.mesh``, set by ``parallel.shard_params``, one process
    per card): tp runs this rank's heads and MLP columns, the split layers
    summing over tp; dp runs this rank's rows of a batch that dp divides (the
    CFG pair) and gathers the outputs; sp stripes the joint token stream
    (:class:`SeqStripe`, which takes the unfused path) and gathers the video
    rows of the output head. A mesh where neither tp nor dp shards the
    attention takes the unfused path (:func:`fused_mesh_ok`).

    CogVideoX 1.5 (``cfg.patch_size_t`` and ``cfg.ofs_embed_dim``, JAX
    ``dit.py:888-930`` and ``:1003-1016``): ``patch_size_t`` latent frames
    fold into each patch, so ``proj`` takes and ``proj_out`` gives
    ``patch_size_t * p * p`` times the channels and the frame count must be
    a multiple of it; the ``ofs`` embedding (``ofs_embed``, a second
    sinusoid + MLP) is added to the time embedding."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        # CogVideoX-1.5 (patch_size_t set) folds pt frames into each patch
        patch = (cfg.patch_size_t or 1) * p * p
        self.cfg = cfg
        self.proj = Linear(cfg.in_channels * patch, d)
        self.text_proj = Linear(cfg.text_embed_dim, d)
        self.time_embed = TimeEmbedding(d, cfg.time_embed_dim)
        if cfg.ofs_embed_dim is not None:
            od = cfg.ofs_embed_dim
            if od != cfg.time_embed_dim:
                raise ValueError("ofs embedding is added to temb: dims must match "
                                 f"(ofs_embed_dim {od}, time_embed_dim {cfg.time_embed_dim})")
            self.ofs_embed = TimeEmbedding(od, od)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.norm_final_scale = nn.Parameter(torch.empty(d))
        self.norm_final_bias = nn.Parameter(torch.empty(d))
        self.norm_out = Linear(cfg.time_embed_dim, 2 * d)
        self.norm_out_ln_scale = nn.Parameter(torch.empty(d))
        self.norm_out_ln_bias = nn.Parameter(torch.empty(d))
        self.proj_out = Linear(d, patch * cfg.out_channels)
        # the device mesh of ``parallel.shard_params``; None runs on one card
        self.mesh = None

    def _frames_per_patch(self, f: int) -> int:
        """``patch_size_t`` (1 when unset); raises where it does not divide
        the ``f`` latent frames (JAX's reshape fails there)."""
        pt = self.cfg.patch_size_t or 1
        if f % pt:
            raise ValueError(f"{f} latent frames are not a multiple of patch_size_t {pt}: "
                             "pad the latent clip")
        return pt

    def _patch_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """[B, F, C, H, W] -> [B, (F/pt)*(H/p)*(W/p), C*pt*p*p], the input of
        ``self.proj`` (JAX ``_patchify``): token features ordered (c, ph, pw)
        like a torch Conv2d(k=p, s=p), or under ``patch_size_t`` (c, pt, ph,
        pw), diffusers' CogVideoX-1.5 patch embedding."""
        b, f, c, h, w = x.shape
        p, pt = self.cfg.patch_size, self._frames_per_patch(f)
        x = x.reshape(b, f // pt, pt, c, h // p, p, w // p, p).permute(0, 1, 4, 6, 3, 2, 5, 7)
        return x.reshape(b, (f // pt) * (h // p) * (w // p), c * pt * p * p)

    def _axes(self):
        """(dp, tp, sp) sizes of ``self.mesh``; all 1 without one."""
        if self.mesh is None:
            return 1, 1, 1
        from aether_tpu_torch.parallel.mesh import axis_size

        return tuple(axis_size(self.mesh, name) for name in ("dp", "tp", "sp"))

    def _unpatchify(self, tokens, f: int, hp: int, wp: int) -> torch.Tensor:
        """The output head's [B, T, (pt*)p*p*C_out] tokens -> [B, F, C_out,
        hp*p, wp*p], the inverse of :meth:`_patch_tokens`' layout."""
        b = tokens.shape[0]
        p, c, pt = self.cfg.patch_size, self.cfg.out_channels, self._frames_per_patch(f)
        x = tokens.reshape(b, f // pt, hp, wp, c, pt, p, p).permute(0, 1, 5, 4, 2, 6, 3, 7)
        return x.reshape(b, f, c, hp * p, wp * p)

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        timestep: torch.Tensor,
        rope_cos: Optional[torch.Tensor] = None,
        rope_sin: Optional[torch.Tensor] = None,
        qk_int8: Optional[bool] = None,
        collect_blocks: bool = False,
        attn_impl: str = "flash",
        remat: bool = False,
        fixed_max: Optional[bool] = None,
        pv_int8: Optional[bool] = None,
        fused_qkv: Optional[bool] = None,
        act_quant: bool = False,
        block_scan=None,
        ofs: Optional[torch.Tensor] = None,
    ):
        """Denoiser forward.

        Args:
            hidden_states: [B, F, C_in, H_lat, W_lat] noisy + condition latents.
            encoder_hidden_states: [B, S_text, text_embed_dim].
            timestep: [B] diffusion timesteps.
            rope_cos / rope_sin: (S_video, head_dim) tables or None.
            qk_int8: int8 q/k in the fixed-max kernels; None reads
                AETHER_ATTN_QK8 (:func:`resolve_attention` resolves the
                four settings).
            collect_blocks: also return every block's (video, text) output.
            attn_impl: one of ``ATTN_IMPLS``. "flash" with the fixed max on
                is the fused K1 + K2 path, or under ``fused_qkv=False`` or
                ``pv_int8`` the unfused path through K3 / K6; the other
                names are unfused.
            remat: recompute each block in the backward
                (``torch.utils.checkpoint``, non-reentrant).
            fixed_max: the fixed-max attention; None reads
                AETHER_ATTN_FIXED_MAX.
            pv_int8: the full-int8 attention K6; None reads AETHER_ATTN_PV8.
            fused_qkv: the fused K1 + K2 path; None reads AETHER_ATTN_FUSED
                (off when ``pv_int8`` is on, as in the JAX package).
            act_quant: int8 activations (w8a8) in the qkv, o, w1 and w2
                products where their codes are int8 (JAX ``act_quant``).
            block_scan: an executor of the block stack in place of the loop,
                ``block_scan(body, (video, text), self.blocks, temb) ->
                (video, text)`` with ``body(carry, block, temb) -> carry``
                (JAX ``dit_forward(block_scan=...)``; the GPipe schedule of
                ``parallel.pipeline.make_pipeline_block_scan``).
            ofs: [B] (or [1]) CogVideoX-1.5 ofs values where the config has
                ``ofs_embed_dim``: their embedding is added to the time
                embedding; None gives zeros (JAX ``dit_forward(ofs=...)``).
        Returns:
            [B, F, C_out, H_lat, W_lat] v-prediction (and the block outputs).
        """
        cfg = self.cfg
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        fixed_max, qk_int8, pv_int8, fused_qkv = resolve_attention(
            fixed_max, qk_int8, pv_int8, fused_qkv)
        b, f, _, h, w = hidden_states.shape
        dp, _, sp = self._axes()
        # the fused path needs an even head_dim below 128 (at 128 and above
        # the unfused wrapper takes K4 "vpu"), whole sequences (sp 1) and a
        # mesh that shards it (JAX dit.py:819-825)
        if (attn_impl == "flash" and fused_qkv and fixed_max and not pv_int8
                and cfg.head_dim < 128 and cfg.head_dim % 2 == 0 and sp <= 1
                and fused_mesh_ok(self.mesh, cfg.num_heads, b)):
            attn_impl = "fused"
        attn_opts = dict(fixed_max=fixed_max, qk_int8=qk_int8, pv_int8=pv_int8)
        p = cfg.patch_size
        dtype = hidden_states.dtype
        if collect_blocks and block_scan is not None:
            raise ValueError("collect_blocks is unsupported under block_scan")
        if collect_blocks and (dp > 1 or sp > 1):
            raise ValueError("collect_blocks needs the whole batch and sequence on "
                             "every rank (no dp or sp axis)")
        # dp: this rank runs its rows of the batch (the CFG pair, a batch of
        # windows) and the ranks gather the outputs at the end
        split_batch = dp > 1 and b % dp == 0
        if ofs is not None:
            ofs = torch.as_tensor(ofs, device=hidden_states.device)
        if split_batch:
            from aether_tpu_torch.parallel.mesh import axis_rank

            n, r = b // dp, axis_rank(self.mesh, "dp")
            rows = slice(r * n, (r + 1) * n)
            hidden_states = hidden_states[rows]
            if encoder_hidden_states.shape[0] == b:
                encoder_hidden_states = encoder_hidden_states[rows]
            if timestep.shape[0] == b:
                timestep = timestep[rows]
            if ofs is not None and ofs.shape[0] == b:
                ofs = ofs[rows]

        t_emb = timestep_embedding(timestep, cfg.hidden_size, cfg.flip_sin_to_cos,
                                   cfg.freq_shift).to(dtype)
        temb = self.time_embed(t_emb)
        if cfg.ofs_embed_dim is not None:
            # CogVideoX-1.5: a second sinusoid + MLP, added to temb before any
            # block (the pp executor's block_scan takes the sum)
            if ofs is None:
                ofs = torch.zeros(hidden_states.shape[0], device=hidden_states.device)
            o_emb = timestep_embedding(ofs, cfg.ofs_embed_dim, cfg.flip_sin_to_cos,
                                       cfg.freq_shift).to(dtype)
            temb = temb + self.ofs_embed(o_emb)

        tokens = self._patch_tokens(hidden_states)
        text_in = encoder_hidden_states.to(dtype)

        # the video tables extend over the text prefix with the identity
        # rotation (cos 1, sin 0): text tokens get no RoPE
        text_len = text_in.shape[1]
        if rope_cos is not None:
            dev = hidden_states.device
            hd = rope_cos.shape[-1]
            rc = torch.cat([torch.ones(text_len, hd, device=dev),
                            rope_cos.to(device=dev, dtype=torch.float32)])
            rs = torch.cat([torch.zeros(text_len, hd, device=dev),
                            rope_sin.to(device=dev, dtype=torch.float32)])
        else:
            rc = rs = None

        stripe = None
        if sp > 1:
            stripe, text_in, tokens, rc, rs = self._stripe(text_in, tokens, rc, rs, sp)
        video = self.proj(tokens)
        text = self.text_proj(text_in)

        collected: List[Tuple[torch.Tensor, torch.Tensor]] = []
        if block_scan is not None:
            # another schedule over the same block body (the pp executor,
            # parallel/pipeline.py): it runs ``body`` on the blocks it holds
            def body(carry, block, temb_mb):
                args = (*carry, temb_mb, rc, rs, attn_impl, attn_opts, act_quant, stripe)
                if remat:
                    return checkpoint(block, *args, use_reentrant=False)
                return block(*args)

            video, text = block_scan(body, (video, text), self.blocks, temb)
        else:
            for block in self.blocks:
                args = (video, text, temb, rc, rs, attn_impl, attn_opts, act_quant, stripe)
                if remat:
                    video, text = checkpoint(block, *args, use_reentrant=False)
                else:
                    video, text = block(*args)
                if collect_blocks:
                    collected.append((video, text))

        joint = torch.cat([text, video], dim=1)
        joint = layer_norm(joint, self.norm_final_scale, self.norm_final_bias,
                           cfg.norm_eps)
        # under sp every row of the stripe goes through the (token-wise)
        # head, and the video rows are cut after the gather
        x = joint if stripe is not None else joint[:, text_len:]
        ada = self.norm_out(F.silu(temb.float()).to(dtype)).float()
        shift, scale = ada.chunk(2, dim=-1)
        x = layer_norm(x, self.norm_out_ln_scale, self.norm_out_ln_bias, cfg.norm_eps)
        x = (x.float() * (1 + scale[:, None]) + shift[:, None]).to(dtype)
        x = self.proj_out(x)
        if stripe is not None:
            x = all_gather_cat(x, 1, stripe.group)[:, text_len:stripe.seq]
        out = self._unpatchify(x, f, h // p, w // p)
        if split_batch:
            out = all_gather_cat(out, 0, self.mesh.get_group("dp"))
        if collect_blocks:
            return out, collected
        return out

    def _stripe(self, text_in, tokens, rc, rs, sp: int):
        """This rank's stripe of the joint stream (text first, padded with
        zero rows to an sp multiple; JAX ``_sp_concat_tokens``): the
        :class:`SeqStripe`, and its rows of the text embeddings, the patch
        tokens and the RoPE tables (pad rows rotate by the identity)."""
        from aether_tpu_torch.parallel.mesh import axis_rank

        tl, seq = text_in.shape[1], text_in.shape[1] + tokens.shape[1]
        seq_pad = -(-seq // sp) * sp
        stripe = SeqStripe(self.mesh.get_group("sp"), sp, axis_rank(self.mesh, "sp"),
                           seq, seq_pad, env_flag("AETHER_SP_RING", False))
        lo, hi = stripe.start, stripe.start + stripe.rows
        tokens = F.pad(tokens, (0, 0, 0, seq_pad - seq))
        text_in = text_in[:, min(lo, tl):min(hi, tl)]
        tokens = tokens[:, max(lo - tl, 0):max(hi - tl, 0)]
        if rc is not None:
            rc = F.pad(rc, (0, 0, 0, seq_pad - seq), value=1.0)[lo:hi]
            rs = F.pad(rs, (0, 0, 0, seq_pad - seq))[lo:hi]
        return stripe, text_in, tokens, rc, rs


@torch.no_grad()
def init_dit(cfg: DiTConfig, *, device="cpu", dtype=torch.float32,
             seed: int = 0) -> DiT:
    """Seeded random DiT on ``device`` with the JAX init's distributions:
    linear weights and biases uniform(+-1/sqrt(fan_in)), norm scales 1 and
    biases 0. Parameters are created on the device directly (no host copy of
    the ~11 GB bf16 AetherV1 weights)."""
    with torch.device("meta"):
        model = DiT(cfg).to(dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, Linear):
            bound = 1.0 / math.sqrt(mod.weight.shape[1])
            mod.weight.uniform_(-bound, bound, generator=gen)
            mod.bias.uniform_(-bound, bound, generator=gen)
    _init_norms(model)
    return model


def _init_norms(model: DiT) -> None:
    """Norm scales 1 and biases 0, as the JAX init draws them."""
    for name, param in model.named_parameters():
        if name.endswith("scale"):
            param.fill_(1.0)
        elif name.endswith(("norm_q_bias", "norm_k_bias", "ln_bias", "norm_final_bias")):
            param.zero_()


def _replace_linears(model: DiT, make) -> None:
    """Swap every :class:`Linear` of ``model`` for ``make(linear)``, one at a
    time: only names are listed up front, so each old weight is freed as soon
    as its replacement is in place."""
    names = [n for n, m in model.named_modules() if isinstance(m, Linear)]
    for name in names:
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        setattr(parent, attr, make(getattr(parent, attr)))


def _dtype_max(dtype: torch.dtype) -> float:
    return float(torch.finfo(dtype).max if dtype.is_floating_point
                 else torch.iinfo(dtype).max)


@torch.no_grad()
def quantize_dit(model: DiT, dtype: torch.dtype = torch.float8_e4m3fn) -> DiT:
    """Weight-only quantization of every linear of ``model``, in place
    (JAX ``quantize_dit_params``, ``aether_tpu/models/dit.py:154-211``).

    Each weight W [out, in] becomes codes ``W / s`` in ``dtype`` (int8 rounded
    to nearest first) with a per-output scale ``s = max(max|W| over in /
    dtype_max, 1e-12)``, all in f32. Module by module, so each full-precision
    weight is freed once its codes exist. Biases and norms stay as they are.
    The fused ``attn.qkv`` rows are q, k, v stacked: per-row scales make its
    codes those of the three projections quantized apart."""
    fmax = _dtype_max(dtype)

    def make(lin: Linear) -> QuantLinear:
        w = lin.weight.detach().float()
        # divided by a tensor, so that CUDA too rounds the quotient correctly
        s = torch.clamp_min(w.abs().amax(dim=1) / w.new_tensor(fmax), 1e-12)
        scaled = w / s[:, None]
        if not dtype.is_floating_point:
            scaled = torch.round(scaled)  # round to nearest, not truncation
        return QuantLinear(scaled.to(dtype), s, lin.bias)

    _replace_linears(model, make)
    return model


def dit_skeleton(cfg: DiTConfig, qdtype: Optional[torch.dtype],
              float_dtype: Optional[torch.dtype] = None) -> DiT:
    """A :class:`DiT` on the meta device, its float parameters in
    ``float_dtype`` (None keeps f32) and, given ``qdtype``, its linears as
    empty :class:`QuantLinear` codes of that dtype."""
    with torch.device("meta"):
        model = DiT(cfg)
        if float_dtype is not None:
            model = model.to(float_dtype)
        if qdtype is not None:
            _replace_linears(model, lambda lin: QuantLinear(
                torch.empty(lin.weight.shape, dtype=qdtype),
                torch.empty(lin.weight.shape[0]), lin.bias))
    return model


@torch.no_grad()
def init_quantized_dit(cfg: DiTConfig, dtype: torch.dtype = torch.float8_e4m3fn, *,
                       device="cpu", seed: int = 0) -> DiT:
    """Seeded random DiT built directly in the quantized layout (JAX
    ``init_quantized_dit_params``, ``aether_tpu/models/dit.py:214-290``); the
    bf16 model is never built. Codes are uniform(-2, 2) cast to ``dtype``
    (int8 truncates to -1, 0, 1), scales 1 / sqrt(fan_in) / 2, biases
    uniform(+-1/sqrt(fan_in)) in bf16, norm scales 1 and biases 0 in bf16:
    the structure, shapes and dtypes of ``quantize_dit(init_dit(cfg,
    dtype=torch.bfloat16), dtype)``."""
    model = dit_skeleton(cfg, dtype, torch.bfloat16).to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, QuantLinear):
            fan_in = mod.q.shape[1]
            mod.q.copy_(torch.empty(mod.q.shape, device=device).uniform_(
                -2.0, 2.0, generator=gen).to(dtype))
            mod.s.fill_(1.0 / fan_in ** 0.5 / 2.0)
            bound = 1.0 / math.sqrt(fan_in)
            mod.bias.uniform_(-bound, bound, generator=gen)
    _init_norms(model)
    return model


def dit_from_state_dict(sd, cfg: DiTConfig, device=None) -> DiT:
    """A :class:`DiT` that takes the tensors of ``sd`` as they are (its
    dtypes kept): quantized (``<name>.q`` / ``.s`` codes and scales) when the
    state dict holds codes, plain otherwise. ``device`` moves it (dtypes
    unchanged)."""
    qdtype = next((t.dtype for k, t in sd.items() if k.endswith(".q")), None)
    model = dit_skeleton(cfg, qdtype)
    model.load_state_dict(sd, strict=True, assign=True)
    return model if device is None else model.to(device)

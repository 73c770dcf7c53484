"""K2, K3, K4 and K6 at head dims below their instance's width, and the
padding of the CUDA wrappers, against the Pallas kernels in interpret mode
(CPU).

On the card every attention kernel is built at the widths 16 to 128 in steps
of 16; a head dim D between two runs the next width's instance on q, k and v
with zero columns up to it, and its output keeps the first D columns.

(a) The plain versions at D in {8, 17, 24, 72, 120, 127} against
``aether_tpu.ops.flash_attention.flash_attention(..., interpret=True)`` at
D, one case of each grid of ``tests/test_torch_flash_head_dims.py`` a head
dim, with that file's tolerances: max abs 2e-5 with f32 operands and float
QK^T; one bf16 ulp of the output scale with bf16 operands or int8 q/k; l
within 1e-5 relative in f32 and 2**-12 in bf16; K6 max abs 1e-3 of max |v|,
mean 1e-5 of it.

(b) The padding itself: the operands the CUDA path hands its kernels, made
by the helper it calls (``_fixed_max_operands(width=...)``,
``_pv8_operands(width=...)``, ``_online_kernel_operands``), run through the
plain loops at the width (``_fixed_max_loop``, ``_pv8_loop``,
``_online_loop``), cut to D and held against the JAX function at D at the
tolerances above. ``sm_scale`` is left unset, so a fold taken from the width
(1/sqrt(80) where 1/sqrt(72) is due) fails. The int8 codes, scales, shifts
and group maxima are bit-equal to the unpadded preparation's and the codes
zero past D. K2: the JAX prologue's outputs zero-padded to the width as the
card's prologue writes them, through the plain K2 at the width, cut, against
the JAX K2 at D (max abs 1e-5, that of ``tests/test_torch_ops.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aether_tpu.ops.attn_prologue import qkv_prologue as jax_qkv_prologue
from aether_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_prepacked as jax_flash_prepacked,
)
from aether_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
PADDED = (8, 17, 24, 72, 120, 127)

# K3: (B, H, Sq), (B, H, Skv) or None, dtype, qk_int8, kv_valid, noshift
K3_CASES = [((2, 3, 200), None, "bf16", True, None, None),
            ((1, 3, 130), (1, 3, 300), "f32", False, 290, False)]
# K3 unnormalized: dtype, qk_int8 at (1, 2, 130) x (1, 2, 300), score bound 30
K3U_CASES = [("bf16", True), ("f32", False)]
# K4: (B, H, S), dtype, denom, kv_valid
K4_CASES = [((1, 2, 300), "bf16", "mxu", 250), ((2, 2, 200), "f32", "mxu", None)]
# K6: (B, H, Sq), (B, H, Skv) or None, dtype, kv_valid
K6_CASES = [((1, 3, 300), None, "bf16", 250)]
BLOCK = 128


def _pallas(*args, **kw):
    return jax_flash_attention(*args, interpret=True, **kw)


def _inputs(shape, seed, kv_shape=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal(kv_shape or shape).astype(np.float32)
    v = rng.standard_normal(kv_shape or shape).astype(np.float32)
    return q, k, v


def _pair(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _bf16_ulp(ref) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(np.asarray(ref, np.float32)).max())) - 7))


def _assert_close(out, ref, atol):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


def _cut(x, d, shape):
    """The kernels' [BH, S, width] result cut to d columns, as [B, H, S, d]."""
    return x[..., :d].reshape(shape)


def _check_padded_ops(ops, plain_ops, d, width):
    """The padded preparation against the unpadded one: every scalar and the
    first d columns bit-equal, zero past d."""
    for name in ("shift", "scale", "vscale"):
        a, b = getattr(ops, name), getattr(plain_ops, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name
    for a, b in zip(ops[:3], plain_ops[:3]):
        assert a.shape[-1] == width and a.dtype == b.dtype
        assert torch.equal(a[..., :d], b) and not a[..., d:].any()


def _fixed_ops(tq, tk, tv, width, **kw):
    opts = dict(sm_scale=None, heads_per_cell=4, score_bound=None, unnormalized=False,
                pv_int8=False, noshift=False)
    opts.update(kw)
    return fa._fixed_max_operands(tq, tk, tv, width=width, **opts)


CASES = ([("K3", d, c) for d in PADDED for c in K3_CASES]
         + [("K3 unnormalized", d, c) for d in PADDED for c in K3U_CASES]
         + [("K4", d, c) for d in PADDED for c in K4_CASES]
         + [("K6", d, c) for d in PADDED for c in K6_CASES])


@pytest.mark.parametrize("kernel,d,case", CASES,
                         ids=[f"{k}-hd{d}-{i}" for i, (k, d, _) in enumerate(CASES)])
def test_padded_head_dims_match_pallas_interpret(kernel, d, case):
    """(a) the plain version at D and (b) the CUDA path's padded operands
    through the plain loop at the width, each against the JAX function."""
    width = fa.head_dim_width(d)
    assert width % 16 == 0 and width - 16 < d < width
    if kernel == "K3":
        bhs, kv_bhs, dtype, qk_int8, kv_valid, noshift = case
        shape, kv_shape = (*bhs, d), kv_bhs and (*kv_bhs, d)
        (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, d + sum(shape), kv_shape), dtype)
        ref = _pallas(jq, jk, jv, block_q=BLOCK, block_k=BLOCK, fixed_max=True,
                      qk_int8=qk_int8, kv_valid=kv_valid, noshift=noshift)
        atol = 2e-5 if dtype == "f32" and not qk_int8 else _bf16_ulp(ref)
        out = fa.flash_attention_fixed_max_plain(tq, tk, tv, kv_valid=kv_valid,
                                                 block_q=BLOCK, noshift=noshift,
                                                 qk_int8=qk_int8)
        _assert_close(out, ref, atol)
        kw = dict(kv_valid=kv_valid, noshift=noshift, qk_int8=qk_int8)
        ops = _fixed_ops(tq, tk, tv, width, **kw)
        _check_padded_ops(ops, _fixed_ops(tq, tk, tv, None, **kw), d, width)
        _assert_close(_cut(fa._fixed_max_loop(ops, BLOCK, False)[0], d, shape), ref, atol)
    elif kernel == "K3 unnormalized":
        dtype, qk_int8 = case
        shape, kv_shape = (1, 2, 130, d), (1, 2, 300, d)
        (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, 9 + d, kv_shape), dtype)
        kw = dict(kv_valid=280, qk_int8=qk_int8, score_bound=30.0, unnormalized=True)
        jo, jl = _pallas(jq, jk, jv, block_q=BLOCK, block_k=BLOCK, fixed_max=True, **kw)
        rtol = 1e-5 if dtype == "f32" else 2.0 ** -12
        exact = dtype == "f32" and not qk_int8
        atol = 2e-5 * float(np.abs(np.asarray(jo)).max()) if exact else _bf16_ulp(jo)
        o, l = fa.flash_attention_fixed_max_plain(tq, tk, tv, block_q=BLOCK, **kw)
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=rtol)
        _assert_close(o, jo, atol)
        ops = _fixed_ops(tq, tk, tv, width, **kw)
        _check_padded_ops(ops, _fixed_ops(tq, tk, tv, None, **kw), d, width)
        po, pl = fa._fixed_max_loop(ops, BLOCK, True)
        np.testing.assert_allclose(pl.reshape(l.shape).numpy(), np.asarray(jl), rtol=rtol)
        _assert_close(_cut(po, d, shape), jo, atol)
    elif kernel == "K4":
        bhs, dtype, denom, kv_valid = case
        shape = (*bhs, d)
        (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, d + sum(shape)), dtype)
        ref = _pallas(jq, jk, jv, block_q=BLOCK, block_k=BLOCK, denom=denom,
                      kv_valid=kv_valid, fixed_max=False)
        atol = 2e-5 if dtype == "f32" else _bf16_ulp(ref)
        out = fa.flash_attention_plain(tq, tk, tv, kv_valid=kv_valid, block_q=BLOCK,
                                       block_k=BLOCK, denom=denom)
        _assert_close(out, ref, atol)
        qh, kh, vh, kv_len, fold = fa._online_kernel_operands(tq, tk, tv, None, kv_valid)
        assert qh.shape[-1] == width and not any(t[..., d:].any() for t in (qh, kh, vh))
        padded = fa._online_loop(qh, kh, vh, kv_len, fold, denom, BLOCK, BLOCK, 4)
        _assert_close(_cut(padded, d, shape), ref, atol)
    else:  # K6
        bhs, kv_bhs, dtype, kv_valid = case
        shape, kv_shape = (*bhs, d), kv_bhs and (*kv_bhs, d)
        arrays = _inputs(shape, 100 + d + sum(shape), kv_shape)
        (jq, jk, jv), (tq, tk, tv) = _pair(arrays, dtype)
        ref = _pallas(jq, jk, jv, block_q=BLOCK, block_k=BLOCK, fixed_max=True,
                      qk_int8=True, pv_int8=True, kv_valid=kv_valid)
        bar = 1e-3 * float(np.abs(arrays[2]).max())
        kw = dict(sm_scale=None, kv_valid=kv_valid, block_k=BLOCK, heads_per_cell=4)
        *_, ops, _ = fa._pv8_operands(tq, tk, tv, width=width, **kw)
        *_, plain_ops, _ = fa._pv8_operands(tq, tk, tv, **kw)
        _check_padded_ops(ops, plain_ops, d, width)
        for out in (fa.flash_attention_pv8_plain(tq, tk, tv, kv_valid=kv_valid,
                                                 block_q=BLOCK, block_k=BLOCK),
                    _cut(fa._pv8_loop(ops, BLOCK, BLOCK), d, shape)):
            err = np.abs(out.float().numpy() - np.asarray(ref, np.float32))
            assert err.max() <= bar and err.mean() <= 1e-2 * bar, (err.max(), err.mean())


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("d", [8, 24, 72, 120])
def test_prepacked_padded_to_its_width_matches_pallas(d, quantize):
    """(b) for K2: the JAX prologue's q, k and v at D zero-padded to the
    width (the columns the card's prologue writes as zeros), through the
    plain K2 at the width, cut to D, against the JAX K2 at D; the stats carry
    the fold of D, so nothing else changes."""
    width = fa.head_dim_width(d)
    rng = np.random.default_rng(d)
    nh, s = 4, 300
    xs = [rng.standard_normal((2, s, nh * d)).astype(np.float32) for _ in range(3)]
    norms = [(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
             (0.1 * rng.standard_normal(d)).astype(np.float32)] * 2
    ang = rng.standard_normal((s, d // 2)) * 0.5
    rope = [np.repeat(f(ang), 2, axis=1).astype(np.float32) for f in (np.cos, np.sin)]
    jq, jk, jv, jqsc, jqn, jksc, jkn, _ = jax_qkv_prologue(
        *(jnp.asarray(a) for a in xs + norms + rope), num_heads=nh, head_dim=d, eps=1e-6,
        s_valid=250, quantize=quantize, interpret=True)
    ref = jax_flash_prepacked(jq, jk, jv, qsc=jqsc, ksc=jksc, qn=jqn, kn=jkn, dim=d,
                              out_dtype=jnp.float32, interpret=True)
    q, k, qsc, ksc, qn, kn = (torch.from_numpy(np.array(a))
                              for a in (jq, jk, jqsc, jksc, jqn, jkn))
    v = torch.from_numpy(np.asarray(jv)[..., :d].copy())
    stats = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=250)
    out = fa.flash_attention_prepacked_plain(
        *(fa._pad_cols(t, width) for t in (q, k, v)), **stats)
    assert out.shape[-1] == width
    np.testing.assert_allclose(out[..., :d].numpy(), np.asarray(ref), atol=1e-5)
    torch.testing.assert_close(out[..., :d],
                               fa.flash_attention_prepacked_plain(q, k, v, **stats),
                               rtol=0, atol=0)

"""K3's and K6's plain versions against the Pallas kernels in interpret mode (CPU).

``aether_tpu_torch.ops.flash_attention.flash_attention_fixed_max_plain`` and
``flash_attention_pv8_plain`` are held against
``aether_tpu.ops.flash_attention.flash_attention(..., fixed_max=True,
interpret=True)`` on the same numpy-seeded inputs and the same block sizes.

Tolerances:
- K3, float q/k, f32: max abs 2e-5 (two f32 implementations of one function;
  the order of the sums differs, and the shift, a sum of squares, may differ
  in its last bit, which cancels in the ratio).
- K3 with bf16 operands, or int8 q/k: one bf16 ulp of the output scale,
  ``2**(floor(log2 max|ref|) - 7)``. The int8 codes are equal on both sides
  (the same f32 products rounded half to even), so the scores are; p is
  rounded to bf16 against the same shift, and only the order of the sums and
  the last rounding separate the two.
- K3 unnormalized: the same bars on o; l within 1e-5 relative in f32 and
  2**-12 in bf16 (see the test).
- K6: the running max moves per kv block of ``_pick_block(Skv, block_k)``
  columns on both sides, so p8 is rounded against the same max and every
  integer product and block sum is exact. Only exp2's last bit (XLA's CPU
  exp2 against torch's) can flip a rint at a .5 boundary; one flipped p8
  moves a row by at most max|v8| / l of the output. The bar is 1e-3 of
  max |v| at most, and the mean error 1e-5 of it.
The CUDA kernels are held against the same plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aether_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from aether_tpu_torch.ops.flash_attention import (
    _pv8_v_layout,
    attention_reference,
    flash_attention,
    flash_attention_fixed_max,
    flash_attention_fixed_max_plain,
    flash_attention_pv8,
    flash_attention_pv8_plain,
)

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed, kv_shape=None, qk_scale=1.0):
    rng = np.random.default_rng(seed)
    q = (qk_scale * rng.standard_normal(shape)).astype(np.float32)
    k = (qk_scale * rng.standard_normal(kv_shape or shape)).astype(np.float32)
    v = rng.standard_normal(kv_shape or shape).astype(np.float32)
    return q, k, v


def _pair(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _bf16_ulp(ref) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))


def _assert_close(out, ref, atol):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


# (shape, kv_shape or None, dtype, qk_int8, kv_valid, noshift, (block_q, block_k))
K3_CASES = [
    ((1, 2, 256, 64), None, "f32", False, None, False, (128, 128)),
    ((2, 2, 200, 64), None, "f32", False, None, True, (128, 128)),    # ragged S
    ((1, 2, 300, 64), None, "f32", False, 250, None, (128, 128)),     # kv_valid
    ((1, 3, 130, 64), (1, 3, 300, 64), "f32", False, 290, False, (128, 128)),  # Sq < Skv
    ((1, 2, 256, 64), None, "bf16", False, None, False, (128, 128)),
    ((1, 3, 300, 64), None, "bf16", False, 250, None, (1024, 1024)),  # B*H = 3
    ((1, 2, 256, 64), None, "f32", True, None, False, (128, 128)),
    ((2, 3, 200, 64), None, "bf16", True, None, None, (128, 128)),    # B*H = 6
    ((1, 2, 300, 64), None, "bf16", True, 250, True, (128, 128)),
    ((1, 5, 130, 64), (1, 5, 300, 64), "bf16", True, 290, False, (128, 128)),  # B*H = 5
]


@pytest.mark.parametrize("shape,kv_shape,dtype,qk_int8,kv_valid,noshift,blocks", K3_CASES)
def test_fixed_max_plain_matches_pallas_interpret(shape, kv_shape, dtype, qk_int8,
                                                  kv_valid, noshift, blocks):
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, sum(shape), kv_shape), dtype)
    bq, bk = blocks
    ref = jax_flash_attention(jq, jk, jv, block_q=bq, block_k=bk, fixed_max=True,
                              qk_int8=qk_int8, kv_valid=kv_valid, noshift=noshift,
                              interpret=True)
    out = flash_attention_fixed_max_plain(tq, tk, tv, kv_valid=kv_valid, block_q=bq,
                                          noshift=noshift, qk_int8=qk_int8)
    assert out.dtype == tq.dtype
    exact = dtype == "f32" and not qk_int8
    _assert_close(out, ref, 2e-5 if exact else _bf16_ulp(ref))
    # the CPU wrappers run the plain version, bit for bit
    for fn in (flash_attention_fixed_max, flash_attention):
        kw = dict(fixed_max=True) if fn is flash_attention else {}
        wrapped = fn(tq, tk, tv, kv_valid=kv_valid, block_q=bq, noshift=noshift,
                     qk_int8=qk_int8, **kw)
        assert torch.equal(wrapped, out)


@pytest.mark.parametrize("dtype,qk_int8", [("f32", False), ("bf16", False), ("bf16", True)])
def test_fixed_max_unnormalized_score_bound(dtype, qk_int8):
    """The ring-merge mode: a caller's bound, raw numerator in q's dtype and
    f32 denominator; their ratio is the normalized attention."""
    shape, kv_shape = (1, 2, 130, 64), (1, 2, 300, 64)
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, 9, kv_shape), dtype)
    bound = 30.0
    jo, jl = jax_flash_attention(jq, jk, jv, block_q=128, block_k=128, fixed_max=True,
                                 qk_int8=qk_int8, kv_valid=280, score_bound=bound,
                                 unnormalized=True, interpret=True)
    o, l = flash_attention_fixed_max_plain(tq, tk, tv, kv_valid=280, block_q=128,
                                           qk_int8=qk_int8, score_bound=bound,
                                           unnormalized=True)
    assert o.dtype == tq.dtype and l.dtype == torch.float32
    assert l.shape == (1, 2, 130, 1)
    # bf16: a few p fall on the other side of a bf16 rounding boundary (the
    # two exp2s differ in the last bit), each moving l by one bf16 ulp of one
    # term of a sum of ~Skv terms
    np.testing.assert_allclose(l.numpy(), np.asarray(jl),
                               rtol=1e-5 if dtype == "f32" else 2.0 ** -12)
    exact = dtype == "f32" and not qk_int8
    _assert_close(o, jo, 2e-5 * float(np.abs(np.asarray(jo)).max()) if exact
                  else _bf16_ulp(np.asarray(jo, np.float32)))
    wo, wl = flash_attention(tq, tk, tv, kv_valid=280, block_q=128, fixed_max=True,
                             qk_int8=qk_int8, score_bound=bound, unnormalized=True)
    assert torch.equal(wo, o) and torch.equal(wl, l)
    normalized = flash_attention_fixed_max_plain(tq, tk, tv, kv_valid=280,
                                                 qk_int8=qk_int8)
    np.testing.assert_allclose((o.float() / l).numpy(), normalized.float().numpy(),
                               atol=3 * _bf16_ulp(normalized.float().numpy()))


def test_fixed_max_noshift_auto_picks_on_the_bound():
    """noshift=None drops the shift below a bound of 96 and keeps it above;
    both give the attention. k = q with rows of one norm r puts every row's
    max score on the bound r**2 / 8 * log2(e), so the shifted branch keeps
    the weights in range (bounds ~ 1.6 and ~ 162)."""
    rng = np.random.default_rng(4)
    unit = rng.standard_normal((1, 2, 128, 64))
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    v = rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
    for r in (3.0, 30.0):
        q = (r * unit).astype(np.float32)
        (jq, jk, jv), (tq, tk, tv) = _pair((q, q.copy(), v), "f32")
        ref = jax_flash_attention(jq, jk, jv, block_q=128, block_k=128, fixed_max=True,
                                  noshift=None, interpret=True)
        out = flash_attention_fixed_max_plain(tq, tk, tv, noshift=None)
        _assert_close(out, ref, 2e-5)
        _assert_close(out, attention_reference(tq, tk, tv), 1e-4)


# ---- the Hopper cell's tiling (csrc/fixed_cell.cuh, K2 and K3) ----


def _cell_loop(q, k, v, *, kv_len, hper, shift, scale_of=None, unnormalized=False):
    """The tiling of the fixed-shift cell in plain torch: each 64-row
    warpgroup tile of q [BH, Sq, D] against k/v [BH, Skv, D] in 128-column
    tiles up to kv_len, in the kernel's order; the int8 scale one scalar per
    (warpgroup, kv tile), ``scale_of(g, row0, col0)`` (None: float q/k);
    p = exp2(s - shift[g]) rounded to v's dtype, 0 at the columns >= kv_len
    of the tile that crosses it; tiles wholly past kv_len skipped. Returns
    (out [BH, Sq, D] in v's dtype, normalized unless asked, l [BH, Sq, 1])."""
    bh, sq, d = q.shape
    out = torch.empty((bh, sq, d), dtype=v.dtype)
    l_out = torch.empty((bh, sq, 1))
    for head in range(bh):
        g = head // hper
        for r0 in range(0, sq, 64):
            qb = q[head, r0:r0 + 64].float()
            acc = torch.zeros((qb.shape[0], d))
            l = torch.zeros((qb.shape[0], 1))
            for c0 in range(0, kv_len, 128):
                s = qb @ k[head, c0:c0 + 128].float().T
                if scale_of is not None:
                    s = s * scale_of(g, r0, c0)
                p = torch.exp2(s - shift[g])
                if c0 + 128 > kv_len:
                    col = torch.arange(c0, c0 + s.shape[1])
                    p = torch.where(col < kv_len, p, torch.zeros(()))
                p = p.to(v.dtype).float()
                acc += p @ v[head, c0:c0 + 128].float()
                l += p.sum(dim=-1, keepdim=True)
            if not unnormalized:
                acc = acc * torch.where(l <= 0.0, torch.ones_like(l), 1.0 / l)
            out[head, r0:r0 + 64] = acc.to(v.dtype)
            l_out[head, r0:r0 + 64] = l
    return out, l_out


# the tiling's cases: (shape, kv_shape or None, dtype, qk_int8, kv_valid), each
# with a tail tile that kv_valid or the length cuts and q tiles of 64 rows
# that Sq does not fill
TILING_K3_CASES = [
    ((1, 2, 300, 64), None, "f32", False, 250),
    ((1, 3, 130, 64), (1, 3, 300, 64), "bf16", False, 290),   # Sq < Skv, tile 3 empty
    ((2, 3, 200, 64), None, "bf16", True, None),              # B*H 6: groups of 3
    ((1, 5, 130, 64), (1, 5, 300, 64), "bf16", True, 250),    # B*H 5: groups of 1
]


@pytest.mark.parametrize("shape,kv_shape,dtype,qk_int8,kv_valid", TILING_K3_CASES)
def test_k3_cell_tiling_matches_pallas_interpret(shape, kv_shape, dtype, qk_int8, kv_valid):
    """K3's normalized attention through the cell's tiling on the wrapper's
    prepared operands, against the Pallas kernel at 128-row, 128-column
    blocks: the tolerances of the plain version's test above (2e-5 in f32
    with float q/k, one bf16 ulp of the output scale otherwise)."""
    from aether_tpu_torch.ops.flash_attention import _fixed_max_operands

    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, 40 + sum(shape), kv_shape), dtype)
    ref = jax_flash_attention(jq, jk, jv, block_q=128, block_k=128, fixed_max=True,
                              qk_int8=qk_int8, kv_valid=kv_valid, interpret=True)
    ops = _fixed_max_operands(tq, tk, tv, sm_scale=None, kv_valid=kv_valid, heads_per_cell=4,
                              noshift=False, qk_int8=qk_int8, pv_int8=False,
                              score_bound=None, unnormalized=False)
    scale_of = (lambda g, r0, c0: ops.scale[g]) if qk_int8 else None
    out, _ = _cell_loop(ops.q, ops.k, ops.v, kv_len=ops.kv_len, hper=ops.hper,
                        shift=ops.shift, scale_of=scale_of)
    out = out.reshape(shape)
    exact = dtype == "f32" and not qk_int8
    _assert_close(out, ref, 2e-5 if exact else _bf16_ulp(ref))


@pytest.mark.parametrize("dtype,qk_int8", [("f32", False), ("bf16", False), ("bf16", True)])
def test_k3_cell_tiling_unnormalized_matches_pallas_interpret(dtype, qk_int8):
    """K3's ring-merge mode through the cell's tiling: o and l against the
    Pallas kernel at the tolerances of the unnormalized test above (l 1e-5
    relative in f32 and 2**-12 in bf16; o 2e-5 of its scale in f32, one
    bf16 ulp otherwise). 130 q rows fill three 64-row tiles partly; kv_valid
    280 of 300 cuts the third 128-column tile."""
    from aether_tpu_torch.ops.flash_attention import _fixed_max_operands

    shape, kv_shape = (1, 2, 130, 64), (1, 2, 300, 64)
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, 9, kv_shape), dtype)
    jo, jl = jax_flash_attention(jq, jk, jv, block_q=128, block_k=128, fixed_max=True,
                                 qk_int8=qk_int8, kv_valid=280, score_bound=30.0,
                                 unnormalized=True, interpret=True)
    ops = _fixed_max_operands(tq, tk, tv, sm_scale=None, kv_valid=280, heads_per_cell=4,
                              noshift=False, qk_int8=qk_int8, pv_int8=False,
                              score_bound=30.0, unnormalized=True)
    scale_of = (lambda g, r0, c0: ops.scale[g]) if qk_int8 else None
    o, l = _cell_loop(ops.q, ops.k, ops.v, kv_len=ops.kv_len, hper=ops.hper,
                      shift=ops.shift, scale_of=scale_of, unnormalized=True)
    np.testing.assert_allclose(l.reshape(1, 2, 130, 1).numpy(), np.asarray(jl),
                               rtol=1e-5 if dtype == "f32" else 2.0 ** -12)
    exact = dtype == "f32" and not qk_int8
    _assert_close(o.reshape(shape), jo, 2e-5 * float(np.abs(np.asarray(jo)).max()) if exact
                  else _bf16_ulp(np.asarray(jo, np.float32)))


@pytest.mark.parametrize("quantize,dtype", [(True, "f32"), (False, "f32"), (False, "bf16"),
                                            (True, "bf16")])
@pytest.mark.parametrize("block_q", [1024, 128])
def test_k2_cell_tiling_matches_pallas_interpret(quantize, dtype, block_q):
    """K2 through the cell's tiling on K1's operands (the Pallas prologue in
    interpret mode), against the Pallas K2 at the same blocks: the scale of
    a 64-row warpgroup and a 128-column kv tile is qsc[g, row0 // block] *
    ksc[g, col0 // block] (block 128: the warpgroups of one 192-row CTA read
    different qsc entries), the shift max qn * max kn, s_valid 250 of the
    384 padded tokens. Tolerances: f32 out atol 1e-5, as K2's plain version
    (tests/test_torch_ops.py); bf16 out one bf16 ulp of the output scale."""
    from aether_tpu.ops.attn_prologue import qkv_prologue as jax_qkv_prologue
    from aether_tpu.ops.flash_attention import flash_attention_prepacked as jax_prepacked

    rng = np.random.default_rng(70 + block_q)
    b, s, nh, hd = 2, 300, 4, 64
    jdt = DTYPES[dtype][0]
    xs = [jnp.asarray(rng.standard_normal((b, s, nh * hd)).astype(np.float32)).astype(jdt)
          for _ in range(3)]
    norms = [jnp.asarray((1.0 + 0.1 * rng.standard_normal(hd)).astype(np.float32)),
             jnp.asarray((0.1 * rng.standard_normal(hd)).astype(np.float32)),
             jnp.asarray((1.0 + 0.1 * rng.standard_normal(hd)).astype(np.float32)),
             jnp.asarray((0.1 * rng.standard_normal(hd)).astype(np.float32))]
    jq, jk, jv, jqsc, jqn, jksc, jkn, s_pad = jax_qkv_prologue(
        *xs, *norms, None, None, num_heads=nh, head_dim=hd, eps=1e-6, s_valid=250,
        quantize=quantize, block_q=block_q, interpret=True)
    ref = jax_prepacked(jq, jk, jv, qsc=jqsc, ksc=jksc, qn=jqn, kn=jkn, dim=hd,
                        out_dtype=jdt, block_q=block_q, block_k=block_q, interpret=True)
    block = s_pad // jqsc.shape[-1]
    assert s_pad == 384 and block == min(block_q, 384)

    def t(x):
        a = np.asarray(x)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))

    q, k, v = t(jq), t(jk), t(jv)[..., :hd].contiguous()
    qsc, ksc, qn, kn = t(jqsc), t(jksc), t(jqn), t(jkn)
    scale_of = ((lambda g, r0, c0: qsc[g, r0 // block] * ksc[g, c0 // block])
                if quantize else None)
    out, _ = _cell_loop(q, k, v, kv_len=250, hper=4, shift=qn.amax(-1) * kn.amax(-1),
                        scale_of=scale_of)
    _assert_close(out, ref, 1e-5 if dtype == "f32" else _bf16_ulp(np.asarray(ref, np.float32)))


# (shape, kv_shape or None, dtype, kv_valid, (block_q, block_k))
K6_CASES = [
    ((1, 2, 256, 64), None, "f32", None, (128, 128)),     # no padding, two kv blocks
    ((2, 2, 200, 64), None, "bf16", None, (128, 128)),    # padding bias
    ((1, 3, 300, 64), None, "bf16", 250, (128, 128)),     # kv_valid, three blocks
    ((1, 2, 130, 64), (1, 2, 300, 64), "f32", 290, (1024, 1024)),  # one block, Sq < Skv
    ((1, 5, 256, 64), None, "bf16", None, (256, 256)),    # B*H = 5
]


def _pv8_bar(v) -> float:
    return 1e-3 * float(np.abs(np.asarray(v, np.float32)).max())


@pytest.mark.parametrize("shape,kv_shape,dtype,kv_valid,blocks", K6_CASES)
def test_pv8_plain_matches_pallas_interpret(shape, kv_shape, dtype, kv_valid, blocks):
    arrays = _inputs(shape, 100 + sum(shape), kv_shape)
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, dtype)
    bq, bk = blocks
    ref = jax_flash_attention(jq, jk, jv, block_q=bq, block_k=bk, fixed_max=True,
                              qk_int8=True, pv_int8=True, kv_valid=kv_valid,
                              interpret=True)
    out = flash_attention_pv8_plain(tq, tk, tv, kv_valid=kv_valid, block_q=bq,
                                    block_k=bk)
    assert out.dtype == tq.dtype
    err = np.abs(out.float().numpy() - np.asarray(ref, np.float32))
    bar = _pv8_bar(arrays[2])
    assert err.max() <= bar and err.mean() <= 1e-2 * bar, (err.max(), err.mean())
    for fn in (flash_attention_pv8, flash_attention):
        kw = dict(fixed_max=True, qk_int8=True, pv_int8=True) if fn is flash_attention else {}
        wrapped = fn(tq, tk, tv, kv_valid=kv_valid, block_q=bq, block_k=bk, **kw)
        assert torch.equal(wrapped, out)


def test_pv8_negative_row_max_with_padding():
    """Every real score deeply negative plus padded columns: the -1e9 bias
    keeps the padding from pinning the running max at 0 (which would
    underflow every real weight); the result is the uniform average of v."""
    b, h, s, d = 1, 1, 200, 64  # pads to 256
    q = np.full((b, h, s, d), 3.0, np.float32)
    k = -np.full((b, h, s, d), 3.0, np.float32)  # scores -72 (log2 domain -104)
    v = np.random.default_rng(3).standard_normal((b, h, s, d)).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _pair((q, k, v), "f32")
    ref = jax_flash_attention(jq, jk, jv, block_q=128, block_k=128, fixed_max=True,
                              qk_int8=True, pv_int8=True, interpret=True)
    out = flash_attention_pv8_plain(tq, tk, tv, block_q=128, block_k=128)
    bar = _pv8_bar(v)
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= bar
    mean_v = np.broadcast_to(v.mean(axis=2, keepdims=True), v.shape)
    # int8 v: the uniform average within the quantization step of v
    assert np.abs(out.numpy() - mean_v).max() <= np.abs(v).max() / 127


def test_pv8_v_layout_is_a_chunk_permutation():
    """K6's v8 layout: transposed, and each 32-column chunk permuted so that
    logical k = 16a + 4t + j holds column 16a + 8(j // 2) + 2t + j % 2 (the
    columns a thread holds in the QK^T accumulator)."""
    v8 = torch.arange(2 * 64 * 64, dtype=torch.int64).reshape(2, 64, 64)
    vt = _pv8_v_layout(v8)
    assert vt.shape == (2, 64, 64)
    for kk in range(64):
        chunk, r = divmod(kk, 32)
        a, t, j = r // 16, (r % 16) // 4, r % 4
        col = chunk * 32 + 16 * a + 8 * (j // 2) + 2 * t + j % 2
        assert torch.equal(vt[:, :, kk], v8[:, col, :])
    # a permutation inside every chunk: sums over k are unchanged
    assert torch.equal(vt.sum(dim=2), v8.sum(dim=1))


@pytest.mark.parametrize("kw,match", [
    (dict(qk_int8=True), "qk_int8 requires fixed_max"),
    (dict(pv_int8=True), "pv_int8 requires fixed_max"),
    (dict(fixed_max=True, pv_int8=True), "pv_int8 requires qk_int8"),
    (dict(unnormalized=True), "fixed-max-family"),
    (dict(fixed_max=True, qk_int8=True, pv_int8=True, score_bound=1.0),
     "fixed-max-family"),
])
def test_argument_rules_match_jax(kw, match):
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs((1, 1, 64, 64), 1), "f32")
    with pytest.raises(ValueError, match=match):
        jax_flash_attention(jq, jk, jv, interpret=True, **kw)
    with pytest.raises(ValueError, match=match):
        flash_attention(tq, tk, tv, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_quantization_one_pass_forms_equal_the_reference(dtype):
    """``_group_absmax`` (one aminmax pass in x's dtype) and
    ``_quantize_groups`` (x * r promoted to f32, rounded in place) give the
    bits of the direct forms ``x.float().abs().amax()`` and
    ``round(x.float() * r)``, groups led by a negative or a positive value."""
    from aether_tpu_torch.ops.flash_attention import _group_absmax, _quantize_groups

    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((6, 50, 64)).astype(np.float32)).to(dtype)
    x[0, 3, 5] = -9.0  # group 0 led by a negative value
    x[4, 7, 1] = 7.5   # group 2 by a positive one
    hper = 2
    absmax = _group_absmax(x, hper)
    ref = x.float().abs().reshape(3, -1).amax(dim=-1).clamp_min(1e-30)
    assert absmax.dtype == torch.float32 and torch.equal(absmax, ref)
    r = (127.0 / ref).repeat_interleave(hper)[:, None, None]
    assert torch.equal(_quantize_groups(x, absmax, hper),
                       torch.round(x.float() * r).to(torch.int8))


def test_pv8_operands_skip_the_unused_shift():
    """K6 derives its own integer max, so its preparation computes no
    Cauchy-Schwarz shift; everything it hands the kernel is what the K6
    preparation with the bound gave: codes, scales, padding, v layout."""
    from aether_tpu_torch.ops.flash_attention import _fixed_max_operands, _pv8_operands

    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 3, 150, 64), 5, (1, 3, 300, 64)))
    kw = dict(sm_scale=None, kv_valid=280, heads_per_cell=4)
    qp, kp, vt, ops, span = _pv8_operands(q, k, v, block_k=128, **kw)
    assert span == 128 and not ops.shift.any()
    full = _fixed_max_operands(q, k, v, noshift=False, qk_int8=True, pv_int8=False,
                               score_bound=None, unnormalized=False, **kw)
    assert torch.equal(qp[:, :150], full.q) and not qp[:, 150:].any()
    assert qp.shape[1] == 192 and kp.shape[1] == 384 and not kp[:, 280:].any()
    assert torch.equal(kp[:, :300], full.k) and torch.equal(ops.scale, full.scale)
    assert vt.shape == (3, 64, 384)

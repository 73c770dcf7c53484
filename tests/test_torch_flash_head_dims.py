"""K3, K4 and K6's plain versions at the head dims other than 64 against the
Pallas kernels in interpret mode (CPU).

``flash_attention_fixed_max_plain`` (K3), ``flash_attention_plain`` (K4)
and ``flash_attention_pv8_plain`` (K6) are held against
``aether_tpu.ops.flash_attention.flash_attention(..., interpret=True)`` on
the same numpy-seeded inputs at head_dim 16, 32 and 112 (K4 also 128), over
the option grids of ``tests/test_torch_flash_fixed_max.py`` and
``tests/test_torch_flash_online.py``, and K3, K3 unnormalized and K6 at 48,
80 and 96 on one case of each grid: f32 and bf16, int8 QK^T, each
``noshift``, ``kv_valid``, Sq < Skv, B*H not a multiple of the head group,
unnormalized with a ``score_bound``, the "mxu" and "vpu" denominators. At
head_dim 128 K3's and K6's options go through ``flash_attention``, which
turns the fixed max off and takes K4 "vpu", as the JAX wrapper does. One
parametrised test; each case counts.

A fault of the JAX wrapper that the port does not reproduce: at head_dim >=
128 with ``qk_int8=True`` the JAX wrapper skips the ``sm_scale * log2e`` fold
(it rides the int8 dequantization, :521-522) before it turns ``qk_int8`` off
(:538-548), so its K4 scores q . k unscaled: JAX's result equals K4 at
``sm_scale = ln 2``. The port folds; those cases are held against the JAX
K4 with the fixed max off, the function the wrapper falls back to, and the
fault is asserted beside it.

Tolerances, those of the head_dim-64 tests:
- K3 and K4 with f32 q/k/v and float QK^T: max abs 2e-5 (two f32
  implementations; the order of the sums differs).
- bf16 operands or int8 q/k: one bf16 ulp of the output scale,
  ``2**(floor(log2 max|ref|) - 7)`` (the same int8 codes and the same p
  rounded to bf16 against the same shift or running max on both sides).
- K3 unnormalized: l within 1e-5 relative in f32 and 2**-12 in bf16; o 2e-5
  of its largest magnitude in f32, one bf16 ulp otherwise.
- K6: max abs 1e-3 of max |v| and mean 1e-5 of it (only exp2's last bit can
  flip a p8 at a .5 boundary).
The CUDA kernels are held against the same plain versions on the card
(``chip_smoke.py`` phase 27, ``tests/test_torch_cuda.py``).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aether_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from aether_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_fixed_max,
    flash_attention_fixed_max_plain,
    flash_attention_plain,
    flash_attention_pv8,
    flash_attention_pv8_plain,
)

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
HEAD_DIMS = (16, 32, 112)

# (B, H, Sq), (B, H, Skv) or None, dtype, qk_int8, kv_valid, noshift, (block_q, block_k)
K3_GRID = [
    ((1, 2, 256), None, "f32", False, None, False, (128, 128)),
    ((2, 2, 200), None, "f32", False, None, True, (128, 128)),     # ragged S
    ((1, 2, 300), None, "f32", False, 250, None, (128, 128)),      # kv_valid
    ((1, 3, 130), (1, 3, 300), "f32", False, 290, False, (128, 128)),  # Sq < Skv
    ((1, 2, 256), None, "bf16", False, None, False, (128, 128)),
    ((1, 3, 300), None, "bf16", False, 250, None, (1024, 1024)),   # B*H = 3
    ((1, 2, 256), None, "f32", True, None, False, (128, 128)),
    ((2, 3, 200), None, "bf16", True, None, None, (128, 128)),     # B*H = 6
    ((1, 2, 300), None, "bf16", True, 250, True, (128, 128)),
    ((1, 5, 130), (1, 5, 300), "bf16", True, 290, False, (128, 128)),  # B*H = 5
]
# dtype, qk_int8 of the unnormalized (ring-merge) mode, at (1, 2, 130) x (1, 2, 300)
K3U_GRID = [("f32", False), ("bf16", False), ("bf16", True)]
# (B, H, S), dtype, denom, kv_valid, (block_q, block_k)
K4_GRID = [
    ((1, 2, 256), "f32", "mxu", None, (128, 128)),   # exact block multiples
    ((2, 2, 200), "f32", "mxu", None, (128, 128)),   # ragged S: pad + mask
    ((1, 2, 384), "f32", "mxu", None, (256, 128)),   # asymmetric blocks
    ((1, 2, 300), "f32", "vpu", None, (1024, 1024)),
    ((1, 2, 300), "f32", "mxu", 250, (128, 128)),    # kv_valid tail
    ((1, 2, 256), "bf16", "mxu", None, (128, 128)),
    ((2, 2, 200), "bf16", "vpu", None, (128, 128)),
    ((1, 2, 300), "bf16", "mxu", 250, (128, 128)),
    ((1, 2, 300), "bf16", "vpu", 250, (1024, 1024)),
]
# (B, H, Sq), (B, H, Skv) or None, dtype, kv_valid, (block_q, block_k)
K6_GRID = [
    ((1, 2, 256), None, "f32", None, (128, 128)),     # no padding, two kv blocks
    ((2, 2, 200), None, "bf16", None, (128, 128)),    # padding bias
    ((1, 3, 300), None, "bf16", 250, (128, 128)),     # kv_valid, three blocks
    ((1, 2, 130), (1, 2, 300), "f32", 290, (1024, 1024)),  # one block, Sq < Skv
    ((1, 5, 256), None, "bf16", None, (256, 256)),    # B*H = 5
]
# the fixed-max options at head_dim 128: dtype, qk_int8, pv_int8, noshift
AT_128_GRID = [("f32", False, False, False), ("bf16", True, False, None),
               ("bf16", True, True, False), ("f32", True, False, True)]

# K3 and K6's other head dims (one wgmma kernel each on the card, templated
# over the head dim): one case of each grid, bf16 operands where the grid has them
MORE_DIMS = {48: (K3_GRID[7], K3U_GRID[2], K6_GRID[2]),
             80: (K3_GRID[9], K3U_GRID[1], K6_GRID[3]),
             96: (K3_GRID[5], K3U_GRID[2], K6_GRID[1])}

CASES = ([("K3", hd, c) for hd in HEAD_DIMS for c in K3_GRID]
         + [("K3 unnormalized", hd, c) for hd in HEAD_DIMS for c in K3U_GRID]
         + [("K4", hd, c) for hd in HEAD_DIMS + (128,) for c in K4_GRID]
         + [("K6", hd, c) for hd in HEAD_DIMS for c in K6_GRID]
         + [("fixed max at 128", 128, c) for c in AT_128_GRID]
         + [(kernel, hd, c) for hd, cases in MORE_DIMS.items()
            for kernel, c in zip(("K3", "K3 unnormalized", "K6"), cases)])


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


def _k3(hd, case):
    bhs, kv_bhs, dtype, qk_int8, kv_valid, noshift, (bq, bk) = case
    shape, kv_shape = (*bhs, hd), kv_bhs and (*kv_bhs, hd)
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, hd + sum(shape), kv_shape), dtype)
    ref = _pallas(jq, jk, jv, block_q=bq, block_k=bk, fixed_max=True, qk_int8=qk_int8,
                  kv_valid=kv_valid, noshift=noshift)
    out = flash_attention_fixed_max_plain(tq, tk, tv, kv_valid=kv_valid, block_q=bq,
                                          noshift=noshift, qk_int8=qk_int8)
    assert out.dtype == tq.dtype
    _assert_close(out, ref, 2e-5 if dtype == "f32" and not qk_int8 else _bf16_ulp(ref))
    for fn, kw in ((flash_attention_fixed_max, {}), (flash_attention, dict(fixed_max=True))):
        assert torch.equal(fn(tq, tk, tv, kv_valid=kv_valid, block_q=bq, noshift=noshift,
                              qk_int8=qk_int8, **kw), out)


def _k3_unnormalized(hd, case):
    dtype, qk_int8 = case
    shape, kv_shape = (1, 2, 130, hd), (1, 2, 300, hd)
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, 9 + hd, kv_shape), dtype)
    kw = dict(kv_valid=280, qk_int8=qk_int8, score_bound=30.0, unnormalized=True)
    jo, jl = _pallas(jq, jk, jv, block_q=128, block_k=128, fixed_max=True, **kw)
    o, l = flash_attention_fixed_max_plain(tq, tk, tv, block_q=128, **kw)
    assert o.dtype == tq.dtype and l.dtype == torch.float32 and l.shape == (1, 2, 130, 1)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl),
                               rtol=1e-5 if dtype == "f32" else 2.0 ** -12)
    exact = dtype == "f32" and not qk_int8
    _assert_close(o, jo, 2e-5 * float(np.abs(np.asarray(jo)).max()) if exact
                  else _bf16_ulp(jo))
    wo, wl = flash_attention(tq, tk, tv, block_q=128, fixed_max=True, **kw)
    assert torch.equal(wo, o) and torch.equal(wl, l)


def _k4(hd, case):
    bhs, dtype, denom, kv_valid, (bq, bk) = case
    shape = (*bhs, hd)
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, hd + sum(shape)), dtype)
    ref = _pallas(jq, jk, jv, block_q=bq, block_k=bk, denom=denom, kv_valid=kv_valid,
                  fixed_max=False)
    out = flash_attention_plain(tq, tk, tv, kv_valid=kv_valid, block_q=bq, block_k=bk,
                                denom=denom)
    assert out.dtype == tq.dtype
    _assert_close(out, ref, 2e-5 if dtype == "f32" else _bf16_ulp(ref))
    assert torch.equal(flash_attention(tq, tk, tv, kv_valid=kv_valid, block_q=bq,
                                       block_k=bk, denom=denom), out)


def _k6(hd, case):
    bhs, kv_bhs, dtype, kv_valid, (bq, bk) = case
    shape, kv_shape = (*bhs, hd), kv_bhs and (*kv_bhs, hd)
    arrays = _inputs(shape, 100 + hd + sum(shape), kv_shape)
    (jq, jk, jv), (tq, tk, tv) = _pair(arrays, dtype)
    ref = _pallas(jq, jk, jv, block_q=bq, block_k=bk, fixed_max=True, qk_int8=True,
                  pv_int8=True, kv_valid=kv_valid)
    out = flash_attention_pv8_plain(tq, tk, tv, kv_valid=kv_valid, block_q=bq, block_k=bk)
    assert out.dtype == tq.dtype
    err = np.abs(out.float().numpy() - np.asarray(ref, np.float32))
    bar = 1e-3 * float(np.abs(arrays[2]).max())
    assert err.max() <= bar and err.mean() <= 1e-2 * bar, (err.max(), err.mean())
    for fn, kw in ((flash_attention_pv8, {}),
                   (flash_attention, dict(fixed_max=True, qk_int8=True, pv_int8=True))):
        assert torch.equal(fn(tq, tk, tv, kv_valid=kv_valid, block_q=bq, block_k=bk, **kw),
                           out)


def _fixed_max_at_128(hd, case):
    dtype, qk_int8, pv_int8, noshift = case
    shape = (1, 2, 200, hd)
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, 128 + int(qk_int8) + int(pv_int8)),
                                       dtype)
    kw = dict(fixed_max=True, qk_int8=qk_int8, pv_int8=pv_int8, noshift=noshift,
              block_q=128, block_k=128)
    out = flash_attention(tq, tk, tv, **kw)
    assert torch.equal(out, flash_attention_plain(tq, tk, tv, block_q=128, block_k=128,
                                                  denom="vpu"))
    atol = 2e-5 if dtype == "f32" else _bf16_ulp(out.float().numpy())
    if qk_int8:
        # the JAX wrapper's fault: the fold skipped, K4 at sm_scale ln 2
        ref = _pallas(jq, jk, jv, **kw)
        _assert_close(flash_attention(tq, tk, tv, sm_scale=math.log(2.0), **kw), ref, atol)
        kw.update(qk_int8=False, pv_int8=False)
    _assert_close(out, _pallas(jq, jk, jv, **kw), atol)


RUN = {"K3": _k3, "K3 unnormalized": _k3_unnormalized, "K4": _k4, "K6": _k6,
       "fixed max at 128": _fixed_max_at_128}


@pytest.mark.parametrize("kernel,hd,case", CASES,
                         ids=[f"{k}-hd{hd}-{i}" for i, (k, hd, _) in enumerate(CASES)])
def test_plain_matches_pallas_interpret(kernel, hd, case):
    RUN[kernel](hd, case)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_group_codes_match_jax_on_half_way_points(dtype):
    """The per-group int8 codes of K3 and K6 equal the JAX wrapper's
    ``rint(x * (127 / absmax))`` (XLA divides correctly rounded), also where
    x * 127 / absmax lies on a half-way point: 2.109375 against a group
    maximum of 4.21875 is code 63.5, which rounds to 64. Torch's
    ``127.0 / t`` (127 * reciprocal(t), two roundings) gave 63 there."""
    import jax

    from aether_tpu_torch.ops.flash_attention import _group_absmax, _quantize_groups

    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 40, 16)).astype(np.float32)
    x[0, 0, :2] = (4.21875, 2.109375)
    x[2, 1, :2] = (-4.21875, -2.109375)
    jx, tx = _pair((x,), dtype)[0][0], _pair((x,), dtype)[1][0]
    hper = 2

    def jax_codes(a):
        a32 = a.astype(jnp.float32)
        absmax = jnp.maximum(jnp.max(jnp.abs(a32).reshape(3, -1), axis=-1), 1e-30)
        r = jnp.repeat(127.0 / absmax, hper)[:, None, None]
        return jnp.rint(a32 * r).astype(jnp.int8)

    got = _quantize_groups(tx, _group_absmax(tx, hper), hper)
    assert got[0, 0, 1].item() == 64 and got[2, 1, 1].item() == -64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(jax_codes)(jx)))

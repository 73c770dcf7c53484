"""K4 above head_dim 128 against the Pallas kernel in interpret mode (CPU).

The JAX ``flash_attention`` sends every head dim >= 128 to ``_flash_kernel``
with the "vpu" denominator and the fixed max, ``qk_int8`` and ``pv_int8``
off (``aether_tpu/ops/flash_attention.py:538-548``); it has no upper limit.
On the card the port runs K4 there at the widths 160, 192, 224 and 256 (a
head dim between them on the next width's instance, on zero-padded
operands). Here ``flash_attention_plain`` and ``flash_attention`` (which a
CPU tensor routes to it) are held against
``aether_tpu.ops.flash_attention.flash_attention(..., interpret=True)`` on
the same numpy-seeded inputs at head_dim 136, 160, 200 and 256, bf16 and
f32:
- K4 as asked for (``fixed_max=False``), "mxu" asked and "vpu" taken:
  ``kv_valid`` inside a kv block, Sq != Skv, B*H odd (head groups of 3), one
  kv block and several;
- the default flags of the DiT's unfused route (``fixed_max=True,
  qk_int8=True``, noshift auto) and ``fixed_max=True`` with float QK^T,
  which the wrapper turns into K4 "vpu" as the JAX wrapper does.
A fault of the JAX wrapper the port does not reproduce (ROADMAP "Deliberate
departures"): with ``qk_int8=True`` at head_dim >= 128 the JAX wrapper skips
the ``sm_scale * log2e`` fold (it rides the int8 dequantization, :521-522)
before it turns ``qk_int8`` off, so its K4 scores q . k unscaled: JAX's
result equals the port's K4 at ``sm_scale = ln 2``. The port folds; those
cases assert both: the port against the JAX K4 with the fixed max off, and
the port at ``sm_scale = ln 2`` against JAX as called.

The padding itself (``test_padded_operands_match_pallas_interpret``): the
operands the CUDA path hands its kernels above 128, made by the helper it
calls (``_online_kernel_operands``: q, k and v zero-padded to the next width,
160, 192, 224 or 256, and the fold of the true D), run through the plain loop
at the width (``_online_loop``, "vpu"), cut to D, against the unpadded plain
result and the JAX function at D. ``sm_scale`` is left unset, so a fold
taken from the width (1/sqrt(160) where 1/sqrt(136) is due) fails.

Tolerances, those of the K4 grid of ``tests/test_torch_flash_head_dims.py``:
max abs 2e-5 with f32 operands (two f32 implementations, another order of
the sums); one bf16 ulp of the output scale, ``2**(floor(log2 max|ref|) -
7)``, with bf16 operands (the same p rounded against the same running max
on both sides). The CUDA kernels are held against the same plain version on
the card (``chip_smoke.py`` phase 29, ``tests/test_torch_cuda.py``).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aether_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from aether_tpu_torch.ops import flash_attention as fa
from aether_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
HEAD_DIMS = (136, 160, 200, 256)

# K4 as asked for: (B, H, Sq), (B, H, Skv) or None, dtype, kv_valid,
# (block_q, block_k)
K4_CASES = [
    ((1, 2, 300), None, "f32", 250, (128, 128)),          # kv_valid inside a block
    ((1, 3, 130), (1, 3, 300), "bf16", 290, (128, 128)),  # Sq != Skv, B*H = 3
    ((2, 2, 200), None, "bf16", None, (1024, 1024)),       # one kv block
    ((1, 3, 130), (1, 3, 300), "f32", None, (128, 128)),   # Sq != Skv, three blocks
]
# the fixed-max flags the wrapper turns off: (B, H, S), dtype, qk_int8
FIXED_CASES = [((1, 3, 200), "bf16", True), ((1, 2, 200), "f32", False)]

CASES = ([("K4", hd, c) for hd in HEAD_DIMS for c in K4_CASES]
         + [("fixed max off", hd, c) for hd in HEAD_DIMS for c in FIXED_CASES])


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


def _k4(hd, case):
    bhs, kv_bhs, dtype, kv_valid, (bq, bk) = case
    shape, kv_shape = (*bhs, hd), kv_bhs and (*kv_bhs, hd)
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, hd + sum(shape), kv_shape), dtype)
    kw = dict(kv_valid=kv_valid, block_q=bq, block_k=bk, denom="mxu")
    ref = _pallas(jq, jk, jv, fixed_max=False, **kw)
    out = flash_attention_plain(tq, tk, tv, **kw)
    assert out.dtype == tq.dtype
    _assert_close(out, ref, 2e-5 if dtype == "f32" else _bf16_ulp(ref))
    # "mxu" asked, "vpu" taken at head_dim >= 128, as the JAX wrapper does
    assert torch.equal(out, flash_attention_plain(tq, tk, tv, **dict(kw, denom="vpu")))
    assert torch.equal(flash_attention(tq, tk, tv, **kw), out)


def _fixed_max_off(hd, case):
    bhs, dtype, qk_int8 = case
    shape = (*bhs, hd)
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, 7 * hd + int(qk_int8)), dtype)
    kw = dict(fixed_max=True, qk_int8=qk_int8, noshift=None, block_q=128, block_k=128)
    out = flash_attention(tq, tk, tv, **kw)
    assert torch.equal(out, flash_attention_plain(tq, tk, tv, block_q=128, block_k=128,
                                                  denom="vpu"))

    def atol(ref):
        return 2e-5 if dtype == "f32" else _bf16_ulp(ref)

    if qk_int8:
        # the JAX wrapper's fault: the fold skipped, K4 at sm_scale ln 2
        ref = _pallas(jq, jk, jv, **kw)
        _assert_close(flash_attention(tq, tk, tv, sm_scale=math.log(2.0), **kw), ref,
                      atol(ref))
        kw.update(qk_int8=False)
    ref = _pallas(jq, jk, jv, **kw)
    _assert_close(out, ref, atol(ref))


RUN = {"K4": _k4, "fixed max off": _fixed_max_off}


@pytest.mark.parametrize("kernel,hd,case", CASES,
                         ids=[f"{k}-hd{hd}-{i}" for i, (k, hd, _) in enumerate(CASES)])
def test_wide_k4_matches_pallas_interpret(kernel, hd, case):
    RUN[kernel](hd, case)


# head dims between the widths above 128 and the width they run on; one
# case each: (B, H, S), dtype, kv_valid
PADDED = [(129, 160, (1, 3, 200), "bf16", 170), (136, 160, (1, 2, 300), "f32", 250),
          (144, 160, (2, 2, 130), "bf16", None), (200, 224, (1, 3, 200), "f32", 190),
          (220, 224, (1, 2, 300), "bf16", 290), (250, 256, (1, 3, 130), "f32", None)]


@pytest.mark.parametrize("d,width,bhs,dtype,kv_valid", PADDED)
def test_padded_operands_match_pallas_interpret(d, width, bhs, dtype, kv_valid):
    """The CUDA path's padded operands through the plain loop at the width,
    cut to D, against the unpadded plain version and the JAX K4 at D."""
    assert fa.head_dim_width(d) == width and width % 32 == 0 and width - 32 < d < width
    shape = (*bhs, d)
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, d + sum(shape)), dtype)
    ref = _pallas(jq, jk, jv, block_q=128, block_k=128, kv_valid=kv_valid, fixed_max=False)
    atol = 2e-5 if dtype == "f32" else _bf16_ulp(ref)
    plain = flash_attention_plain(tq, tk, tv, kv_valid=kv_valid, block_q=128, block_k=128)
    _assert_close(plain, ref, atol)
    qh, kh, vh, kv_len, fold = fa._online_kernel_operands(tq, tk, tv, None, kv_valid)
    assert qh.shape[-1] == width and fold == fa._online_fold(None, d)
    assert not any(t[..., d:].any() for t in (qh, kh, vh))
    padded = fa._online_loop(qh, kh, vh, kv_len, fold, "vpu", 128, 128, 4)
    padded = padded[..., :d].reshape(shape)
    _assert_close(padded, ref, atol)
    plain = plain.float().numpy()
    _assert_close(padded, plain, 2e-6 if dtype == "f32" else _bf16_ulp(plain))

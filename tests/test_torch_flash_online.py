"""K4's plain version against the Pallas kernel in interpret mode (CPU).

``aether_tpu_torch.ops.flash_attention.flash_attention_plain`` is held against
``aether_tpu.ops.flash_attention.flash_attention(..., fixed_max=False,
interpret=True)`` on the same numpy-seeded inputs, with the same block sizes,
so both run the online softmax over the same kv blocks.

Tolerances: f32 max abs <= 2e-5 (two f32 implementations; only the order of
the sums differs). bf16 within one bf16 ulp of the output scale,
2**(floor(log2 max|ref|) - 7): p is rounded to bf16 at the same running max on
both sides, so only order-of-sum noise and the final rounding separate them.
The CUDA kernel is held against the same plain version on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aether_tpu.ops.flash_attention import (
    attention_reference as jax_attention_reference,
    flash_attention as jax_flash_attention,
)
from aether_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
    flash_attention_fixed_max_plain,
    flash_attention_plain,
)

torch.set_num_threads(1)

F32_ATOL = 2e-5


def _inputs(shape, seed, kv_shape=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape).astype(np.float32)
    k, v = (rng.standard_normal(kv_shape or shape).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _pair(arrays, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _assert_close(out, ref, dtype):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if dtype == "f32":
        np.testing.assert_allclose(out, ref, atol=F32_ATOL, rtol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        np.testing.assert_allclose(out, ref, atol=ulp, rtol=0)


# (shape, dtype, denom, kv_valid, (block_q, block_k))
CASES = [
    ((1, 2, 256, 64), "f32", "mxu", None, (128, 128)),   # exact block multiples
    ((2, 2, 200, 64), "f32", "mxu", None, (128, 128)),   # ragged S: pad + mask
    ((1, 2, 384, 64), "f32", "mxu", None, (256, 128)),   # asymmetric blocks
    ((1, 2, 300, 64), "f32", "vpu", None, (1024, 1024)),
    ((1, 2, 300, 64), "f32", "mxu", 250, (128, 128)),    # kv_valid tail
    ((2, 1, 200, 128), "f32", "mxu", None, (128, 128)),  # head_dim 128: vpu
    ((1, 2, 256, 64), "bf16", "mxu", None, (128, 128)),
    ((2, 2, 200, 64), "bf16", "vpu", None, (128, 128)),
    ((1, 2, 300, 64), "bf16", "mxu", 250, (128, 128)),
    ((1, 2, 300, 64), "bf16", "vpu", 250, (1024, 1024)),
    ((2, 1, 200, 128), "bf16", "mxu", None, (128, 128)),
]


@pytest.mark.parametrize("shape,dtype,denom,kv_valid,blocks", CASES)
def test_plain_matches_pallas_interpret(shape, dtype, denom, kv_valid, blocks):
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, seed=sum(shape)), dtype)
    bq, bk = blocks
    ref = jax_flash_attention(jq, jk, jv, block_q=bq, block_k=bk, denom=denom,
                              kv_valid=kv_valid, fixed_max=False, interpret=True)
    out = flash_attention_plain(tq, tk, tv, kv_valid=kv_valid, block_q=bq,
                                block_k=bk, denom=denom)
    assert out.dtype == tq.dtype
    _assert_close(out, ref, dtype)
    # the CPU wrapper runs the plain version, bit for bit
    wrapped = flash_attention(tq, tk, tv, kv_valid=kv_valid, block_q=bq,
                              block_k=bk, denom=denom)
    assert torch.equal(wrapped, out)


def test_bf16_denominators_differ_and_each_matches():
    """With bf16 v the two denominators are different functions (rounded vs
    unrounded p); the plain version reproduces each of them."""
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs((1, 2, 256, 64), seed=11), "bf16")
    outs = {}
    for denom in ("mxu", "vpu"):
        ref = jax_flash_attention(jq, jk, jv, block_q=128, block_k=128,
                                  denom=denom, interpret=True)
        outs[denom] = flash_attention_plain(tq, tk, tv, block_k=128, denom=denom)
        _assert_close(outs[denom], ref, "bf16")
    assert not torch.equal(outs["mxu"], outs["vpu"])


def test_cross_attention_lengths():
    """Sq != Skv (the sequence-parallel stripe against the full K/V)."""
    (jq, jk, jv), (tq, tk, tv) = _pair(
        _inputs((1, 2, 130, 64), seed=5, kv_shape=(1, 2, 300, 64)), "f32")
    ref = jax_flash_attention(jq, jk, jv, block_q=128, block_k=128,
                              kv_valid=290, interpret=True)
    _assert_close(flash_attention_plain(tq, tk, tv, kv_valid=290, block_k=128),
                  ref, "f32")


def test_extreme_negative_scores_with_padding():
    """All real scores deeply negative plus kv padding: the masked columns must
    not take the softmax over (the case of tests/test_flash_attention.py)."""
    b, h, s, d = 1, 1, 200, 64  # pads to 256
    q = np.full((b, h, s, d), 5.0, np.float32)
    k = -np.full((b, h, s, d), 5.0, np.float32)  # scores = -25*64/8 = -200
    v = np.random.default_rng(3).standard_normal((b, h, s, d)).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _pair((q, k, v), "f32")
    ref = jax_flash_attention(jq, jk, jv, block_q=128, block_k=128, interpret=True)
    out = flash_attention_plain(tq, tk, tv, block_q=128, block_k=128)
    _assert_close(out, ref, "f32")
    # and it is the uniform average of v, as plain attention gives
    np.testing.assert_allclose(out.numpy(), attention_reference(tq, tk, tv).numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_reference_matches_jax(dtype):
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs((2, 2, 96, 32), seed=2), dtype)
    _assert_close(attention_reference(tq, tk, tv),
                  jax_attention_reference(jq, jk, jv), dtype)


def test_unported_options_raise():
    """qk_int8 / pv_int8 without the fixed max raise the JAX ValueError
    (fixed_max=True itself runs K3 now, tests/test_torch_flash_fixed_max.py);
    at head_dim >= 128 the JAX wrapper switches the fixed-max options off,
    and so does the port."""
    _, (tq, tk, tv) = _pair(_inputs((1, 1, 64, 64), seed=1), "f32")
    for kw in ({"qk_int8": True}, {"pv_int8": True}):
        with pytest.raises(ValueError, match="requires fixed_max"):
            flash_attention(tq, tk, tv, **kw)
    assert torch.equal(flash_attention(tq, tk, tv, fixed_max=True),
                       flash_attention_fixed_max_plain(tq, tk, tv))
    _, (tq, tk, tv) = _pair(_inputs((1, 1, 64, 128), seed=1), "f32")
    out = flash_attention(tq, tk, tv, fixed_max=True, qk_int8=True)
    assert torch.equal(out, flash_attention_plain(tq, tk, tv, denom="vpu"))
    with pytest.raises(ValueError, match="denom"):
        flash_attention_plain(tq[..., :64], tk[..., :64], tv[..., :64], denom="x")


def test_online_preparation_splits_into_fold_and_kv_tail():
    """The bf16 CUDA path folds q in the kernel and takes k/v from
    ``_online_kv``; together with ``_online_fold`` they are the JAX
    wrapper's preparation, ``_online_operands``."""
    from aether_tpu_torch.ops import _build
    from aether_tpu_torch.ops.flash_attention import _online_fold, _online_kv, _online_operands

    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 70, 64)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    qo, ko, vo, kv_len = _online_operands(q, k, v, None, 50)
    k2, v2, kv_len2 = _online_kv(k, v, 50)
    assert kv_len == kv_len2 == 50 and not k2[:, :, 50:].any() and not v2[:, :, 50:].any()
    assert torch.equal(ko, k2) and torch.equal(vo, v2)
    assert _online_fold(None, 64) == 0.125 * 1.4426950408889634
    assert torch.equal(qo, (q.float() * _online_fold(None, 64)).to(torch.bfloat16))
    assert _online_fold(0.5, 64) == 0.5 * 1.4426950408889634
    # the bf16 kernel's C entry point: q, k, v, out, BH, sq, skv, kv_len,
    # round_l, the fold as a float, the head dim, the stream
    sig = _build.SIGNATURES["aether_flash_online_bf16"]
    assert len(sig) == 12 and sig[9] is ctypes.c_float and sig[10] is ctypes.c_int

"""Kernel modules of the PyTorch port against the JAX package (CPU).

``aether_tpu_torch.ops.attn_prologue`` (K1) and ``ops.flash_attention`` (K2)
take their plain PyTorch versions on CPU tensors; the JAX side runs the Pallas
kernels in interpret mode, as ``tests/test_attn_prologue.py`` does. Same
inputs, made from a numpy seed, on both sides. The CUDA kernels themselves are
held against the same plain versions on the card by ``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aether_tpu.ops.attn_prologue import (
    _pick_pad_and_block as jax_pick_pad_and_block,
    fused_joint_attention as jax_fused_joint_attention,
    qkv_prologue as jax_qkv_prologue,
)
from aether_tpu.ops.flash_attention import (
    _pick_block as jax_pick_block,
    flash_attention_prepacked as jax_flash_prepacked,
)
from aether_tpu_torch.ops.attn_prologue import (
    _pick_pad_and_block,
    fused_joint_attention,
    qkv_prologue,
    qkv_prologue_plain,
)
from aether_tpu_torch.ops.flash_attention import (
    _pick_block,
    flash_attention_prepacked,
    flash_attention_prepacked_plain,
)

torch.set_num_threads(1)

B, S, NH, HD = 2, 300, 4, 64
EPS = 1e-6


# the head dims K1 and K2 take besides 64 (the JAX pair takes every multiple
# of 16 below 128): the parity tests run the smallest, a power of two and
# the largest
HEAD_DIMS = [16, 32, 64, 112]


@functools.lru_cache(maxsize=None)
def _make_data(hd):
    rng = np.random.default_rng(7)
    d = NH * hd
    xq, xk, xv = (rng.standard_normal((B, S, d)).astype(np.float32)
                  for _ in range(3))
    gq, gk = ((1.0 + 0.1 * rng.standard_normal((hd,))).astype(np.float32)
              for _ in range(2))
    bq, bk = ((0.1 * rng.standard_normal((hd,))).astype(np.float32)
              for _ in range(2))
    ang = rng.standard_normal((S, hd // 2)) * 0.5
    cos = np.repeat(np.cos(ang), 2, axis=1).astype(np.float32)
    sin = np.repeat(np.sin(ang), 2, axis=1).astype(np.float32)
    return xq, xk, xv, gq, bq, gk, bk, cos, sin


@pytest.fixture(scope="module")
def data():
    return _make_data(HD)


def _both(data, rope: bool, s_valid, hd=HD):
    xq, xk, xv, gq, bq, gk, bk, cos, sin = data
    if not rope:
        cos = sin = None
    j = [jnp.asarray(a) if a is not None else None
         for a in (xq, xk, xv, gq, bq, gk, bk, cos, sin)]
    t = [torch.from_numpy(a) if a is not None else None
         for a in (xq, xk, xv, gq, bq, gk, bk, cos, sin)]
    kw = dict(num_heads=NH, head_dim=hd, eps=EPS, s_valid=s_valid)
    return j, t, kw


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("s_valid", [None, 250])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_prologue_plain_matches_pallas(hd, quantize, rope, s_valid):
    j, t, kw = _both(_make_data(hd), rope, s_valid, hd)
    jq, jk, jv, jqsc, jqn, jksc, jkn, jpad = jax_qkv_prologue(
        *j, quantize=quantize, interpret=True, **kw)
    tq, tk, tv, tqsc, tqn, tksc, tkn, tpad = qkv_prologue_plain(
        *t, quantize=quantize, **kw)
    assert tpad == jpad
    for a, b in ((tqsc, jqsc), (tqn, jqn), (tksc, jksc), (tkn, jkn)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    for a, b in ((tq, jq), (tk, jk)):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if quantize:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1
            assert (diff > 0).mean() <= 1e-3
        else:
            np.testing.assert_allclose(a, b, atol=1e-5)
    # v is plain: exactly the value lanes of the TPU kernel's [v | 1 | 0]
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv)[..., :hd])
    # the CPU wrapper dispatches to the plain version
    wq = qkv_prologue(*t, quantize=quantize, **kw)[0]
    torch.testing.assert_close(wq, tq, rtol=0, atol=0)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_prepacked_plain_matches_pallas(hd, quantize):
    j, t, kw = _both(_make_data(hd), True, 250, hd)
    jq, jk, jv, jqsc, jqn, jksc, jkn, _ = jax_qkv_prologue(
        *j, quantize=quantize, interpret=True, **kw)
    ref = jax_flash_prepacked(jq, jk, jv, qsc=jqsc, ksc=jksc, qn=jqn, kn=jkn,
                              dim=hd, out_dtype=jnp.float32, interpret=True)
    ops = [torch.from_numpy(np.array(a)) for a in (jq, jk, jqsc, jksc, jqn, jkn)]
    v = torch.from_numpy(np.asarray(jv)[..., :hd].copy())
    out = flash_attention_prepacked_plain(
        ops[0], ops[1], v, qsc=ops[2], ksc=ops[3], qn=ops[4], kn=ops[5],
        s_valid=250)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    wrapped = flash_attention_prepacked(
        ops[0], ops[1], v, qsc=ops[2], ksc=ops[3], qn=ops[4], kn=ops[5],
        s_valid=250)
    torch.testing.assert_close(wrapped, out, rtol=0, atol=0)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("noshift,gain", [(False, 1.0), (True, 1.0), (None, 1.0),
                                          (None, 8.0)])
def test_flash_prepacked_noshift_matches_pallas(data, noshift, gain, quantize):
    """K2's ``noshift`` as the JAX function has it: True drops the shift,
    None drops it, decided on the device, when every group's bound is below
    96. The K norm's scale and bias times ``gain`` move the bounds from
    about 14 (None drops the shift) to about 114 (None keeps it). The plain
    version against the Pallas kernel in interpret mode on the same
    operands, f32 out: atol 1e-5, as the shifted case above, and 2e-5 at
    gain 8, whose eight times larger scores make the softmax sharper and
    the last bits of the two libraries' exp2 weigh more; the CPU wrapper bit
    for bit."""
    xq, xk, xv, gq, bq, gk, bk, cos, sin = data
    j, t, kw = _both((xq, xk, xv, gq, bq, gk * gain, bk * gain, cos, sin), True, 250)
    jq, jk, jv, jqsc, jqn, jksc, jkn, _ = jax_qkv_prologue(
        *j, quantize=quantize, interpret=True, **kw)
    bounds = np.asarray(jqn).max(-1) * np.asarray(jkn).max(-1)
    assert (bounds.max() < 96.0) == (gain == 1.0)
    ref = jax_flash_prepacked(jq, jk, jv, qsc=jqsc, ksc=jksc, qn=jqn, kn=jkn, dim=HD,
                              out_dtype=jnp.float32, noshift=noshift, interpret=True)
    ops = [torch.from_numpy(np.array(a)) for a in (jq, jk)]
    v = torch.from_numpy(np.asarray(jv)[..., :HD].copy())
    stats = dict(qsc=_to_torch(jqsc), ksc=_to_torch(jksc), qn=_to_torch(jqn),
                 kn=_to_torch(jkn), s_valid=250)
    out = flash_attention_prepacked_plain(*ops, v, noshift=noshift, **stats)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5 if gain == 1.0 else 2e-5)
    assert torch.equal(flash_attention_prepacked(*ops, v, noshift=noshift, **stats), out)
    if noshift is None:  # the branch the bounds pick
        picked = flash_attention_prepacked_plain(*ops, v, noshift=gain == 1.0, **stats)
        assert torch.equal(out, picked)


def test_flash_prepacked_refuses_a_bad_noshift(data):
    j, t, kw = _both(data, True, 250)
    q, k, v, qsc, qn, ksc, kn, _ = qkv_prologue_plain(*t, quantize=False, **kw)
    with pytest.raises(ValueError, match="noshift"):
        flash_attention_prepacked(q, k, v, qsc=qsc, ksc=ksc, qn=qn, kn=kn, noshift="auto")


@pytest.mark.parametrize("noshift", [False, True, None])
def test_fused_joint_attention_noshift_matches_pallas(data, noshift):
    """``noshift`` through K1 + K2 end to end, float branch: atol 2e-5, as
    the shifted case below."""
    j, t, kw = _both(data, True, None)
    ref = np.asarray(jax_fused_joint_attention(*j, quantize=False, noshift=noshift,
                                               interpret=True, **kw))
    out = fused_joint_attention(*t, quantize=False, noshift=noshift, **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("quantize,atol", [(False, 2e-5), (True, 2e-2)])
@pytest.mark.parametrize("rope", [False, True])
def test_fused_joint_attention_matches_pallas(data, quantize, atol, rope):
    j, t, kw = _both(data, rope, None)
    ref = np.asarray(jax_fused_joint_attention(*j, quantize=quantize,
                                               interpret=True, **kw))
    out = fused_joint_attention(*t, quantize=quantize, **kw).numpy()
    assert out.shape == ref.shape == (B, S, NH * HD)
    np.testing.assert_allclose(out, ref, atol=atol)


def _bf16_pair(data, rope: bool):
    """``_both``'s inputs with the projections in bf16 on both sides (the
    DiT's working type); the norm parameters and RoPE tables stay f32."""
    j, t, _ = _both(data, rope, None)
    return ([a.astype(jnp.bfloat16) for a in j[:3]] + j[3:],
            [a.to(torch.bfloat16) for a in t[:3]] + t[3:])


def _to_torch(x):
    """A JAX array (bf16 included) as a torch tensor of the same dtype."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _assert_bf16_ulp(out, ref, ulps=1):
    """Within ``ulps`` bf16 ulps of the output scale, 2**(floor(log2 max|ref|) - 7)."""
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    np.testing.assert_allclose(out, ref, atol=ulps * ulp, rtol=0)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("s_valid", [None, 250])
def test_prologue_plain_float_bf16_matches_pallas(data, rope, s_valid):
    """The float (QK8=0) branch on bf16 projections: bf16 q (z * fold) and k
    within one bf16 ulp of the tensor's scale of the Pallas kernel's, the
    stats to 1e-5, v bit-exact."""
    jb, tb = _bf16_pair(data, rope)
    kw = _both(data, rope, s_valid)[2]
    ref = jax_qkv_prologue(*jb, quantize=False, interpret=True, **kw)
    got = qkv_prologue_plain(*tb, quantize=False, **kw)
    assert got[7] == ref[7]
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == torch.bfloat16
        _assert_bf16_ulp(a, np.asarray(b, np.float32))
    assert torch.equal(got[2], _to_torch(ref[2])[..., :HD])
    for a, b in zip(got[3:7], ref[3:7]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    wrapped = qkv_prologue(*tb, quantize=False, **kw)
    assert all(torch.equal(a, b) for a, b in zip(wrapped[:7], got[:7]))


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("s_valid", [None, 250])
def test_prologue_plain_int8_bf16_matches_pallas(data, rope, s_valid):
    """The int8 branch on bf16 projections: the plain version's correctly
    rounded 1 / sqrt against the Pallas kernel's ``rsqrt``; codes at most 1
    apart on at most 1e-3 of the elements, the stats to 1e-5, v bit-exact."""
    jb, tb = _bf16_pair(data, rope)
    kw = _both(data, rope, s_valid)[2]
    ref = jax_qkv_prologue(*jb, quantize=True, interpret=True, **kw)
    got = qkv_prologue_plain(*tb, quantize=True, **kw)
    assert got[7] == ref[7]
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == torch.int8
        diff = np.abs(a.numpy().astype(np.int32) - np.asarray(b).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert torch.equal(got[2], _to_torch(ref[2])[..., :HD])
    for a, b in zip(got[3:7], ref[3:7]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_flash_prepacked_plain_float_bf16_matches_pallas(data):
    """The float K2 on the JAX prologue's bf16 operands, bf16 out: within
    one bf16 ulp of the output scale."""
    jb, _ = _bf16_pair(data, True)
    kw = _both(data, True, 250)[2]
    jq, jk, jv, jqsc, jqn, jksc, jkn, _ = jax_qkv_prologue(
        *jb, quantize=False, interpret=True, **kw)
    ref = jax_flash_prepacked(jq, jk, jv, qsc=jqsc, ksc=jksc, qn=jqn, kn=jkn,
                              dim=HD, out_dtype=jnp.bfloat16, interpret=True)
    q, k = _to_torch(jq), _to_torch(jk)
    v = _to_torch(jv)[..., :HD].contiguous()
    stats = dict(qsc=_to_torch(jqsc), ksc=_to_torch(jksc), qn=_to_torch(jqn),
                 kn=_to_torch(jkn), s_valid=250)
    out = flash_attention_prepacked_plain(q, k, v, **stats)
    assert out.dtype == torch.bfloat16
    _assert_bf16_ulp(out, np.asarray(ref, np.float32))
    assert torch.equal(flash_attention_prepacked(q, k, v, **stats), out)


def test_fused_joint_attention_float_bf16_matches_pallas(data):
    """K1 + K2 float on bf16 projections end to end: within two bf16 ulps of
    the output scale (q/k may round one ulp apart before the scores)."""
    jb, tb = _bf16_pair(data, True)
    kw = _both(data, True, None)[2]
    ref = np.asarray(jax_fused_joint_attention(*jb, quantize=False, interpret=True,
                                               **kw).astype(jnp.float32))
    out = fused_joint_attention(*tb, quantize=False, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, NH * HD)
    _assert_bf16_ulp(out, ref, ulps=2)


def test_fused_joint_attention_prepadded_s_valid(data):
    """The DiT pre-pads the joint stream; s_valid must mask the pad rows."""
    j, t, kw = _both(data, True, None)
    out = fused_joint_attention(*t, quantize=False, **kw)
    pad = (0, 0, 0, 84)
    kw["s_valid"] = S
    padded = [torch.nn.functional.pad(x, pad) for x in t[:3]]
    out_p = fused_joint_attention(*padded, *t[3:], quantize=False, **kw)
    torch.testing.assert_close(out_p[:, :S], out, rtol=0, atol=1e-6)


def test_pickers_match_jax():
    for s in list(range(1, 20001)) + [6976, 15076]:
        assert _pick_pad_and_block(s, 1024) == jax_pick_pad_and_block(s, 1024), s
        assert _pick_block(s, 1024) == jax_pick_block(s, 1024), s
    assert _pick_pad_and_block(15076, 1024) == (15360, 1024)


def test_unported_settings_raise_on_cuda_only_paths(data):
    """The AETHER_ATTN_* settings resolve as the JAX dit_forward resolves
    them: FUSED=0 and PV8=1 route the DiT to the unfused path (K3, K6), PV8
    implies unfused, and FIXED_MAX=0 switches QK8, PV8 and FUSED off. QK8=0
    keeps the fused path and takes the float branches of K1/K2, which run on
    CUDA too (tests/test_torch_cuda.py)."""
    from aether_tpu_torch.models.dit import resolve_attention

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AETHER_ATTN_QK8", "1")
        mp.setenv("AETHER_ATTN_PV8", "0")
        assert resolve_attention() == (True, True, False, True)
        for name, value, expected in (("AETHER_ATTN_FUSED", "0", (True, True, False, False)),
                                      ("AETHER_ATTN_PV8", "1", (True, True, True, False))):
            with pytest.MonkeyPatch.context() as inner:
                inner.setenv(name, value)
                assert resolve_attention() == expected
                inner.setenv("AETHER_ATTN_FIXED_MAX", "0")
                assert resolve_attention() == (False, False, False, False)
                # explicit arguments win over the environment, as in dit_forward
                assert resolve_attention(fixed_max=True) == expected
        mp.setenv("AETHER_ATTN_QK8", "0")
        assert resolve_attention()[1] is False

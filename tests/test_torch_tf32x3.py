"""The split-TF32 (3xTF32) arithmetic of the f32 attention kernels, on the CPU.

``csrc/tf32x3_cell.cuh`` (K4 in f32 through ``csrc/flash_online.cu``, K3 in
f32 through ``csrc/flash_fixed_max_hd.cu``) computes every f32 product from
operands split as ``x_hi = tf32(x)``, ``x_lo = tf32(x - x_hi)`` and keeps
three of the four products. A CUDA kernel cannot run here, so this file
checks what the card's run rests on:

- the wrapper's own operand functions (``ops/flash_attention.py``): the tf32
  rounding as an integer operation on the f32 bits with ties away from zero
  (``cvt.rna.tf32.f32``'s rounding), the hi/lo split, and V^T with its kv
  order permuted to the cell's A fragments (derived here from the fragment
  layout that ``csrc/hopper.cuh`` notes, not read from the wrapper);
- the kernel's arithmetic emulated in plain torch on those operands (three
  products of S, p split as the cell splits it, three products of P V
  against the permuted V^T, the cell's kv tile) against the JAX
  ``flash_attention`` in interpret mode at ``test_torch_flash_head_dims.py``'s
  f32 tolerance: max abs 2e-5 (unnormalized: l 1e-5 relative, o 2e-5 of its
  largest magnitude), K4 at head_dim 16, 32, 64, 112 and 128 ("vpu"), K3 at
  16, 64 and 112 with f32 and int8 QK^T, normalized and unnormalized;
- that the tolerance has teeth: on the same inputs a one-pass TF32 emulation
  (the hi parts alone) misses it.
The CUDA kernels are held against the plain versions on the card
(``chip_smoke.py`` phases 7 and 27, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aether_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from aether_tpu_torch.ops.flash_attention import (
    _TF32_KV_ORDER,
    _fixed_max_operands,
    _online_operands,
    _tf32_operands,
    _tf32_round,
    _tf32_split,
    _tf32_vt,
)

torch.set_num_threads(1)

TOL = 2e-5  # test_torch_flash_head_dims.py's f32 tolerance
LOW13 = 0x1FFF


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy().view(np.uint32)


def _reference_rna(x: np.ndarray) -> np.ndarray:
    """tf32 rounding of finite f32 values, from the value: the nearest
    multiple of 2**(e - 10) (e = the exponent of |x|, at least -126), ties
    away from zero, in float64 (exact for these values)."""
    x64 = x.astype(np.float64)
    mag = np.abs(x64)
    e = np.maximum(np.floor(np.log2(np.where(mag > 0, mag, 1.0))), -126.0)
    step = 2.0 ** (e - 10)
    q = np.floor(mag / step + 0.5) * step  # ties away from zero, on the magnitude
    return (np.sign(x64) * q).astype(np.float32)


def _special_values(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tiny = np.float32(np.finfo(np.float32).tiny)
    vals = [0.0, -0.0, 1.0, -1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,  # ties
            -(1.0 + 2.0 ** -11), 1.0 - 2.0 ** -24, 2.0 ** 127 * 1.5,
            float(tiny), float(tiny) * 0.75, 2.0 ** -149, 2.0 ** -140 * 3,  # subnormals
            3.0e38, -3.0e38, 1.0e-30, 12345.678]
    normal = rng.standard_normal(4000) * np.exp(rng.uniform(-60, 60, 4000))
    sub = rng.uniform(-1, 1, 500) * float(tiny)
    return np.concatenate([np.asarray(vals), normal, sub]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_round_is_rna_on_the_bits(seed):
    """``_tf32_round`` is round-to-nearest, ties away from zero, to a 10-bit
    mantissa, with the low 13 bits zero, on normal, subnormal, zero and large
    values; the split's hi and lo are tf32-exact and hi + lo holds x to
    2**-22 |x| (tf32's own subnormal step, 2**-136, bounds it below 2**-114)."""
    x = _special_values(seed)
    tx = torch.from_numpy(x)
    hi = _tf32_round(tx)
    assert (_bits(hi) & LOW13 == 0).all()
    finite = np.abs(x.astype(np.float64)) < (2.0 - 2.0 ** -11) * 2.0 ** 127  # no overflow
    np.testing.assert_array_equal(hi.numpy()[finite], _reference_rna(x[finite]))
    assert np.array_equal(np.signbit(hi.numpy()), np.signbit(x))  # -0 stays -0
    assert float(_tf32_round(torch.tensor([1.0 + 2.0 ** -11]))) == 1.0 + 2.0 ** -10  # a tie up
    assert float(_tf32_round(torch.tensor([-(1.0 + 2.0 ** -11)]))) == -(1.0 + 2.0 ** -10)
    shi, slo = _tf32_split(tx)
    assert torch.equal(shi, hi)
    assert (_bits(slo) & LOW13 == 0).all()
    x64 = x[finite].astype(np.float64)
    err = np.abs(x64 - shi.numpy()[finite].astype(np.float64) - slo.numpy()[finite])
    assert (err <= np.maximum(2.0 ** -22 * np.abs(x64), 2.0 ** -137)).all()
    normal = np.abs(x64) >= 2.0 ** -114
    assert (err[normal] <= 2.0 ** -22 * np.abs(x64[normal])).all()


def _fragment_kv_order():
    """The kv order V^T must have inside each group of 8 columns, from the
    fragment layouts (csrc/hopper.cuh): thread c = lane % 4 holds accumulator
    columns 2c + e % 2 in elements e; the tf32 A fragment's register r holds
    k = c + 4 (r // 2), and the cell feeds it accumulator element
    (0, 2, 1, 3)[r]."""
    order = [None] * 8
    for c in range(4):
        for r in range(4):
            order[c + 4 * (r // 2)] = 2 * c + (0, 2, 1, 3)[r] % 2
    return tuple(order)


@pytest.mark.parametrize("skv,kv_len", [(64, 64), (203, 170), (8, 1), (1000, 1000)])
def test_vt_permutation_round_trips(skv, kv_len):
    """V^T of ``_tf32_vt``: [BH, D, Skv8], the kv order of each group of 8
    the fragments' (``_TF32_KV_ORDER``); un-permuting gives V^T bit for bit,
    the columns past Skv are zero, and rows zeroed past kv_len (the
    wrapper's preparation) stay zero columns."""
    assert _TF32_KV_ORDER == _fragment_kv_order() == (0, 2, 4, 6, 1, 3, 5, 7)
    rng = np.random.default_rng(skv)
    v = torch.from_numpy(rng.standard_normal((3, skv, 16)).astype(np.float32))
    v[:, kv_len:] = 0
    vt = _tf32_vt(v)
    skv8 = -(-skv // 8) * 8
    assert vt.shape == (3, 16, skv8) and vt.is_contiguous()
    inverse = np.argsort(_TF32_KV_ORDER)
    idx = (np.arange(0, skv8, 8)[:, None] + inverse[None, :]).reshape(-1)
    back = vt[:, :, torch.from_numpy(idx)]
    assert torch.equal(back[:, :, :skv], v.transpose(1, 2))
    assert not back[:, :, kv_len:].any()
    hi, lo = _tf32_split(vt)
    assert (_bits(hi) & LOW13 == 0).all() and (_bits(lo) & LOW13 == 0).all()


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------


def _kv_tile(dim: int) -> int:
    return 64 if dim <= 64 else 32  # tf32x3_cell.cuh: Plan<D>::kBN


def _scores(t, one_pass: bool) -> torch.Tensor:
    """S of the cell, [BH, Sq, Skv] f32: Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T
    (tf32-exact operands: each product exact in f32, the sums f32)."""
    kt_hi, kt_lo = t.k_hi.transpose(1, 2), t.k_lo.transpose(1, 2)
    s = torch.matmul(t.q_hi, kt_hi)
    if not one_pass:
        s = s + torch.matmul(t.q_hi, kt_lo) + torch.matmul(t.q_lo, kt_hi)
    return s


def _pv(p: torch.Tensor, t, c0: int, kbn: int, one_pass: bool) -> torch.Tensor:
    """P V of one kv tile [c0, c0 + kbn): p [BH, Sq, kbn] in S's column order,
    split as the cell splits it and fed in the A fragments' order against the
    permuted V^T columns of the tile (TMA's zeros past Skv8)."""
    p_hi = _tf32_round(p)
    p_lo = _tf32_round(p - p_hi)
    cols = torch.arange(kbn)
    a_order = (cols // 8) * 8 + torch.tensor(_fragment_kv_order())[cols % 8]
    vt_hi = torch.zeros((*t.vt_hi.shape[:2], kbn))
    vt_lo = torch.zeros_like(vt_hi)
    width = min(kbn, t.vt_hi.shape[2] - c0)
    vt_hi[:, :, :width] = t.vt_hi[:, :, c0:c0 + width]
    vt_lo[:, :, :width] = t.vt_lo[:, :, c0:c0 + width]
    a_hi, a_lo = p_hi[:, :, a_order], p_lo[:, :, a_order]
    out = torch.matmul(a_hi, vt_hi.transpose(1, 2))
    if not one_pass:
        out = out + torch.matmul(a_hi, vt_lo.transpose(1, 2)) + torch.matmul(
            a_lo, vt_hi.transpose(1, 2))
    return out


def _tiles(s: torch.Tensor, kv_len: int, kbn: int):
    """S padded to whole kv tiles (TMA's zero rows of K score 0), the tiles
    that reach kv_len, each with its columns >= kv_len flagged."""
    pad = -(-s.shape[2] // kbn) * kbn
    s = torch.nn.functional.pad(s, (0, pad - s.shape[2]))
    for c0 in range(0, kv_len, kbn):
        col = torch.arange(c0, c0 + kbn)
        yield c0, s[:, :, c0:c0 + kbn], col >= kv_len


def emulate_k4(q, k, v, kv_valid=None, one_pass=False) -> torch.Tensor:
    """K4 f32 as the cell computes it, q/k/v [B, H, S, D] f32."""
    b, h, sq, dim = q.shape
    qf, kf, vf, kv_len = _online_operands(q, k, v, None, kv_valid)
    t = _tf32_operands(*(x.reshape(b * h, x.shape[2], dim) for x in (qf, kf, vf)))
    s_all, kbn = _scores(t, one_pass), _kv_tile(dim)
    m = torch.full((b * h, sq, 1), float("-inf"))
    l = torch.zeros((b * h, sq, 1))
    acc = torch.zeros((b * h, sq, dim))
    for c0, s, masked in _tiles(s_all, kv_len, kbn):
        s = s.masked_fill(masked, -0.7 * torch.finfo(torch.float32).max)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        m = m_next
        p = torch.exp2(s - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + _pv(p, t, c0, kbn, one_pass)
    out = acc * torch.where(l <= 0, torch.ones_like(l), 1.0 / l)
    return out.reshape(b, h, sq, dim)


def emulate_k3(q, k, v, *, kv_valid, qk_int8, score_bound=None, unnormalized=False,
               one_pass=False):
    """K3 f32 as the cell computes it: out, or (o, l) unnormalized."""
    b, h, sq, dim = q.shape
    ops = _fixed_max_operands(q, k, v, sm_scale=None, kv_valid=kv_valid, heads_per_cell=4,
                              noshift=False, qk_int8=qk_int8, pv_int8=False,
                              score_bound=score_bound, unnormalized=unnormalized)
    t = _tf32_operands(ops.q, ops.k, ops.v)
    g = torch.arange(b * h) // ops.hper
    if qk_int8:  # one exact s8 product, converted and scaled
        s_all = torch.matmul(t.q_hi.float(), t.k_hi.float().transpose(1, 2))
        s_all = s_all * ops.scale[g][:, None, None]
    else:
        s_all = _scores(t, one_pass)
    kbn = _kv_tile(dim)
    l = torch.zeros((b * h, sq, 1))
    acc = torch.zeros((b * h, sq, dim))
    for c0, s, masked in _tiles(s_all, ops.kv_len, kbn):
        p = torch.exp2(s - ops.shift[g][:, None, None]).masked_fill(masked, 0.0)
        l = l + p.sum(dim=-1, keepdim=True)
        acc = acc + _pv(p, t, c0, kbn, one_pass)
    if unnormalized:
        return acc.reshape(b, h, sq, dim), l.reshape(b, h, sq, 1)
    out = acc * torch.where(l <= 0, torch.ones_like(l), 1.0 / l)
    return out.reshape(b, h, sq, dim)


def _inputs(q_shape, kv_shape, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (q_shape, kv_shape, kv_shape)]
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _max_err(out, ref) -> float:
    return float(np.abs(out.numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())


# K4 f32: (B, H, S), kv_valid; 128 takes "vpu" (the JAX wrapper forces it)
K4_CASES = [(16, (1, 2, 203), 170), (32, (2, 2, 130), None), (64, (1, 3, 200), 190),
            (112, (1, 2, 150), 141), (128, (1, 2, 131), None)]


@pytest.mark.parametrize("hd,bhs,kv_valid", K4_CASES)
def test_emulated_k4_matches_pallas_interpret(hd, bhs, kv_valid):
    """K4 f32's 3xTF32 arithmetic against the Pallas kernel in interpret mode
    at 2e-5; one pass of TF32 misses it."""
    (jq, jk, jv), (tq, tk, tv) = _inputs((*bhs, hd), (*bhs, hd), hd + sum(bhs))
    ref = jax_flash_attention(jq, jk, jv, block_q=128, block_k=128, kv_valid=kv_valid,
                              denom="vpu" if hd >= 128 else "mxu", fixed_max=False,
                              interpret=True)
    err = _max_err(emulate_k4(tq, tk, tv, kv_valid), ref)
    assert err <= TOL, err
    one = _max_err(emulate_k4(tq, tk, tv, kv_valid, one_pass=True), ref)
    assert one > TOL, one


K3_CASES = [(hd, qk_int8, unnormalized) for hd in (16, 64, 112) for qk_int8 in (False, True)
            for unnormalized in (False, True)]


@pytest.mark.parametrize("hd,qk_int8,unnormalized", K3_CASES)
def test_emulated_k3_matches_pallas_interpret(hd, qk_int8, unnormalized):
    """K3 f32's arithmetic (3xTF32 QK^T or the exact int8 product, 3xTF32
    P V) against the Pallas kernel in interpret mode: 130 q rows against 203
    kv rows, 190 valid; normalized at 2e-5, unnormalized with a shared score
    bound at l 1e-5 relative and o 2e-5 of its largest magnitude. One pass of
    TF32 misses the bar."""
    (jq, jk, jv), (tq, tk, tv) = _inputs((1, 3, 130, hd), (1, 3, 203, hd), 7 * hd + qk_int8)
    kw = dict(kv_valid=190, qk_int8=qk_int8)
    if unnormalized:
        kw.update(score_bound=30.0, unnormalized=True)
    ref = jax_flash_attention(jq, jk, jv, block_q=128, block_k=128, fixed_max=True,
                              interpret=True, **kw)
    got = emulate_k3(tq, tk, tv, **kw)
    one = emulate_k3(tq, tk, tv, one_pass=True, **kw)
    if not unnormalized:
        assert _max_err(got, ref) <= TOL, _max_err(got, ref)
        assert _max_err(one, ref) > TOL
        return
    (o, l), (jo, jl), (one_o, _) = got, ref, one
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-5)
    bar = TOL * float(np.abs(np.asarray(jo)).max())
    assert _max_err(o, jo) <= bar, (_max_err(o, jo), bar)
    assert _max_err(one_o, jo) > bar

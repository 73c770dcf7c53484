"""The arithmetic of K4's wide f32 kernel (head_dim above 256), on the CPU.

Above 256 ``csrc/flash_online_wide.cu`` runs K4 in f32 with the width at
run time: q, k and v zero-padded to the next multiple of 64 and split into
their 3xTF32 operands by the wrapper (``_online_kernel_operands``, then
``_tf32_operands``). A CUDA kernel cannot run here, so this file emulates
its summation order in plain torch on those operands:
- S of a kv tile summed over head-dim panels of 32 columns in order, each
  panel the three TF32 products Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T;
- kv tiles of 64 columns: the running max, p = exp2(s - m), its split into
  P_hi and P_lo, the row sums of unrounded p ("vpu");
- each tile's P V in fresh registers (three TF32 products against the
  kv-permuted V^T of the tile), added into the output on the FMA units, o =
  alpha o + P V: the output columns are independent, so the kernel's column
  blocks of 128 and its two 64-column chains are one product here.
It is held against the JAX ``flash_attention`` in interpret mode at
``tests/test_torch_tf32x3.py``'s f32 tolerance, max abs 2e-5, at head_dim
257, 320, 384 and 512, with ``kv_valid`` inside a tile, Sq != Skv and B*H
odd; on the same inputs a one-pass TF32 emulation (the hi parts alone)
misses it. The CUDA kernel is held against the plain version on the card
(``chip_smoke.py`` phase 30, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from aether_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from aether_tpu_torch.ops import flash_attention as fa
from test_torch_tf32x3 import TOL, _inputs, _max_err, _pv, _tiles

torch.set_num_threads(1)

KV_TILE, PANEL = 64, 32  # csrc/flash_online_wide.cu: kBN, kPanel


def _panel_scores(t, one_pass: bool) -> torch.Tensor:
    """S, [BH, Sq, Skv] f32: the panels' three TF32 products added in
    head-dim order (tf32-exact operands: each product exact in f32)."""
    s = None
    for c0 in range(0, t.q_hi.shape[-1], PANEL):
        cols = slice(c0, c0 + PANEL)
        kt_hi = t.k_hi[..., cols].transpose(1, 2)
        part = torch.matmul(t.q_hi[..., cols], kt_hi)
        if not one_pass:
            part = (part + torch.matmul(t.q_hi[..., cols], t.k_lo[..., cols].transpose(1, 2))
                    + torch.matmul(t.q_lo[..., cols], kt_hi))
        s = part if s is None else s + part
    return s


def emulate_wide(q, k, v, kv_valid=None, one_pass=False) -> torch.Tensor:
    """K4 f32 above 256 as ``flash_online_wide.cu`` computes it, q [B, H, Sq,
    D] and k/v [B, H, Skv, D] f32 -> [B, H, Sq, D]."""
    b, h, sq, dim = q.shape
    qh, kh, vh, kv_len, fold = fa._online_kernel_operands(q, k, v, None, kv_valid)
    width = qh.shape[-1]
    assert width > 256 and width % 64 == 0
    t = fa._tf32_operands((qh * fold).to(qh.dtype), kh, vh)
    s_all = _panel_scores(t, one_pass)
    m = torch.full((b * h, sq, 1), float("-inf"))
    l = torch.zeros((b * h, sq, 1))
    acc = torch.zeros((b * h, sq, width))
    for c0, s, masked in _tiles(s_all, kv_len, KV_TILE):
        s = s.masked_fill(masked, -0.7 * torch.finfo(torch.float32).max)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        m = m_next
        p = torch.exp2(s - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + _pv(p, t, c0, KV_TILE, one_pass)
    out = acc * torch.where(l <= 0, torch.ones_like(l), 1.0 / l)
    return out[..., :dim].reshape(b, h, sq, dim)


# head_dim, (B, H, Sq), (B, H, Skv), kv_valid
CASES = [(257, (1, 3, 130), (1, 3, 203), 170), (320, (1, 2, 150), (1, 2, 150), 141),
         (384, (1, 3, 100), (1, 3, 130), None), (512, (1, 2, 131), (1, 2, 131), 120)]


@pytest.mark.parametrize("hd,q_bhs,kv_bhs,kv_valid", CASES)
def test_emulated_wide_kernel_matches_pallas_interpret(hd, q_bhs, kv_bhs, kv_valid):
    """The wide kernel's 3xTF32 arithmetic against the Pallas kernel in
    interpret mode ("vpu", forced at head_dim >= 128) at 2e-5; one pass of
    TF32 misses it; the plain version agrees too."""
    (jq, jk, jv), (tq, tk, tv) = _inputs((*q_bhs, hd), (*kv_bhs, hd), hd + sum(q_bhs))
    ref = jax_flash_attention(jq, jk, jv, block_q=128, block_k=128, kv_valid=kv_valid,
                              denom="vpu", fixed_max=False, interpret=True)
    got = emulate_wide(tq, tk, tv, kv_valid)
    err = _max_err(got, ref)
    assert err <= TOL, err
    one = _max_err(emulate_wide(tq, tk, tv, kv_valid, one_pass=True), ref)
    assert one > TOL, one
    plain = fa.flash_attention_plain(tq, tk, tv, kv_valid=kv_valid, block_q=128, block_k=128)
    assert float(np.abs(plain.numpy() - got.numpy()).max()) <= TOL

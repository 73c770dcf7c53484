"""K4 in f32 at head_dim 129-256, its CTA pair's summation order, on the CPU.

From 129 to 256 ``csrc/flash_online_wide.cu`` runs K4 in f32 (the widths
160, 192, 224 and 256) on a pair of CTAs a 128-row q tile, in the place of
``tf32x3_cell.cuh``'s ``split_kernel`` (64 q rows a CTA, 16-row kv tiles).
A CUDA kernel cannot run here, so this file emulates the pair's summation
order in plain torch on the operands the wrapper hands it
(``_online_kernel_operands``: zero-padded to the width, the fold of the true
D; then ``_tf32_operands``), as ``test_torch_tf32x3_wide.py``'s emulation of
the kernel does:
- S in two parts by ``_wide_plan``'s 32-column units (160: 96 + 64, 192: 96
  + 96, 224: 128 + 96, 256: 128 + 128): each CTA sums the three TF32
  products (Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T) over the 32-column
  panels of its slice in order, and the parts meet in rank order, S = S_0
  + S_1 in f32;
- kv tiles of 32 columns: the running max, p = exp2(s - m), its split into
  P_hi and P_lo, the row sums of unrounded p ("vpu");
- each tile's P V per output slice (the CTA's rows of V^T; three TF32
  products against the kv-permuted V^T of the tile) in fresh registers,
  added into the output on the FMA units, o = alpha o + P V: the output
  columns are independent, so a slice's chains (64 + 64, 32 + 64, 64) are
  one product here.
It is held against the JAX ``flash_attention`` in interpret mode at
``tests/test_torch_tf32x3.py``'s f32 tolerance, max abs 2e-5, at head_dim
136 (on the width 160), 160, 200 (on 224) and 256, with ``kv_valid`` inside
a tile, Sq != Skv and B*H odd; on the same inputs a one-pass TF32 emulation
(the hi parts alone) misses it. The CUDA kernel is held against the plain
version on the card (``chip_smoke.py`` phase 29,
``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from aether_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from aether_tpu_torch.ops import flash_attention as fa
from test_torch_tf32x3 import TOL, _inputs, _max_err
from test_torch_tf32x3_wide import KV_TILE, emulate_wide

torch.set_num_threads(1)


def emulate_split(q, k, v, kv_valid=None, one_pass=False) -> torch.Tensor:
    """K4 f32 at 129-256 as the CTA pair computes it (``emulate_wide`` on
    the pair's plan), q [B, H, Sq, D] and k/v [B, H, Skv, D] f32 -> [B, H,
    Sq, D]."""
    width = fa.head_dim_width(q.shape[-1])
    assert width in (160, 192, 224, 256) and KV_TILE == 32
    plan = fa._wide_plan(width, torch.float32)
    assert plan.cluster == 2 and plan.groups == 1 and min(plan.score_cols) >= 64
    return emulate_wide(q, k, v, kv_valid, one_pass)


# head_dim, (B, H, Sq), (B, H, Skv), kv_valid
CASES = [(136, (1, 3, 130), (1, 3, 203), 170), (160, (1, 2, 150), (1, 2, 150), 141),
         (200, (1, 3, 100), (1, 3, 130), None), (256, (1, 2, 131), (1, 2, 131), 120)]


@pytest.mark.parametrize("hd,q_bhs,kv_bhs,kv_valid", CASES)
def test_emulated_split_plan_matches_pallas_interpret(hd, q_bhs, kv_bhs, kv_valid):
    """The split plan's 3xTF32 arithmetic against the Pallas kernel in
    interpret mode ("vpu", forced at head_dim >= 128) at 2e-5; one pass of
    TF32 misses it."""
    (jq, jk, jv), (tq, tk, tv) = _inputs((*q_bhs, hd), (*kv_bhs, hd), hd + sum(q_bhs))
    ref = jax_flash_attention(jq, jk, jv, block_q=128, block_k=128, kv_valid=kv_valid,
                              denom="vpu", fixed_max=False, interpret=True)
    got = emulate_split(tq, tk, tv, kv_valid)
    err = _max_err(got, ref)
    assert err <= TOL, err
    one = _max_err(emulate_split(tq, tk, tv, kv_valid, one_pass=True), ref)
    assert one > TOL, one
    # the plain version, which the card's kernel is held against, agrees too
    plain = fa.flash_attention_plain(tq, tk, tv, kv_valid=kv_valid, block_q=128, block_k=128)
    assert float(np.abs(plain.numpy() - got.numpy()).max()) <= TOL

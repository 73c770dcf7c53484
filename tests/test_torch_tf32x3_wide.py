"""The arithmetic of K4's wide f32 kernel (head_dim above 128), on the CPU.

Above 128 ``csrc/flash_online_wide.cu`` runs K4 in f32 with the width at
run time: q, k and v zero-padded to the next multiple of 32 up to 256 (of 64
above) and split into their 3xTF32 operands by the wrapper
(``_online_kernel_operands``, then ``_tf32_operands``). A thread-block
cluster of CTAs splits the head dim of each q tile (``_wide_plan``: a pair
in 32-column units up to 256). A CUDA kernel cannot run here, so this file
emulates its summation order in plain torch on those operands:
- each rank's part of S of a kv tile over its slice of the head dim: panels
  of 32 columns in order, each the three TF32 products Q_hi K_hi^T + Q_hi
  K_lo^T + Q_lo K_hi^T, summed in chunks of at most 128 columns (on the
  tensor cores), the chunks added in order (on the FMA units);
- the parts added in rank order (the cluster's exchange), so every CTA
  holds the same S;
- kv tiles of 32 columns: the running max, p = exp2(s - m), its split into
  P_hi and P_lo, the row sums of unrounded p ("vpu");
- each tile's P V in fresh registers (three TF32 products against the
  kv-permuted V^T rows of a CTA's output slice), added into the output on
  the FMA units, o = alpha o + P V, the output columns taken slice by slice.
It is held against the JAX ``flash_attention`` in interpret mode at
``tests/test_torch_tf32x3.py``'s f32 tolerance, max abs 2e-5, at head_dim
257, 320, 384 and 512, with ``kv_valid`` inside a tile, Sq != Skv and B*H
odd; on the same inputs a one-pass TF32 emulation (the hi parts alone)
misses it (``test_torch_tf32x3_split.py`` holds it so at 129-256).
``_wide_plan`` itself (cluster size, slices, clusters along y) is pinned for
both dtypes. The CUDA kernel is held against the plain
version on the card (``chip_smoke.py`` phase 30, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from aether_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from aether_tpu_torch.ops import flash_attention as fa
from test_torch_tf32x3 import TOL, _inputs, _max_err, _pv, _tiles

torch.set_num_threads(1)

KV_TILE, PANEL, GROUP = 32, 32, 128  # csrc/flash_online_wide.cu: kBN, kPanel, kC


def _panel_scores(t, c0: int, width: int, one_pass: bool) -> torch.Tensor:
    """[BH, Sq, Skv] f32: the three TF32 products of the panels of head-dim
    columns [c0, c0 + width) added in order (tf32-exact operands: each
    product exact in f32)."""
    s = None
    for p0 in range(c0, c0 + width, PANEL):
        cols = slice(p0, p0 + PANEL)
        kt_hi = t.k_hi[..., cols].transpose(1, 2)
        part = torch.matmul(t.q_hi[..., cols], kt_hi)
        if not one_pass:
            part = (part + torch.matmul(t.q_hi[..., cols], t.k_lo[..., cols].transpose(1, 2))
                    + torch.matmul(t.q_lo[..., cols], kt_hi))
        s = part if s is None else s + part
    return s


def _cluster_scores(t, plan, one_pass: bool) -> torch.Tensor:
    """S as a cluster sums it: each rank's slice in chunks of at most 128
    columns added in order, the ranks' parts added in rank order."""
    s, c0 = None, 0
    for width in plan.score_cols:
        part = None
        for g0 in range(c0, c0 + width, GROUP):
            group = _panel_scores(t, g0, min(GROUP, c0 + width - g0), one_pass)
            part = group if part is None else part + group
        s = part if s is None else s + part
        c0 += width
    return s


def emulate_wide(q, k, v, kv_valid=None, one_pass=False) -> torch.Tensor:
    """K4 f32 above 128 as ``flash_online_wide.cu`` computes it, q [B, H, Sq,
    D] and k/v [B, H, Skv, D] f32 -> [B, H, Sq, D]."""
    b, h, sq, dim = q.shape
    qh, kh, vh, kv_len, fold = fa._online_kernel_operands(q, k, v, None, kv_valid)
    width = qh.shape[-1]
    assert width > 128 and width % (32 if width <= 256 else 64) == 0
    t = fa._tf32_operands((qh * fold).to(qh.dtype), kh, vh)
    plan = fa._wide_plan(width, torch.float32)
    s_all = _cluster_scores(t, plan, one_pass)
    slices, c0 = [], 0
    for cols in plan.out_cols:  # each CTA's V^T rows and output columns
        slices.append(t._replace(vt_hi=t.vt_hi[:, c0:c0 + cols], vt_lo=t.vt_lo[:, c0:c0 + cols]))
        c0 += cols
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
        pv = torch.cat([_pv(p, ts, c0, KV_TILE, one_pass) for ts in slices], dim=-1)
        acc = alpha * acc + pv
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


# width: (cluster, clusters along y, S's columns by rank, output columns by CTA)
# in bf16 (slices of at most 256) and f32 (at most 128; a pair in 32-column
# units from 160 to 256)
_PLANS = {
    (160, torch.float32): (2, 1, (96, 64), (96, 64)),
    (192, torch.float32): (2, 1, (96, 96), (96, 96)),
    (224, torch.float32): (2, 1, (128, 96), (128, 96)),
    (256, torch.float32): (2, 1, (128, 128), (128, 128)),
    (320, torch.bfloat16): (2, 1, (192, 128), (192, 128)),
    (384, torch.bfloat16): (2, 1, (192, 192), (192, 192)),
    (512, torch.bfloat16): (2, 1, (256, 256), (256, 256)),
    (576, torch.bfloat16): (3, 1, (192,) * 3, (192,) * 3),
    (1024, torch.bfloat16): (4, 1, (256,) * 4, (256,) * 4),
    (2048, torch.bfloat16): (8, 1, (256,) * 8, (256,) * 8),
    (2112, torch.bfloat16): (8, 2, (320,) + (256,) * 7, (192,) + (128,) * 15),
    (4096, torch.bfloat16): (8, 2, (512,) * 8, (256,) * 16),
    (320, torch.float32): (3, 1, (128, 128, 64), (128, 128, 64)),
    (384, torch.float32): (3, 1, (128,) * 3, (128,) * 3),
    (512, torch.float32): (4, 1, (128,) * 4, (128,) * 4),
    (576, torch.float32): (5, 1, (128,) * 4 + (64,), (128,) * 4 + (64,)),
    (1024, torch.float32): (8, 1, (128,) * 8, (128,) * 8),
    (2048, torch.float32): (8, 2, (256,) * 8, (128,) * 16),
    (2112, torch.float32): (8, 3, (320,) + (256,) * 7, (128,) * 9 + (64,) * 15),
    (4096, torch.float32): (8, 4, (512,) * 8, (128,) * 32),
}


@pytest.mark.parametrize("dp,dtype", list(_PLANS), ids=[f"{dp}-{str(dt)[6:]}" for dp, dt in _PLANS])
def test_wide_plan(dp, dtype):
    """The wide kernels' cluster plan: at most 8 CTAs a cluster split S's head
    dim in slices of at most 256 (bf16) / 128 (f32) columns, evenly in
    64-column units (f32 at 160-256: a pair in 32-column units), first slices
    the wider; above 8 slices, clusters along y each compute S and share the
    output columns, at most one slice each."""
    plan = fa._wide_plan(dp, dtype)
    assert plan == _PLANS[dp, dtype]
    top = 256 if dtype == torch.bfloat16 else 128
    unit = 32 if dp <= 256 else 64
    assert sum(plan.score_cols) == dp == sum(plan.out_cols)
    assert len(plan.score_cols) == plan.cluster <= 8
    assert len(plan.out_cols) == plan.cluster * plan.groups
    assert max(plan.out_cols) <= top and min(plan.out_cols) >= 64
    assert all(c % unit == 0 for c in plan.score_cols + plan.out_cols)
    assert (plan.groups == 1) == (max(plan.score_cols) <= top)
    assert plan.score_cols == tuple(sorted(plan.score_cols, reverse=True))


@pytest.mark.parametrize("dp", [64, 128, 300])
def test_wide_plan_refuses_other_widths(dp):
    with pytest.raises(ValueError):
        fa._wide_plan(dp, torch.float32)

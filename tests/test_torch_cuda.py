"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present (a CPU-only
machine). ``chip_smoke.py`` checks the kernels at the main-path shapes; these
cases cover the edges it does not reach. K1/K2, int8 and float
(``AETHER_ATTN_QK8=0``): batch > 1, head groups that straddle two batch
elements, several token tiles with a ragged ``s_valid``, no RoPE, RoPE tables
shorter than the sequence; K1 and K2 at every other head dim they take (16
to 112 in steps of 16, and head dims between them on the next width's
instance: 2, 8, 24, 72, 120, 126), each noshift, and head dims outside that
range refused. K1's cluster form besides, at 64 and at 16, 48, 80 and 112: a
cluster of 8 with S_in < s_pad, clusters of 3 and 6, hper 3 and 4
straddling batch elements, tables shorter than s_valid, no RoPE, codes
inside [-127, 127], two launches bit-identical, one launch a call on its
head dim's counter, and head groups above 4, tiles above 1024 and unaligned
row strides refused; at 64 on bf16 inputs every output but the row-norm
maxima bit for bit the plain version's. K4 f32 at 128 over 15076 keys at
mean 1e-7 / max 3e-6. K4: batch 2, sequences that
are not a multiple of the 64-row tile, ``kv_valid``, q and kv of different
lengths, extreme negative scores with padding, both denominators, f32 and
bf16, and ``flash_attention_trainable``'s gradients. K3 and K6: lengths that
are not a multiple of 64, ``kv_valid``, Sq != Skv, K3's unnormalized mode
with a score bound, B*H odd (head groups of 3 or 1), int8 and bf16 QK^T, K6
over several kv spans and with a negative row max behind padding. K2 and K3
on their fixed-shift cell (192-row CTAs of 64-row warpgroups, 128-column kv
tiles): Sq not a multiple of 192 and Sq != Skv, kv_valid inside a tile and
tiles wholly past it, hper 1, 2 and 4, K3 unnormalized on ragged tiles, K2
over several quantization blocks (the warpgroups of one CTA reading
different q scales) and with each ``noshift``, strided or mismatched
operands refused with ``ValueError``, and repeats bit-identical. K5: T*H*W
not a multiple of the vector, unaligned rows, B 1 and 2, C from 12 to 512,
f32/bf16/f16, NCTHW and channels-last, a large-mean group, bit-identical
repeats, and the VAE's ``group_norm`` through it. K7-K9 (on K4 bf16's wgmma
cell): both K layouts, K^T rows not a multiple of 8 (padded for TMA), the
last-block and every-block masks, hper 1 to 16 with lcm padding (the ring
running across heads, full rounds and a last round split by head), the four
``flash_x`` modes, padfix pads across several 128-column tiles and JAX kv
blocks, lengths the 128- and 192-row tiles do not divide, a non-default
sm_scale folded in the kernel, deeply negative scores with padfix, and the
switch combinations no wrapper reaches refused. The wgmma kernels (K4
bf16, K6) besides: lengths their 128-row tiles do not divide, kv_valid inside
a tile and on its edge, kv shorter than one ring slot, spans of 128, 256 and
1024 with one that kv_valid empties, strided inputs, and repeats
bit-identical. K3, K4 and K6 at head dims below their instance's width (1,
8, 17, 24, 72, 120, 127; K4 also 128) on zero-padded operands. K4 above
128 (the instances 160, 192, 224 and 256, and 144 and 200 on padded
operands), bf16 and f32, through the same cases; at every one of the four
widths the edges of its cells (64-row kv tiles in bf16; in f32 a pair of
CTAs a 128-row q tile, 32-row kv tiles): kv_valid inside a tile, Sq not a
multiple of 128, kv shorter than one ring slot, one valid column; in f32 at
every head dim 129-256 besides the edges of the pair (a q tile or one
warpgroup's rows partly or wholly empty, kv_valid inside a tile and on its
edge, kv shorter than a ring slot, B*H odd) on strided inputs, and both
CTAs holding the same scores bit for bit. K4 above 256 (the wide
kernels, the width a run-time multiple of 64: 257, 272, 320, 384, 512 and
1000), bf16 and f32, through the same edges, Sq != Skv, B*H odd, extreme
negative scores on strided inputs, and f32 at 512 over 15076 keys at mean
1e-7 / max 3e-6; the edges of their thread-block clusters (uneven slices at
257 and 320, bf16 2304 and f32 1088 beyond one cluster, on strided inputs)
and every slice holding the same scores bit for bit. Also the launch-or-raise contract. The card's machine has no
JAX, so run them without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import math

import pytest
import torch

from aether_tpu_torch.ops.attn_prologue import (
    fused_joint_attention,
    qkv_prologue,
    qkv_prologue_plain,
)
from aether_tpu_torch.ops import flash_variants as fv
from aether_tpu_torch.ops.chunked_attention import flash_attention_trainable
from aether_tpu_torch.ops.flash_attention import (
    _online_bf16_launch,
    _online_kernel_operands,
    _wide_plan,
    attention_reference,
    flash_attention,
    flash_attention_f32_hd,
    flash_attention_fixed_max,
    flash_attention_fixed_max_f32,
    flash_attention_fixed_max_hd,
    flash_attention_fixed_max_plain,
    flash_attention_hd,
    flash_attention_plain,
    flash_attention_prepacked,
    flash_attention_prepacked_plain,
    flash_attention_pv8,
    flash_attention_pv8_hd,
    flash_attention_pv8_plain,
    head_dim_width,
)

pytestmark = pytest.mark.cuda

HD = 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, s, nh, rope_rows, seed=0, hd=HD):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d = nh * hd
    y = torch.randn((b, s, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
    xs = (y[..., :d], y[..., d:2 * d], y[..., 2 * d:])
    norms = [1.0 + 0.1 * torch.randn(hd, generator=gen, device=dev),
             0.1 * torch.randn(hd, generator=gen, device=dev),
             1.0 + 0.1 * torch.randn(hd, generator=gen, device=dev),
             0.1 * torch.randn(hd, generator=gen, device=dev)]
    if rope_rows:
        ang = torch.randn((rope_rows, hd // 2), generator=gen, device=dev)
        rope = (ang.cos().repeat_interleave(2, -1), ang.sin().repeat_interleave(2, -1))
    else:
        rope = (None, None)
    return xs, norms, rope


# (batch, tokens, heads, s_valid, rope rows)
CASES = [
    (2, 300, 4, None, 300),     # the CPU tests' shape, one 384-row tile
    (2, 300, 3, 250, 300),      # hper 3: groups straddle the two batches
    (1, 1700, 2, 1650, 1600),   # two 1024-token tiles, tables short of s
    (1, 1700, 4, None, 0),      # no RoPE
]


@pytest.mark.parametrize("b,s,nh,s_valid,rope_rows", CASES)
def test_prologue_kernel_matches_plain(dev, b, s, nh, s_valid, rope_rows):
    xs, norms, rope = _inputs(dev, b, s, nh, rope_rows)
    kw = dict(num_heads=nh, head_dim=HD, eps=1e-6, s_valid=s_valid)
    got = qkv_prologue(*xs, *norms, *rope, **kw)
    ref = qkv_prologue_plain(*xs, *norms, *rope, **kw)
    torch.cuda.synchronize()
    assert got[7] == ref[7]
    for a, r in zip(got[:2], ref[:2]):
        diff = (a.int() - r.int()).abs()
        assert diff.max().item() <= 1
        assert (diff > 0).float().mean().item() <= 1e-3
    assert torch.equal(got[2], ref[2])
    for a, r in zip(got[3:7], ref[3:7]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=0)


@pytest.mark.parametrize("b,s,nh,s_valid,rope_rows", CASES)
def test_flash_kernel_matches_plain(dev, b, s, nh, s_valid, rope_rows):
    xs, norms, rope = _inputs(dev, b, s, nh, rope_rows, seed=1)
    q, k, v, qsc, qn, ksc, kn, _ = qkv_prologue(
        *xs, *norms, *rope, num_heads=nh, head_dim=HD, eps=1e-6, s_valid=s_valid)
    kw = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=s_valid or s)
    out = flash_attention_prepacked(q, k, v, **kw)
    ref = flash_attention_prepacked_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-3


def _bf16_ulps(a, b):
    """|a - b| in bf16 ulps of the larger magnitude, 2**(floor(log2 x) - 7);
    0 where the two are equal."""
    a, b = a.float(), b.float()
    top = torch.maximum(a.abs(), b.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return torch.where(a == b, torch.zeros_like(a), (a - b).abs() / ulp)


@pytest.mark.parametrize("b,s,nh,s_valid,rope_rows", CASES)
def test_prologue_float_kernel_matches_plain(dev, b, s, nh, s_valid, rope_rows):
    """quantize=False: bf16 q (z * fold) and k (z) within one bf16 ulp on at
    most 1e-4 of the elements (the moments are taken in double on both
    sides), v bit-exact, the stats to 1e-5."""
    xs, norms, rope = _inputs(dev, b, s, nh, rope_rows, seed=2)
    kw = dict(num_heads=nh, head_dim=HD, eps=1e-6, s_valid=s_valid, quantize=False)
    before = qkv_prologue.launches
    got = qkv_prologue(*xs, *norms, *rope, **kw)
    ref = qkv_prologue_plain(*xs, *norms, *rope, **kw)
    torch.cuda.synchronize()
    assert qkv_prologue.launches == before + 1
    assert got[7] == ref[7]
    for a, r in zip(got[:2], ref[:2]):
        assert a.dtype == r.dtype == torch.bfloat16 and a.shape == r.shape
        ulps = _bf16_ulps(a, r)
        assert ulps.max().item() <= 1
        assert (ulps > 0).float().mean().item() <= 1e-4
    assert torch.equal(got[2], ref[2])
    for a, r in zip(got[3:7], ref[3:7]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=0)


@pytest.mark.parametrize("b,s,nh,s_valid,rope_rows", CASES)
def test_flash_float_kernel_matches_plain(dev, b, s, nh, s_valid, rope_rows):
    """K2 on K1's float (bf16) operands: bf16 QK^T, max 1e-2, mean 1e-3."""
    xs, norms, rope = _inputs(dev, b, s, nh, rope_rows, seed=3)
    q, k, v, qsc, qn, ksc, kn, _ = qkv_prologue(
        *xs, *norms, *rope, num_heads=nh, head_dim=HD, eps=1e-6, s_valid=s_valid,
        quantize=False)
    assert q.dtype == k.dtype == torch.bfloat16
    kw = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=s_valid or s)
    before = flash_attention_prepacked.launches
    out = flash_attention_prepacked(q, k, v, **kw)
    ref = flash_attention_prepacked_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_prepacked.launches == before + 1
    err = (out.float() - ref.float()).abs()
    assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-3


# K1 as one HBM pass over thread-block clusters (block / 128 CTAs a
# quantization cell): (batch, tokens S_in, heads, s_valid, rope rows)
K1_CLUSTER_CASES = [
    (1, 3000, 4, 2900, 3000),   # block 1024, a cluster of 8; S_in < s_pad (3072)
    (3, 300, 5, 290, 300),      # hper 3: head groups straddle batch elements
    (2, 700, 6, 650, 700),      # hper 4: groups straddle; block 768, clusters of 6
    (2, 1500, 4, 1400, 1000),   # RoPE tables shorter than s_valid
    (1, 5000, 4, 4800, 0),      # no RoPE; five 1024-token tiles
]


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("b,s,nh,s_valid,rope_rows", K1_CLUSTER_CASES)
def test_prologue_cluster_kernel(dev, b, s, nh, s_valid, rope_rows, quantize):
    """Against the plain version (int8 codes within 1 on at most 1e-3 of them
    and inside [-127, 127]; bf16 within one ulp on at most 1e-4; v
    bit-exact; the stats to 1e-5), two launches bit-identical, one launch a
    call."""
    _check_cluster(dev, b, s, nh, s_valid, rope_rows, quantize, HD)


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("b,s,nh,s_valid,rope_rows", K1_CLUSTER_CASES)
@pytest.mark.parametrize("hd", [16, 48, 80, 112])
def test_prologue_cluster_kernel_hd(dev, hd, b, s, nh, s_valid, rope_rows, quantize):
    """The same cluster cases at other head dims (two lanes of 8 columns a
    row at 16, eight of 6, 10 and 14 at 48, 80 and 112), counted on
    ``qkv_prologue_hd``."""
    _check_cluster(dev, b, s, nh, s_valid, rope_rows, quantize, hd)


def _check_cluster(dev, b, s, nh, s_valid, rope_rows, quantize, hd):
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue_hd

    xs, norms, rope = _inputs(dev, b, s, nh, rope_rows, seed=4, hd=hd)
    kw = dict(num_heads=nh, head_dim=hd, eps=1e-6, s_valid=s_valid, quantize=quantize)
    counter, other = ((qkv_prologue, qkv_prologue_hd) if hd == HD
                      else (qkv_prologue_hd, qkv_prologue))
    before, before_other = counter.launches, other.launches
    got = qkv_prologue(*xs, *norms, *rope, **kw)
    again = qkv_prologue(*xs, *norms, *rope, **kw)
    ref = qkv_prologue_plain(*xs, *norms, *rope, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 2 and other.launches == before_other
    assert got[7] == ref[7]
    assert all(torch.equal(a, c) for a, c in zip(got[:7], again[:7]))
    for a, r in zip(got[:2], ref[:2]):
        assert a.dtype == r.dtype and a.shape == r.shape
        if quantize:
            assert a.min().item() >= -127 and a.max().item() <= 127
            diff = (a.int() - r.int()).abs()
            assert diff.max().item() <= 1
            assert (diff > 0).float().mean().item() <= 1e-3
        else:
            ulps = _bf16_ulps(a, r)
            assert ulps.max().item() <= 1
            assert (ulps > 0).float().mean().item() <= 1e-4
    assert torch.equal(got[2], ref[2])
    for a, r in zip(got[3:7], ref[3:7]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=0)


def test_prologue_refuses_what_it_does_not_take(dev):
    """Head groups above 4, token tiles above 1024 (clusters above 8) and
    rows whose byte stride TMA cannot take raise ``ValueError``."""
    xs, norms, rope = _inputs(dev, 1, 300, 8, 300)
    kw = dict(num_heads=8, head_dim=HD, eps=1e-6)
    with pytest.raises(ValueError, match="head groups"):
        qkv_prologue(*xs, *norms, *rope, heads_per_cell=8, **kw)
    xl, nl, rl = _inputs(dev, 1, 5000, 2, 5000)
    with pytest.raises(ValueError, match="token tiles"):
        qkv_prologue(*xl, *nl, *rl, num_heads=2, head_dim=HD, eps=1e-6, block_q=2048)
    d = 8 * HD
    y = torch.randn((1, 300, 3 * d + 1), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        qkv_prologue(y[..., :d], y[..., d:2 * d], y[..., 2 * d:3 * d], *norms, *rope, **kw)


def test_fused_attention_counts_and_refuses_float_mode(dev):
    """Both branches launch K1 and K2 once each; the float branch
    (quantize=False) runs on the card now, and K2 refuses q/k of any dtype
    but int8 or bf16."""
    xs, norms, rope = _inputs(dev, 1, 300, 4, 300)
    kw = dict(num_heads=4, head_dim=HD, eps=1e-6)
    for quantize in (True, False):
        before = (qkv_prologue.launches, flash_attention_prepacked.launches)
        out = fused_joint_attention(*xs, *norms, *rope, quantize=quantize, **kw)
        assert out.shape == (1, 300, 4 * HD) and out.dtype == torch.bfloat16
        assert (qkv_prologue.launches - before[0],
                flash_attention_prepacked.launches - before[1]) == (1, 1)
    q, k, v, qsc, qn, ksc, kn, _ = qkv_prologue(*xs, *norms, *rope, quantize=False, **kw)
    with pytest.raises(TypeError, match="K2"):
        flash_attention_prepacked(q.half(), k.half(), v, qsc=qsc, ksc=ksc, qn=qn, kn=kn)


def _bf16_gates(ref):
    """(max, mean) abs-error gates for a bf16 result, as chip_smoke.py's
    ``bf16_gates``: two bf16 ulps of its scale, 2 * 2**(floor(log2
    max|ref|) - 7), and 2**-9 of its mean magnitude."""
    ref = ref.float().abs()
    top = ref.max().clamp_min(torch.finfo(torch.float32).tiny).item()
    return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7), ref.mean().item() * 2.0 ** -9


# K4 gates, as in chip_smoke.py: f32 max abs 1e-4; bf16 at _bf16_gates
def _check_k4(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        assert err.max().item() <= 1e-4
    else:
        bars = _bf16_gates(ref)
        assert err.max().item() <= bars[0] and err.mean().item() <= bars[1], (
            err.max().item(), err.mean().item(), bars)


def _qkv(dev, shape, kv_shape, dtype, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = torch.randn(shape, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(kv_shape, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v


# (batch, heads, q tokens, kv tokens, kv_valid, denom)
K4_CASES = [
    (2, 3, 300, 300, None, "mxu"),    # batch 2, 300 = 4 tiles + 44 rows
    (1, 4, 1000, 1000, 900, "mxu"),   # kv_valid: zeroed tail, masked tile
    (1, 2, 130, 333, 300, "vpu"),     # q and kv lengths differ
    (2, 1, 64, 64, None, "vpu"),      # exactly one tile
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,skv,kv_valid,denom", K4_CASES)
def test_online_kernel_matches_plain(dev, b, h, sq, skv, kv_valid, denom, dtype):
    q, k, v = _qkv(dev, (b, h, sq, HD), (b, h, skv, HD), dtype, seed=sq + skv)
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_valid=kv_valid, denom=denom)
    ref = flash_attention_plain(q, k, v, kv_valid=kv_valid, denom=denom)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _check_k4(out, ref)


# the bf16 kernel's edges: 128-row q and kv tiles, a 3-slot ring
# (batch, heads, q tokens, kv tokens, kv_valid, denom)
K4_BF16_CASES = [
    (1, 2, 130, 333, None, "mxu"),     # neither length a multiple of 128
    (1, 3, 1000, 1000, 1000, "vpu"),   # 7 full tiles + 104
    (1, 2, 2100, 2100, 1900, "mxu"),   # kv_valid inside a tile
    (1, 2, 333, 2100, 1024, "vpu"),    # kv_valid on a tile edge
    (1, 2, 333, 2100, 256, "mxu"),     # kv_valid on a tile edge, 2 tiles of 17
    (2, 2, 200, 50, None, "mxu"),      # kv shorter than one tile (and the ring)
    (1, 1, 64, 1000, 1, "vpu"),        # one valid column
]


@pytest.mark.parametrize("b,h,sq,skv,kv_valid,denom", K4_BF16_CASES)
def test_online_bf16_kernel_tiles(dev, b, h, sq, skv, kv_valid, denom):
    q, k, v = _qkv(dev, (b, h, sq, HD), (b, h, skv, HD), torch.bfloat16, seed=sq + skv + 7)
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_valid=kv_valid, denom=denom)
    ref = flash_attention_plain(q, k, v, kv_valid=kv_valid, denom=denom)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _check_k4(out, ref)


def test_online_bf16_kernel_repeats_bit_identical_on_strided_inputs(dev):
    """Two launches give the same bits; a transposed (non-contiguous) q/k/v,
    the DiT's head layout, gives the same result as a contiguous one."""
    q, k, v = _qkv(dev, (1, 777, 3, HD), (1, 777, 3, HD), torch.bfloat16, seed=11)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    assert not q.is_contiguous()
    out = flash_attention(q, k, v, kv_valid=700)
    again = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), kv_valid=700)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _check_k4(out, flash_attention_plain(q, k, v, kv_valid=700))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_online_kernel_extreme_negative_scores_with_padding(dev, dtype):
    """All real scores deeply negative and 200 tokens (a ragged last tile):
    the masked columns must not take the softmax over."""
    shape = (1, 2, 200, HD)
    q = torch.full(shape, 5.0, device=dev).to(dtype)
    k = torch.full(shape, -5.0, device=dev).to(dtype)  # scores -200
    v = _qkv(dev, shape, shape, dtype, seed=3)[2]
    out = flash_attention(q, k, v)
    _check_k4(out, flash_attention_plain(q, k, v))
    _check_k4(out, attention_reference(q, k, v))  # the uniform average of v


def test_online_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(dev, (1, 1, 64, HD), (1, 1, 64, HD), torch.float32, seed=0)
    with pytest.raises(TypeError, match="K3"):  # K3 takes bf16 and f32 on CUDA
        flash_attention(q.half(), k.half(), v.half(), fixed_max=True)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    # K4 takes every head_dim on CUDA (24: the instance of 32 on zero-padded
    # operands; 272: the wide kernel at the width 320), none raises
    for hd in (24, 272):
        q2, k2, v2 = _qkv(dev, (1, 1, 64, hd), (1, 1, 64, hd), torch.float32, seed=hd)
        _check_k4(flash_attention(q2, k2, v2), flash_attention_plain(q2, k2, v2))
    # the wide bf16 kernel sums unrounded p ("vpu"), as the JAX wrapper does
    # from head_dim 128 up; asked for "mxu" alone, it refuses
    ops = _online_kernel_operands(q2.bfloat16(), k2.bfloat16(), v2.bfloat16(), None, None)
    with pytest.raises(ValueError, match="vpu"):
        _online_bf16_launch(*ops[:3], torch.empty_like(ops[0]), ops[3], True, ops[4])


def test_flash_trainable_grads_match_plain_on_cuda(dev):
    """K4 forward + blockwise backward on CUDA against autograd through the
    plain attention: value to 1e-4, gradients to 1e-4 of their largest
    magnitude (f32 on both sides, different summation orders)."""
    q, k, v = _qkv(dev, (1, 4, 700, HD), (1, 4, 700, HD), torch.float32, seed=5)
    w = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(6),
                    device=dev)
    results = []
    for fn in (flash_attention_trainable, attention_reference):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        (out * w).sum().backward()
        results.append((out.detach(), [t.grad for t in leaves]))
    torch.cuda.synchronize()
    (out, grads), (ref, ref_grads) = results
    assert (out - ref).abs().max().item() <= 1e-4
    for g, r in zip(grads, ref_grads):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()


# K2 on the fixed-shift cell (csrc/fixed_cell.cuh): 192-row CTAs of three
# 64-row warpgroups, each reading its own q scale, against 128-column kv
# tiles; (batch, tokens, heads, s_valid, block_q, quantize, noshift)
K2_CELL_CASES = [
    (1, 3000, 4, 2900, 1024, True, False),   # three 1024-token blocks; warpgroups of
                                             # the CTA at rows 960-1151 read two qsc
    (1, 2500, 2, 2500, 1024, True, None),    # blocks of 640 (s_pad 2560), hper 2
    (2, 700, 2, 650, 128, True, False),      # blocks of 128: every warpgroup its own
    (1, 1000, 1, 1000, 256, False, True),    # float, hper 1, shift dropped
    (2, 700, 3, 129, 128, False, None),      # one column into the second tile
]


@pytest.mark.parametrize("b,s,nh,s_valid,block_q,quantize,noshift", K2_CELL_CASES)
def test_flash_prepacked_cell_tiles(dev, b, s, nh, s_valid, block_q, quantize, noshift):
    """K2 at the cell's edges against its plain version, at K2's gates (int8:
    max 1e-2, mean 1e-3; float: the same, as above); two launches give the
    same bits."""
    xs, norms, rope = _inputs(dev, b, s, nh, s, seed=s + nh)
    q, k, v, qsc, qn, ksc, kn, s_pad = qkv_prologue(
        *xs, *norms, *rope, num_heads=nh, head_dim=HD, eps=1e-6, s_valid=s_valid,
        quantize=quantize, block_q=block_q)
    kw = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=s_valid, block_q=block_q,
              noshift=noshift)
    before = flash_attention_prepacked.launches
    out = flash_attention_prepacked(q, k, v, **kw)
    again = flash_attention_prepacked(q, k, v, **kw)
    ref = flash_attention_prepacked_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_prepacked.launches == before + 2
    assert torch.equal(out, again)
    _check_fixed(out, ref)


def test_flash_prepacked_refuses_what_it_does_not_take(dev):
    """Strided operands, stats of another grid and an unknown noshift raise
    ``ValueError``; nothing launches."""
    xs, norms, rope = _inputs(dev, 1, 300, 4, 300)
    q, k, v, qsc, qn, ksc, kn, _ = qkv_prologue(*xs, *norms, *rope, num_heads=4,
                                                head_dim=HD, eps=1e-6)
    kw = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn)
    before = flash_attention_prepacked.launches
    strided = torch.empty((q.shape[0], q.shape[1], 2 * HD), dtype=q.dtype, device=dev)[..., :HD]
    strided.copy_(q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_prepacked(strided, k, v, **kw)
    with pytest.raises(ValueError, match="tile exactly|grid"):
        flash_attention_prepacked(q[:, :200].contiguous(), k[:, :200].contiguous(),
                                  v[:, :200].contiguous(), **kw)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_prepacked(q, k[:, :256].contiguous(), v, **kw)
    with pytest.raises(ValueError, match="noshift"):
        flash_attention_prepacked(q, k, v, noshift=2, **kw)
    assert flash_attention_prepacked.launches == before


# K1 and K2 at the head dims other than 64 (csrc/attn_prologue.cu's cluster
# kernel at those head dims, counted on qkv_prologue_hd; the
# fixed_cell<D, int8 or bf16, per-tile scale> instances of
# csrc/flash_prepacked.cu): (batch, tokens, heads, s_valid, rope rows)
HD_CASES = [
    (2, 300, 3, 250, 300),      # hper 3: groups straddle the two batches
    (1, 1700, 4, 1650, 1600),   # two 1024-token tiles, tables short of s
    (1, 700, 2, None, 0),       # no RoPE; hper 2
]


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("b,s,nh,s_valid,rope_rows", HD_CASES)
@pytest.mark.parametrize("hd", [16, 32, 48, 80, 96, 112, 2, 8, 24, 72, 120, 126])
def test_prologue_and_flash_hd_kernels_match_plain(dev, hd, b, s, nh, s_valid, rope_rows,
                                                   quantize):
    """K1 at phase 3's gates (int8 codes within 1 on at most 1e-3 of them, or
    bf16 within one ulp on at most 1e-4; v bit-exact; the stats rtol 1e-5),
    K2 on its outputs at max 1e-2 / mean 1e-3, each with every noshift; one
    launch of each head-dim kernel a call and none of the head_dim-64 ones;
    two launches bit-identical. Below its width (2-126) K1 writes q, k and v
    that wide with zero columns past the head dim (read through the
    returned views' base), K2 reads them in place and also contiguous
    copies (padded where their rows are not 16-byte aligned)."""
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue_hd
    from aether_tpu_torch.ops.flash_attention import flash_attention_prepacked_hd

    xs, norms, rope = _inputs(dev, b, s, nh, rope_rows, seed=hd, hd=hd)
    kw = dict(num_heads=nh, head_dim=hd, eps=1e-6, s_valid=s_valid, quantize=quantize)
    counts = (qkv_prologue.launches, flash_attention_prepacked.launches)
    before = qkv_prologue_hd.launches
    got = qkv_prologue(*xs, *norms, *rope, **kw)
    ref = qkv_prologue_plain(*xs, *norms, *rope, **kw)
    torch.cuda.synchronize()
    assert qkv_prologue_hd.launches == before + 1
    assert got[7] == ref[7]
    for a, r in zip(got[:2], ref[:2]):
        assert a.dtype == r.dtype and a.shape == r.shape
        if quantize:
            diff = (a.int() - r.int()).abs()
            assert diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 1e-3
        else:
            ulps = _bf16_ulps(a, r)
            assert ulps.max().item() <= 1 and (ulps > 0).float().mean().item() <= 1e-4
    assert torch.equal(got[2], ref[2])
    for a, r in zip(got[3:7], ref[3:7]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=0)
    q, k, v, qsc, qn, ksc, kn, _ = got
    width = -(-hd // 16) * 16
    if width != hd:
        for t in (q, k, v):  # the prologue's buffers past the head dim
            assert t.stride(1) == width and not t.as_strided(
                (t.shape[0], t.shape[1], width), t.stride())[..., hd:].any()
        fkw = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=s_valid or s)
        torch.testing.assert_close(
            flash_attention_prepacked(*(t.contiguous() for t in (q, k, v)), **fkw),
            flash_attention_prepacked(q, k, v, **fkw), rtol=0, atol=0)
    for noshift in (False, True, None):
        fkw = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=s_valid or s, noshift=noshift)
        before = flash_attention_prepacked_hd.launches
        out = flash_attention_prepacked(q, k, v, **fkw)
        again = flash_attention_prepacked(q, k, v, **fkw)
        plain = flash_attention_prepacked_plain(q, k, v, **fkw)
        torch.cuda.synchronize()
        assert flash_attention_prepacked_hd.launches == before + 2
        assert torch.equal(out, again)
        err = (out.float() - plain.float()).abs()
        assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-3, (noshift, err.max())
    assert (qkv_prologue.launches, flash_attention_prepacked.launches) == counts


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("b", [1, 2])
def test_prologue_at_64_is_the_plain_version_bit_for_bit(dev, b, quantize):
    """K1 at head_dim 64 on bf16 inputs (the shifted moments are exact in
    double): q, k, v and the scales bit for bit the plain version's (the
    row-norm maxima, summed in another order, at rtol 1e-5), over a cluster
    of 8 with S_in < s_pad, hper 4 straddling the batch elements at batch 2
    and tables shorter than the tokens."""
    xs, norms, rope = _inputs(dev, b, 3996, 6, 3800, seed=64 + b)
    kw = dict(num_heads=6, head_dim=HD, eps=1e-6, s_valid=3900, quantize=quantize)
    got = qkv_prologue(*xs, *norms, *rope, **kw)
    ref = qkv_prologue_plain(*xs, *norms, *rope, **kw)
    torch.cuda.synchronize()
    assert got[7] == ref[7] == 4096
    for i in (0, 1, 2, 3, 5):
        assert got[i].dtype == ref[i].dtype and torch.equal(got[i], ref[i]), i
    for i in (4, 6):
        torch.testing.assert_close(got[i], ref[i], rtol=1e-5, atol=0)


@pytest.mark.parametrize("hd", [8, 24, 128, 144, 272])
def test_head_dims_outside_the_range_raise_on_cuda(dev, hd):
    """What a CUDA tensor takes at the edges of the head-dim ranges: at 8 and
    24 (below their instance's width) K1, K2, K3, K4 and K6 run, one launch
    each on its head-dim counter; at 128 K2 and K4 run, and K1, K3 and K6
    called directly raise (the JAX wrapper turns the fixed max off there, so
    no path reaches them); at 144 K4 and K4 f32 run (the instance of 160 on
    padded operands) and K1, K2, K3 and K6 raise; at 272 K4 and K4 f32 run
    (the wide kernels at the width 320) and the others raise. Each refusal
    is a ``NotImplementedError`` naming the head dim that launches nothing
    (the plain versions take every head dim on the CPU)."""
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue_hd
    from aether_tpu_torch.ops.flash_attention import flash_attention_prepacked_hd

    xs, norms, rope = _inputs(dev, 1, 300, 2, 300, hd=hd)
    names = ("K1", "K1 64", "K2", "K2 64", "K3", "K3 f32", "K4", "K4 f32", "K6")
    counts = lambda: dict(zip(names, (  # noqa: E731
        qkv_prologue_hd.launches, qkv_prologue.launches, flash_attention_prepacked_hd.launches,
        flash_attention_prepacked.launches, *(fn.launches for fn in _HD_COUNTED))))
    runs = hd < 128

    def expect(call, name):
        before = counts()
        if (runs or (hd == 128 and name in ("K2", "K4", "K4 f32"))
                or (hd > 128 and name in ("K4", "K4 f32"))):
            call()
            torch.cuda.synchronize()
            want = dict(before, **{name: before[name] + 1})
        else:
            with pytest.raises(NotImplementedError, match="head_dim"):
                call()
            want = before
        assert counts() == want, name

    q, k, v = _qkv(dev, (1, 2, 100, hd), (1, 2, 100, hd), torch.bfloat16, seed=hd)
    expect(lambda: flash_attention_fixed_max(q, k, v), "K3")
    expect(lambda: flash_attention_fixed_max(q.float(), k.float(), v.float()), "K3 f32")
    expect(lambda: flash_attention_pv8(q, k, v), "K6")
    expect(lambda: flash_attention(q, k, v), "K4")
    expect(lambda: flash_attention(q.float(), k.float(), v.float()), "K4 f32")
    expect(lambda: qkv_prologue(*xs, *norms, *rope, num_heads=2, head_dim=hd, eps=1e-6), "K1")
    q, k, v, qsc, qn, ksc, kn, _ = qkv_prologue_plain(
        *(x.cpu() for x in xs), *(n.cpu() for n in norms), *(r.cpu() for r in rope),
        num_heads=2, head_dim=hd, eps=1e-6)
    expect(lambda: flash_attention_prepacked(*(t.to(dev).contiguous() for t in (q, k, v)),
                                             qsc=qsc.to(dev), ksc=ksc.to(dev), qn=qn.to(dev),
                                             kn=kn.to(dev)), "K2")


# K3 and K6 gates, as in chip_smoke.py: max abs 1e-2 and mean 1e-3 of bf16
# outputs (K2's); K6 computes the plain version's function up to exp2f's last
# bit, so its mean error is held to 1e-4
def _check_fixed(out, ref, mean_bar=1e-3):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs()
    assert err.max().item() <= 1e-2 and err.mean().item() <= mean_bar, (
        err.max().item(), err.mean().item())


# (batch, heads, q tokens, kv tokens, kv_valid, qk_int8)
K3_CASES = [
    (2, 3, 300, 300, None, True),     # B*H 6: groups of 3; 300 = 4 tiles + 44
    (1, 5, 1000, 1000, 900, True),    # B*H 5: groups of 1; kv_valid tail
    (1, 4, 130, 333, 300, False),     # Sq != Skv, bf16 QK^T
    (2, 2, 64, 64, None, False),      # exactly one tile
    (1, 3, 777, 2100, 2050, True),    # several kv tiles, ragged everywhere
]


@pytest.mark.parametrize("b,h,sq,skv,kv_valid,qk_int8", K3_CASES)
def test_fixed_max_kernel_matches_plain(dev, b, h, sq, skv, kv_valid, qk_int8):
    q, k, v = _qkv(dev, (b, h, sq, HD), (b, h, skv, HD), torch.bfloat16, seed=sq + skv)
    before = flash_attention_fixed_max.launches
    kw = dict(kv_valid=kv_valid, qk_int8=qk_int8, noshift=None)
    out = flash_attention(q, k, v, fixed_max=True, **kw)
    ref = flash_attention_fixed_max_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_fixed_max.launches == before + 1
    _check_fixed(out, ref)


# K3 on the fixed-shift cell: 192-row q tiles, 128-column kv tiles, no
# padding copy (rows past the ends are TMA's zero fill); hper =
# _heads_per_cell(B*H, 4). (batch, heads, q tokens, kv tokens, kv_valid, qk_int8)
K3_CELL_CASES = [
    (1, 4, 500, 500, None, True),     # hper 4; 500 = two CTAs + 116 rows
    (1, 2, 193, 1000, 900, False),    # hper 2; one row into the second CTA; kv_valid
                                      # inside tile 8
    (1, 1, 64, 2000, 300, True),      # hper 1; tiles 4-16 wholly past kv_valid
    (2, 2, 700, 333, 256, True),      # Sq > Skv; kv_valid on a tile edge, tile 3 skipped
    (1, 4, 1000, 1100, 1, False),     # one valid column
    (1, 3, 3776, 15104, 15076, True), # the ring-merge stripe's lengths
]


@pytest.mark.parametrize("b,h,sq,skv,kv_valid,qk_int8", K3_CELL_CASES)
def test_fixed_max_kernel_cell_tiles(dev, b, h, sq, skv, kv_valid, qk_int8):
    """K3 at the cell's edges against its plain version at K3's gates; two
    launches give the same bits."""
    q, k, v = _qkv(dev, (b, h, sq, HD), (b, h, skv, HD), torch.bfloat16, seed=sq + skv + 3)
    kw = dict(kv_valid=kv_valid, qk_int8=qk_int8)
    before = flash_attention_fixed_max.launches
    out = flash_attention_fixed_max(q, k, v, **kw)
    again = flash_attention_fixed_max(q, k, v, **kw)
    ref = flash_attention_fixed_max_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_fixed_max.launches == before + 2
    assert torch.equal(out, again)
    _check_fixed(out, ref)


@pytest.mark.parametrize("qk_int8", [True, False])
def test_fixed_max_kernel_unnormalized_cell_tiles(dev, qk_int8):
    """The ring-merge mode where the tiles are ragged: 777 q rows (four
    192-row CTAs and 9 rows), kv_valid 2050 inside the 17th kv tile of 2100;
    l to 1e-4 relative, o to 1e-2 of its largest magnitude, as below; two
    launches give the same bits."""
    q, k, v = _qkv(dev, (1, 3, 777, HD), (1, 3, 2100, HD), torch.bfloat16, seed=10)
    kw = dict(kv_valid=2050, qk_int8=qk_int8, score_bound=60.0, unnormalized=True)
    o, l = flash_attention_fixed_max(q, k, v, **kw)
    o2, l2 = flash_attention_fixed_max(q, k, v, **kw)
    ro, rl = flash_attention_fixed_max_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(l, l2)
    assert l.shape == rl.shape == (1, 3, 777, 1)
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=0)
    assert (o.float() - ro.float()).abs().max().item() <= 1e-2 * ro.float().abs().max().item()


def test_fixed_max_kernel_alone_matches_its_wrapper(dev):
    """The kernel on the operands the wrapper prepares (unpadded) writes the
    wrapper's output; the launch alone does not count."""
    from aether_tpu_torch.ops.flash_attention import _fixed_max_launch, _fixed_max_operands

    q, k, v = _qkv(dev, (1, 3, 500, HD), (1, 3, 700, HD), torch.bfloat16, seed=13)
    for qk_int8 in (True, False):
        ops = _fixed_max_operands(q, k, v, sm_scale=None, kv_valid=650, heads_per_cell=4,
                                  noshift=False, qk_int8=qk_int8, pv_int8=False,
                                  score_bound=None, unnormalized=False)
        assert ops.q.shape == (3, 500, HD) and ops.k.shape == (3, 700, HD)
        out = torch.empty((3, 500, HD), dtype=torch.bfloat16, device=dev)
        before = flash_attention_fixed_max.launches
        _fixed_max_launch(ops, out, None)
        assert flash_attention_fixed_max.launches == before
        ref = flash_attention_fixed_max(q, k, v, kv_valid=650, qk_int8=qk_int8)
        torch.cuda.synchronize()
        assert torch.equal(out.view(ref.shape), ref)


@pytest.mark.parametrize("qk_int8", [True, False])
def test_fixed_max_kernel_unnormalized_score_bound(dev, qk_int8):
    """The ring-merge mode: raw numerator in bf16 and f32 l against the
    plain version; l to 1e-4 relative (the same bf16 p summed in another
    order), o to 1e-2 of its largest magnitude."""
    q, k, v = _qkv(dev, (1, 3, 200, HD), (1, 3, 700, HD), torch.bfloat16, seed=9)
    kw = dict(kv_valid=650, qk_int8=qk_int8, score_bound=40.0, unnormalized=True)
    o, l = flash_attention_fixed_max(q, k, v, **kw)
    ro, rl = flash_attention_fixed_max_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and l.dtype == torch.float32
    assert l.shape == rl.shape == (1, 3, 200, 1)
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=0)
    assert (o.float() - ro.float()).abs().max().item() <= 1e-2 * ro.float().abs().max().item()


# (batch, heads, q tokens, kv tokens, kv_valid, block_k, dtype)
K6_CASES = [
    (2, 3, 300, 300, None, 1024, torch.bfloat16),  # one span, padding bias
    (1, 5, 1000, 1000, 900, 256, torch.bfloat16),  # four spans, kv_valid
    (1, 4, 130, 2100, 2050, 1024, torch.float32),  # Sq != Skv, three spans, f32 out
    (2, 2, 64, 256, None, 128, torch.bfloat16),    # no padding, two spans
    # the wgmma kernel's edges: spans of 128, 256 and 1024 against its
    # 128-column tiles and 128-row q tiles
    (1, 2, 333, 1000, None, 128, torch.bfloat16),  # eight spans of one tile
    (1, 2, 130, 1000, 600, 256, torch.bfloat16),   # kv_valid empties the 4th span
    (1, 5, 200, 2048, 1030, 1024, torch.bfloat16), # B*H 5: groups of 1; 2nd span 1 tile
    (2, 3, 1000, 1024, 1024, 1024, torch.float32), # one full span, f32 out
    (1, 2, 64, 300, 129, 128, torch.bfloat16),     # one column into the 2nd span
]


@pytest.mark.parametrize("b,h,sq,skv,kv_valid,block_k,dtype", K6_CASES)
def test_pv8_kernel_matches_plain(dev, b, h, sq, skv, kv_valid, block_k, dtype):
    q, k, v = _qkv(dev, (b, h, sq, HD), (b, h, skv, HD), dtype, seed=sq + skv + 1)
    before = flash_attention_pv8.launches
    kw = dict(kv_valid=kv_valid, block_k=block_k)
    out = flash_attention(q, k, v, fixed_max=True, qk_int8=True, pv_int8=True, **kw)
    ref = flash_attention_pv8_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_pv8.launches == before + 1
    _check_fixed(out, ref, mean_bar=1e-4)


def test_pv8_kernel_repeats_bit_identical(dev):
    q, k, v = _qkv(dev, (1, 3, 500, HD), (1, 3, 1500, HD), torch.bfloat16, seed=12)
    kw = dict(kv_valid=1400, block_k=256)
    out, again = flash_attention_pv8(q, k, v, **kw), flash_attention_pv8(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


def test_pv8_kernel_negative_row_max_with_padding(dev):
    """Every real score deeply negative behind padded columns: the -1e9 bias
    keeps the padding out of the running max; the result is the mean of v."""
    shape = (1, 2, 200, HD)
    q = torch.full(shape, 3.0, device=dev, dtype=torch.bfloat16)
    k = torch.full(shape, -3.0, device=dev, dtype=torch.bfloat16)
    v = _qkv(dev, shape, shape, torch.bfloat16, seed=3)[2]
    out = flash_attention_pv8(q, k, v, block_k=128)
    _check_fixed(out, flash_attention_pv8_plain(q, k, v, block_k=128), mean_bar=1e-4)
    mean_v = v.float().mean(dim=2, keepdim=True).expand(shape)
    assert (out.float() - mean_v).abs().max().item() <= v.float().abs().max().item() / 127


def test_fixed_max_kernels_refuse_what_they_do_not_take(dev):
    q, k, v = _qkv(dev, (1, 1, 64, HD), (1, 1, 64, HD), torch.bfloat16, seed=0)
    for fn in (flash_attention_fixed_max, flash_attention_pv8):
        with pytest.raises(TypeError):
            fn(q.half(), k.half(), v.half())
        # every head_dim below 128 on CUDA (24: the instance of 32 on
        # zero-padded operands); 128 and above raise
        q24, k24, v24 = _qkv(dev, (1, 1, 64, 24), (1, 1, 64, 24), torch.bfloat16, seed=24)
        plain = (flash_attention_fixed_max_plain if fn is flash_attention_fixed_max
                 else flash_attention_pv8_plain)
        _check_fixed(fn(q24, k24, v24), plain(q24, k24, v24))
        wide = torch.zeros((1, 1, 64, 128), device=dev, dtype=torch.bfloat16)
        with pytest.raises(NotImplementedError, match="head_dim"):
            fn(wide, wide, wide)
    with pytest.raises(TypeError, match="K3"):
        flash_attention_fixed_max(q.float(), k, v)
    with pytest.raises(ValueError, match="pv_int8 requires qk_int8"):
        flash_attention(q, k, v, fixed_max=True, pv_int8=True)
    # k and v of other lengths or heads
    with pytest.raises(ValueError, match="does not match"):
        flash_attention_fixed_max(q, k[:, :, :32], v)
    with pytest.raises(ValueError, match="does not match"):
        flash_attention_fixed_max(q, k, torch.cat([v, v], dim=1))


# ---- K3, K4 and K6 at the other head dims; K3 in f32 ----
# (csrc/flash_fixed_max.cu, flash_online_bf16.cu (K4 bf16, online_cell<D>),
# flash_pv8.cu; the 3xTF32 cell tf32x3_cell.cuh: flash_online.cu (K4 f32)
# and flash_fixed_max_hd.cu (K3 f32))

_HD_COUNTED = (flash_attention_fixed_max_hd, flash_attention_fixed_max_f32, flash_attention_hd,
               flash_attention_f32_hd, flash_attention_pv8_hd)
_64_COUNTED = (flash_attention, flash_attention_fixed_max, flash_attention_pv8)
OTHER_DIMS = [16, 32, 48, 80, 96, 112]
# head dims below their instance's width (1-127; zero-padded operands)
PADDED_DIMS = [1, 8, 17, 24, 72, 120, 127]
# K4 above 128: the instances 160, 192, 224 and 256, and 144 and 200 padded
WIDE_DIMS = [144, 160, 192, 200, 224, 256]


def _counts(fns):
    return tuple(fn.launches for fn in fns)


# (batch, heads, q tokens, kv tokens, kv_valid): ragged tiles, Sq != Skv,
# head groups of 3 (B*H 6) and 1 (B*H 5), one valid column
HD_ATTN_CASES = [
    (2, 3, 300, 300, None),
    (1, 5, 130, 333, 300),
    (1, 2, 777, 2100, 2050),
    (1, 4, 70, 200, 1),
]


@pytest.mark.parametrize("qk_int8", [True, False])
@pytest.mark.parametrize("b,h,sq,skv,kv_valid", HD_ATTN_CASES)
@pytest.mark.parametrize("hd", OTHER_DIMS + PADDED_DIMS)
def test_fixed_max_hd_kernel_matches_plain(dev, hd, b, h, sq, skv, kv_valid, qk_int8):
    """K3 (bf16 q/k/v) at the other head dims against its plain version at
    K3's gates, noshift auto; one launch of the head-dim kernel a call and
    none of the head_dim-64 ones; two launches bit-identical."""
    q, k, v = _qkv(dev, (b, h, sq, hd), (b, h, skv, hd), torch.bfloat16, seed=hd + sq + skv)
    kw = dict(kv_valid=kv_valid, qk_int8=qk_int8, noshift=None)
    before, before64 = flash_attention_fixed_max_hd.launches, _counts(_64_COUNTED)
    out = flash_attention(q, k, v, fixed_max=True, **kw)
    again = flash_attention_fixed_max(q, k, v, **kw)
    ref = flash_attention_fixed_max_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_fixed_max_hd.launches == before + 2
    assert _counts(_64_COUNTED) == before64
    assert torch.equal(out, again)
    _check_fixed(out, ref)


@pytest.mark.parametrize("qk_int8", [True, False])
@pytest.mark.parametrize("hd", OTHER_DIMS)
def test_fixed_max_hd_kernel_unnormalized_score_bound(dev, hd, qk_int8):
    """The ring-merge mode at the other head dims: 777 q rows against 2100
    kv rows, kv_valid 2050; l to 1e-4 relative, o to 1e-2 of its largest
    magnitude (the head_dim-64 bars)."""
    q, k, v = _qkv(dev, (1, 3, 777, hd), (1, 3, 2100, hd), torch.bfloat16, seed=hd)
    kw = dict(kv_valid=2050, qk_int8=qk_int8, score_bound=60.0, unnormalized=True)
    o, l = flash_attention_fixed_max(q, k, v, **kw)
    ro, rl = flash_attention_fixed_max_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and l.shape == rl.shape == (1, 3, 777, 1)
    torch.testing.assert_close(l, rl, rtol=1e-4, atol=0)
    assert (o.float() - ro.float()).abs().max().item() <= 1e-2 * ro.float().abs().max().item()


@pytest.mark.parametrize("qk_int8", [True, False])
@pytest.mark.parametrize("hd", PADDED_DIMS)
def test_fixed_max_padded_kernel_unnormalized_score_bound(dev, hd, qk_int8):
    """The ring-merge mode below the instance's width, as above, with l held
    to the bound of its arithmetic: l sums bf16(p), and the kernel's one-SFU
    exp2 and the plain version's exp2 may round a p on either side of a bf16
    step, so each term may differ by one step (2**-8 of itself) and l by at
    most 2**-8 of itself (plus f32 order noise); 99.9% of the rows within
    1e-4 relative (at head_dim 24 the rtol-1e-4 form of the test above
    failed on one row of 2331, at 1.2e-4, where l = 3.6e-15 rests on a few
    terms); o as above."""
    q, k, v = _qkv(dev, (1, 3, 777, hd), (1, 3, 2100, hd), torch.bfloat16, seed=hd)
    kw = dict(kv_valid=2050, qk_int8=qk_int8, score_bound=60.0, unnormalized=True)
    o, l = flash_attention_fixed_max(q, k, v, **kw)
    ro, rl = flash_attention_fixed_max_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and l.shape == rl.shape == (1, 3, 777, 1)
    rel = (l - rl).abs() / rl.abs()
    assert rel.max().item() <= 2.0 ** -8 + 1e-6, rel.max().item()
    assert (rel > 1e-4).float().mean().item() <= 1e-3, rel.max().item()
    assert (o.float() - ro.float()).abs().max().item() <= 1e-2 * ro.float().abs().max().item()


@pytest.mark.parametrize("qk_int8", [True, False])
@pytest.mark.parametrize("b,h,sq,skv,kv_valid", HD_ATTN_CASES[:3])
@pytest.mark.parametrize("hd", [16, 32, 48, 64, 80, 96, 112] + PADDED_DIMS)
def test_fixed_max_f32_kernel_matches_plain(dev, hd, b, h, sq, skv, kv_valid, qk_int8):
    """K3 in f32 (the 3xTF32 cell) at every head dim, 64 included: max abs
    1e-4 against the plain version (K4 f32's gate: 3xTF32 products, another
    order of the sums); normalized and unnormalized (l to 1e-5 relative, o
    to 1e-4 of its largest magnitude); repeats bit-identical."""
    q, k, v = _qkv(dev, (b, h, sq, hd), (b, h, skv, hd), torch.float32, seed=hd + sq)
    kw = dict(kv_valid=kv_valid, qk_int8=qk_int8, noshift=None)
    before, before64 = flash_attention_fixed_max_f32.launches, _counts(_64_COUNTED)
    out = flash_attention(q, k, v, fixed_max=True, **kw)
    again = flash_attention_fixed_max(q, k, v, **kw)
    ref = flash_attention_fixed_max_plain(q, k, v, **kw)
    kw.update(noshift=False, score_bound=40.0, unnormalized=True)
    o, l = flash_attention_fixed_max(q, k, v, **kw)
    ro, rl = flash_attention_fixed_max_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_fixed_max_f32.launches == before + 3
    assert _counts(_64_COUNTED) == before64
    assert torch.equal(out, again) and out.dtype == torch.float32
    _check_k4(out, ref)
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    assert (o - ro).abs().max().item() <= 1e-4 * ro.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("denom", ["mxu", "vpu"])
@pytest.mark.parametrize("b,h,sq,skv,kv_valid", HD_ATTN_CASES)
@pytest.mark.parametrize("hd", [16, 32, 48, 80, 96, 112, 128] + PADDED_DIMS + WIDE_DIMS)
def test_online_hd_kernels_match_plain(dev, hd, b, h, sq, skv, kv_valid, denom, dtype):
    """K4 at the other head dims (128 and above: "vpu" whatever is asked, as
    the JAX wrapper) against its plain version at K4's gates; one launch of the
    head-dim kernel of the dtype a call, none of the head_dim-64 ones; two
    launches bit-identical."""
    q, k, v = _qkv(dev, (b, h, sq, hd), (b, h, skv, hd), dtype, seed=hd + sq + 1)
    counter = flash_attention_hd if dtype == torch.bfloat16 else flash_attention_f32_hd
    before, before64 = counter.launches, _counts(_64_COUNTED)
    out = flash_attention(q, k, v, kv_valid=kv_valid, denom=denom)
    again = flash_attention(q, k, v, kv_valid=kv_valid, denom=denom)
    ref = flash_attention_plain(q, k, v, kv_valid=kv_valid, denom=denom)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert _counts(_64_COUNTED) == before64
    assert torch.equal(out, again)
    _check_k4(out, ref)


def test_online_f32_at_128_keeps_pv_off_the_tensor_core_accumulator(dev):
    """K4 f32 at head_dim 128 over the main path's 15076 keys (48 heads):
    each kv tile's P V, in two 64-column halves, is added to the output on
    the FMA units, so the error stays at the other head dims' (mean abs
    <= 1e-7, max <= 3e-6 against the plain version; kept on the tensor-core
    accumulator it read 1.14e-6 / 1.27e-5)."""
    q, k, v = _qkv(dev, (1, 48, 15076, 128), (1, 48, 15076, 128), torch.float32, seed=128)
    before = flash_attention_f32_hd.launches
    out = flash_attention(q, k, v)
    ref = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_f32_hd.launches == before + 1
    err = (out - ref).abs()
    assert err.mean().item() <= 1e-7 and err.max().item() <= 3e-6, (err.mean(), err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 112, 128, 17, 120, 160, 200, 256])
def test_online_hd_kernels_extreme_negative_scores_on_strided_inputs(dev, hd, dtype):
    """Deeply negative scores behind a ragged last tile, on the DiT's
    transposed (non-contiguous) head layout: the masked columns do not take
    the softmax over; the uniform average of v."""
    shape = (1, 200, 2, hd)
    q = torch.full(shape, 5.0, device=dev).to(dtype).transpose(1, 2)
    k = torch.full(shape, -5.0, device=dev).to(dtype).transpose(1, 2)
    v = _qkv(dev, shape, shape, dtype, seed=3)[2].transpose(1, 2)
    out = flash_attention(q, k, v)
    _check_k4(out, flash_attention_plain(q, k, v))
    _check_k4(out, attention_reference(q, k, v))


# the edges of K4's cells above 128 (bf16: 128-row q tiles, 64-row kv tiles
# in a ring of 4 to 2 slots; f32: a pair of CTAs a 128-row q tile, 32-row kv
# tiles):
# (batch, heads, q tokens, kv tokens, kv_valid)
K4_WIDE_CASES = [
    (1, 2, 130, 333, 300),     # Sq not a multiple of 128; kv_valid inside a tile
    (1, 3, 333, 2100, 1900),   # many tiles, the ring wrapping; kv_valid inside one
    (1, 2, 333, 2100, 1024),   # kv_valid on a tile edge, the tiles past it skipped
    (2, 3, 200, 50, None),     # kv shorter than one bf16 tile (and the ring)
    (1, 2, 77, 10, None),      # kv shorter than one f32 tile
    (1, 1, 64, 1000, 1),       # one valid column
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,skv,kv_valid", K4_WIDE_CASES)
@pytest.mark.parametrize("hd", [160, 192, 224, 256])
def test_online_wide_kernels_tiles(dev, hd, b, h, sq, skv, kv_valid, dtype):
    """K4 at the widths above 128 ("vpu") on the edges of their tiles
    against the plain version at K4's gates: one launch of the head-dim
    kernel of the dtype a call, none of the head_dim-64 ones, two launches
    bit-identical."""
    q, k, v = _qkv(dev, (b, h, sq, hd), (b, h, skv, hd), dtype, seed=hd + sq + skv + 3)
    counter = flash_attention_hd if dtype == torch.bfloat16 else flash_attention_f32_hd
    before, before64 = counter.launches, _counts(_64_COUNTED)
    out = flash_attention(q, k, v, kv_valid=kv_valid)
    again = flash_attention(q, k, v, kv_valid=kv_valid)
    ref = flash_attention_plain(q, k, v, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert _counts(_64_COUNTED) == before64
    assert torch.equal(out, again)
    _check_k4(out, ref)


# K4 f32 at 129-256: a pair of CTAs a 128-row q tile splits the head dim
# in 32-column units (``_wide_plan``: 160 96 + 64, 192 96 + 96, 224 128 + 96,
# 256 128 + 128), 32-row kv tiles through K and V rings of 2 slots each;
# strided inputs (the DiT's [B, S, H, D] layout):
# (batch, heads, q tokens, kv tokens, kv_valid)
PAIR_CASES = [
    (1, 3, 130, 333, 300),     # the last q tile 2 rows (its second warpgroup empty),
                               # kv_valid inside a tile; B*H odd
    (1, 1, 200, 2100, 1024),   # the last q tile's second warpgroup 8 rows;
                               # kv_valid on a tile edge, the tiles past it skipped
    (1, 3, 77, 10, None),      # kv shorter than one tile and ring slot
    (1, 5, 257, 700, 650),     # three q tiles, the last one row; both rings wrapping
]


@pytest.mark.parametrize("b,h,sq,skv,kv_valid", PAIR_CASES)
@pytest.mark.parametrize("hd", WIDE_DIMS)
def test_online_f32_pair_edges(dev, hd, b, h, sq, skv, kv_valid):
    """K4 f32 at 129-256 on the edges of its CTA pair, on strided inputs,
    against the plain version at K4's gates: one launch of the f32 head-dim
    kernel a call, none of the head_dim-64 ones, two launches bit-identical."""
    q, k, v = _qkv(dev, (b, sq, h, hd), (b, skv, h, hd), torch.float32,
                   seed=hd + sq + skv + 11)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    before, before64 = flash_attention_f32_hd.launches, _counts(_64_COUNTED)
    out = flash_attention(q, k, v, kv_valid=kv_valid)
    again = flash_attention(q, k, v, kv_valid=kv_valid)
    ref = flash_attention_plain(q, k, v, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert flash_attention_f32_hd.launches == before + 2
    assert _counts(_64_COUNTED) == before64
    assert torch.equal(out, again)
    _check_k4(out, ref)


@pytest.mark.parametrize("hd", [160, 192, 224, 256])
def test_online_f32_pair_holds_the_same_scores(dev, hd):
    """Both CTAs of a pair hold the same S, bit for bit: with v's columns of
    the second CTA's output slice a copy of the first slice's first columns,
    those output columns are equal, though each CTA computed them from its
    own copy of S and p (and at 160 and 224 through P V chains of other
    widths)."""
    plan = _wide_plan(hd, torch.float32)
    c0, cols = plan.out_cols
    q, k, v = _qkv(dev, (1, 3, 333, hd), (1, 3, 1000, hd), torch.float32, seed=hd + 13)
    v[..., c0:c0 + cols] = v[..., :cols]
    out = flash_attention(q, k, v, kv_valid=900)
    torch.cuda.synchronize()
    assert plan.cluster == 2 and plan.groups == 1
    assert torch.equal(out[..., c0:c0 + cols], out[..., :cols])
    _check_k4(out, flash_attention_plain(q, k, v, kv_valid=900))


# K4 above 256: the wide kernels (a thread-block cluster a q tile splitting
# the head dim in slices of at most 256 columns in bf16 and 128 in f32) at
# clusters of two to eight CTAs, even and uneven slices
ABOVE_256_DIMS = [257, 272, 320, 384, 512, 1000]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,skv,kv_valid", K4_WIDE_CASES)
@pytest.mark.parametrize("hd", ABOVE_256_DIMS)
def test_online_above_256_kernels_tiles(dev, hd, b, h, sq, skv, kv_valid, dtype):
    """K4's wide kernels ("vpu") on the edges of their tiles against the
    plain version at K4's gates: one launch of the head-dim kernel of the
    dtype a call, none of the head_dim-64 ones, two launches bit-identical."""
    q, k, v = _qkv(dev, (b, h, sq, hd), (b, h, skv, hd), dtype, seed=hd + sq + skv + 5)
    counter = flash_attention_hd if dtype == torch.bfloat16 else flash_attention_f32_hd
    before, before64 = counter.launches, _counts(_64_COUNTED)
    out = flash_attention(q, k, v, kv_valid=kv_valid, denom="mxu")
    again = flash_attention(q, k, v, kv_valid=kv_valid)
    ref = flash_attention_plain(q, k, v, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert _counts(_64_COUNTED) == before64
    assert torch.equal(out, again)
    _check_k4(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [272, 1000])
def test_online_above_256_extreme_negative_scores_on_strided_inputs(dev, hd, dtype):
    """The wide kernels behind a ragged last tile with deeply negative
    scores, on the DiT's transposed head layout: the uniform average of v."""
    shape = (1, 200, 3, hd)
    q = torch.full(shape, 5.0, device=dev).to(dtype).transpose(1, 2)
    k = torch.full(shape, -5.0, device=dev).to(dtype).transpose(1, 2)
    v = _qkv(dev, shape, shape, dtype, seed=4)[2].transpose(1, 2)
    out = flash_attention(q, k, v)
    _check_k4(out, flash_attention_plain(q, k, v))
    _check_k4(out, attention_reference(q, k, v))


# K4 above 256 across the edges of its clusters (``_wide_plan``): uneven
# slices (257: bf16 192 + 128, f32 128 + 128 + 64 on the width 320; 320) and
# widths beyond one cluster (bf16 2304: 2 clusters of 8 along y, f32 1088: 2
# of 8), on strided inputs (the DiT's [B, S, H, D] layout), B*H odd
WIDE_EDGE_DIMS = [(257, torch.bfloat16), (257, torch.float32), (320, torch.bfloat16),
                  (320, torch.float32), (2304, torch.bfloat16), (1088, torch.float32)]
# (batch, heads, q tokens, kv tokens, kv_valid)
WIDE_EDGE_CASES = [
    (1, 3, 200, 333, 300),     # Sq not a multiple of 128, kv_valid inside a tile
    (1, 1, 130, 2100, 1900),   # many tiles, the double-buffered exchange wrapping
    (1, 3, 77, 10, None),      # kv shorter than one tile
]


@pytest.mark.parametrize("b,h,sq,skv,kv_valid", WIDE_EDGE_CASES)
@pytest.mark.parametrize("hd,dtype", WIDE_EDGE_DIMS)
def test_online_above_256_cluster_edges(dev, hd, dtype, b, h, sq, skv, kv_valid):
    """K4's wide kernels at uneven slices and beyond one cluster, on strided
    inputs, against the plain version at K4's gates: one launch of the
    dtype's head-dim kernel a call, two launches bit-identical."""
    q, k, v = _qkv(dev, (b, sq, h, hd), (b, skv, h, hd), dtype, seed=hd + sq + skv + 7)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    counter = flash_attention_hd if dtype == torch.bfloat16 else flash_attention_f32_hd
    before = counter.launches
    out = flash_attention(q, k, v, kv_valid=kv_valid)
    again = flash_attention(q, k, v, kv_valid=kv_valid)
    ref = flash_attention_plain(q, k, v, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert torch.equal(out, again)
    _check_k4(out, ref)


@pytest.mark.parametrize("hd,dtype", WIDE_EDGE_DIMS[2:] + [(512, torch.float32)])
def test_online_above_256_slices_hold_the_same_scores(dev, hd, dtype):
    """Every CTA of a cluster (and every cluster along y) holds the same S,
    bit for bit: with v's columns of each output slice a copy of the first
    slice's, each slice's output columns equal the first slice's, though
    other CTAs computed them from their own copy of S and p."""
    width = head_dim_width(hd)
    plan = _wide_plan(width, dtype)
    q, k, v = _qkv(dev, (1, 3, 333, width), (1, 3, 1000, width), dtype, seed=hd)
    starts = [sum(plan.out_cols[:i]) for i in range(len(plan.out_cols))]
    for c0, cols in zip(starts[1:], plan.out_cols[1:]):
        v[..., c0:c0 + cols] = v[..., :cols]
    out = flash_attention(q, k, v, kv_valid=900)
    torch.cuda.synchronize()
    for c0, cols in zip(starts[1:], plan.out_cols[1:]):
        assert torch.equal(out[..., c0:c0 + cols], out[..., :cols]), (c0, cols)
    _check_k4(out, flash_attention_plain(q, k, v, kv_valid=900))


def test_online_f32_above_256_keeps_pv_off_the_tensor_core_accumulator(dev):
    """K4 f32 at head_dim 512 over the main path's 15076 keys (8 heads): each
    kv tile's P V, in two 64-column chains, is added to the output on the
    FMA units, at the gates of 128 (mean abs <= 1e-7, max <= 3e-6)."""
    q, k, v = _qkv(dev, (1, 8, 15076, 512), (1, 8, 15076, 512), torch.float32, seed=512)
    before = flash_attention_f32_hd.launches
    out = flash_attention(q, k, v)
    ref = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_f32_hd.launches == before + 1
    err = (out - ref).abs()
    assert err.mean().item() <= 1e-7 and err.max().item() <= 3e-6, (err.mean(), err.max())


# (batch, heads, q tokens, kv tokens, kv_valid, block_k, dtype)
PV8_HD_CASES = [
    (2, 3, 300, 300, None, 1024, torch.bfloat16),  # one span, padding bias
    (1, 5, 1000, 1000, 900, 256, torch.bfloat16),  # four spans, kv_valid
    (1, 4, 130, 2100, 2050, 1024, torch.float32),  # Sq != Skv, three spans, f32 out
    (1, 2, 130, 1000, 600, 256, torch.bfloat16),   # kv_valid empties the 4th span
    (1, 2, 64, 300, 129, 128, torch.bfloat16),     # one column into the 2nd span
]


@pytest.mark.parametrize("b,h,sq,skv,kv_valid,block_k,dtype", PV8_HD_CASES)
@pytest.mark.parametrize("hd", OTHER_DIMS + PADDED_DIMS)
def test_pv8_hd_kernel_matches_plain(dev, hd, b, h, sq, skv, kv_valid, block_k, dtype):
    """K6 at the other head dims against its plain version at K6's gates
    (max 1e-2, mean 1e-4); one launch of the head-dim kernel a call, none of
    the head_dim-64 one; two launches bit-identical."""
    q, k, v = _qkv(dev, (b, h, sq, hd), (b, h, skv, hd), dtype, seed=hd + sq + skv + 1)
    kw = dict(kv_valid=kv_valid, block_k=block_k)
    before, before64 = flash_attention_pv8_hd.launches, _counts(_64_COUNTED)
    out = flash_attention(q, k, v, fixed_max=True, qk_int8=True, pv_int8=True, **kw)
    again = flash_attention_pv8(q, k, v, **kw)
    ref = flash_attention_pv8_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_pv8_hd.launches == before + 2
    assert _counts(_64_COUNTED) == before64
    assert torch.equal(out, again)
    _check_fixed(out, ref, mean_bar=1e-4)


@pytest.mark.parametrize("hd", [16, 112, 24, 127])
def test_pv8_hd_kernel_negative_row_max_with_padding(dev, hd):
    """Every real score deeply negative behind padded columns: the -1e9 bias
    keeps the padding out of the running max; the result is the mean of v."""
    shape = (1, 2, 200, hd)
    q = torch.full(shape, 3.0, device=dev, dtype=torch.bfloat16)
    k = torch.full(shape, -3.0, device=dev, dtype=torch.bfloat16)
    v = _qkv(dev, shape, shape, torch.bfloat16, seed=3)[2]
    out = flash_attention_pv8(q, k, v, block_k=128)
    _check_fixed(out, flash_attention_pv8_plain(q, k, v, block_k=128), mean_bar=1e-4)
    mean_v = v.float().mean(dim=2, keepdim=True).expand(shape)
    assert (out.float() - mean_v).abs().max().item() <= v.float().abs().max().item() / 127


def test_ring_stripes_at_head_dim_16_match_one_call(dev):
    """ring_attention_stripes over 4 stripes at head_dim 16 (K3 hd,
    unnormalized, a shared bound) against one K3 call, at the gates of
    chip_smoke.py phase 22c: max abs 1e-2, mean 1e-3."""
    from aether_tpu_torch.ops.flash_attention import ring_attention_stripes

    q, k, v = _qkv(dev, (1, 3, 1000, 16), (1, 3, 1000, 16), torch.bfloat16, seed=16)
    before = flash_attention_fixed_max_hd.launches
    outs = ring_attention_stripes(q.chunk(4, dim=2), k.chunk(4, dim=2), v.chunk(4, dim=2))
    one = flash_attention_fixed_max(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_fixed_max_hd.launches == before + 4 * 4 + 1
    _check_fixed(torch.cat(outs, dim=2), one)


# ---- K5: GroupNorm moments ----

def _check_moments(got, ref):
    """m1 and m2 within 1e-5 of the plain version's, relative to max |m2|
    (f32 sums of the same elements in another order)."""
    scale = ref[1].abs().max().item()
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert (a - b).abs().max().item() <= 1e-5 * scale


K5_CASES = [
    # (B, C, T, H, W, dtype, channels_last)
    (1, 16, 2, 4, 6, torch.float32, False),      # the tiny config; 48 = no vector tail
    (2, 16, 3, 5, 7, torch.bfloat16, False),     # T*H*W = 105, not a multiple of 8
    (2, 512, 5, 32, 90, torch.bfloat16, False),  # the latent stage
    (1, 128, 3, 33, 17, torch.bfloat16, False),  # odd rows: unaligned row starts
    (2, 128, 2, 64, 90, torch.float32, False),   # f32 input
    (1, 16, 2, 4, 6, torch.float32, True),       # channels-last, tiny
    (2, 512, 5, 32, 90, torch.bfloat16, True),   # channels-last latent stage
    (2, 12, 3, 5, 7, torch.bfloat16, True),      # C not a multiple of the vector
    (1, 128, 2, 64, 90, torch.float16, True),    # f16
]


@pytest.mark.parametrize("b,c,t,h,w,dtype,channels_last", K5_CASES)
def test_groupnorm_moments_kernel_matches_plain(dev, b, c, t, h, w, dtype,
                                                channels_last):
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments, groupnorm_moments_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(b * c + t)
    x = (3.0 + 2.0 * torch.randn((b, c, t, h, w), generator=gen, device=dev)).to(dtype)
    if channels_last:
        x = x.to(memory_format=torch.channels_last_3d)
        assert not x.is_contiguous()
    c0 = x[:, :, 0, 0, 0].float()
    before = groupnorm_moments.launches
    got = groupnorm_moments(x, c0)
    again = groupnorm_moments(x, c0)
    torch.cuda.synchronize()
    assert groupnorm_moments.launches == before + 2
    _check_moments(got, groupnorm_moments_plain(x, c0))
    for a, b_ in zip(got, again):  # bit-identical repeats: no atomics
        assert torch.equal(a, b_)


def test_groupnorm_moments_large_mean_and_strided_refusal(dev):
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments, groupnorm_moments_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x = (500.0 + 0.5 * torch.randn((2, 32, 4, 16, 24), generator=gen, device=dev)
         ).to(torch.bfloat16)
    c0 = x[:, :, 0, 0, 0].float()
    _check_moments(groupnorm_moments(x, c0), groupnorm_moments_plain(x, c0))
    with pytest.raises(ValueError, match="contiguous or channels-last"):
        groupnorm_moments(x[:, :, :, :, ::2], c0)
    with pytest.raises(TypeError, match="K5"):
        groupnorm_moments(x.to(torch.float64), c0)


def test_group_norm_on_cuda_launches_k5(dev):
    from aether_tpu_torch.models.vae import group_norm
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    x = torch.randn((1, 64, 3, 16, 24), generator=gen, device=dev)
    scale, bias = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    before = groupnorm_moments.launches
    out = group_norm(x, scale, bias, 32, 1e-6)
    ref = group_norm(x.cpu(), scale.cpu(), bias.cpu(), 32, 1e-6)
    assert groupnorm_moments.launches == before + 1
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)


# ---- K7-K9: the flash-attention tuning variants ----

# (wrapper, (B, H, S), keyword arguments)
VARIANT_CASES = [
    ("flash_v2", (1, 3, 300), dict(block_q=128, block_k=128)),
    ("flash_v2", (1, 3, 300), dict(block_q=128, block_k=128, kt=True)),
    ("flash_v2", (1, 3, 300), dict(block_q=128, block_k=128, mask_last_only=False)),
    ("flash_v2", (2, 2, 1000), dict(block_q=256, block_k=512, kt=True)),
    ("flash_v2", (1, 2, 250), dict(block_q=100, block_k=100)),  # seq_pad 300 past 250 keys
    ("flash_v2", (1, 2, 700), dict(block_q=256, block_k=128, mask_last_only=False)),
    # K^T of 250 (and 301) keys: rows padded to 256 (304) columns for TMA
    ("flash_v2", (1, 2, 250), dict(block_q=100, block_k=100, kt=True)),
    ("flash_v2", (1, 2, 301), dict(block_q=128, block_k=128, kt=True, mask_last_only=False)),
    ("flash_v2", (2, 3, 1000), dict(block_q=512, block_k=512)),  # 1000 % 128, % 192 != 0
    ("flash_v2", (1, 3, 300), dict(block_q=128, block_k=128, sm_scale=0.3)),  # q fold
    ("flash_v2", (1, 3, 300), dict(block_q=128, block_k=128, kt=True, sm_scale=0.05)),
    ("flash_mh", (1, 8, 300), dict(block_q=128, block_k=192, hper=4)),  # lcm 384
    ("flash_mh", (1, 4, 300), dict(block_q=256, block_k=128, hper=2)),
    ("flash_mh", (1, 8, 2000), dict(block_q=1024, block_k=1024, hper=8)),
    ("flash_mh", (2, 8, 700), dict(block_q=256, block_k=128, hper=8)),  # two groups of 8
    # 16 q tiles x 12 groups: one full round of 132 items, 60 split by head
    ("flash_mh", (1, 48, 3000), dict(block_q=1024, block_k=1024, hper=4)),
    ("flash_mh", (1, 16, 500), dict(block_q=128, block_k=128, hper=16)),  # a head a CTA
    ("flash_mh", (1, 6, 1000), dict(block_q=1024, block_k=1024, hper=1)),
    ("flash_x", (1, 2, 300), dict(block_q=256, block_k=128, mode="fold")),
    ("flash_x", (1, 2, 300), dict(block_q=256, block_k=128, mode="fold2")),
    ("flash_x", (1, 2, 300), dict(block_q=256, block_k=128, mode="padfix")),
    ("flash_x", (1, 2, 300), dict(block_q=256, block_k=128, mode="padfix_exp")),
    ("flash_x", (1, 2, 2000), dict(block_q=1024, block_k=256, mode="padfix")),  # pad over 2 blocks
    ("flash_x", (1, 2, 250), dict(block_q=100, block_k=100, mode="padfix")),  # and the tile's pad
    # pad 948 over four JAX blocks and eight 128-column tiles, five wholly
    # TMA's zero fill
    ("flash_x", (1, 2, 1100), dict(block_q=1024, block_k=256, mode="padfix")),
    ("flash_x", (1, 2, 1100), dict(block_q=1024, block_k=256, mode="padfix_exp")),
    ("flash_x", (2, 2, 1000), dict(block_q=1024, block_k=1024, mode="fold")),
]


@pytest.mark.parametrize("name,shape,kw", VARIANT_CASES)
def test_flash_variants_kernel_matches_plain(dev, name, shape, kw):
    fn, plain = getattr(fv, name), getattr(fv, f"{name}_plain")
    b, h, s = shape
    q, k, v = _qkv(dev, (b, h, s, HD), (b, h, s, HD), torch.bfloat16, seed=s + h)
    before = fn.launches
    out = fn(q, k, v, **kw)
    ref = plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _check_fixed(out, ref)


@pytest.mark.parametrize("mode", ["fold", "fold2", "padfix", "padfix_exp"])
def test_flash_variants_kernel_deeply_negative_scores(dev, mode):
    """Every real score far below 0: the masking modes give the mean of v;
    padfix cancels l to 0 and gives 0, as its plain version does."""
    shape = (1, 2, 300, HD)
    q = torch.full(shape, 5.0, device=dev, dtype=torch.bfloat16)
    k = torch.full(shape, -5.0, device=dev, dtype=torch.bfloat16)
    v = _qkv(dev, shape, shape, torch.bfloat16, seed=3)[2]
    kw = dict(block_q=256, block_k=128, mode=mode)
    out = fv.flash_x(q, k, v, **kw)
    _check_fixed(out, fv.flash_x_plain(q, k, v, **kw))
    if mode.startswith("padfix"):
        assert not out.any()


def test_flash_variants_kernel_alone_matches_its_wrapper(dev):
    """The kernel on the operands the wrapper prepares (K^T padded) writes
    the wrapper's output; the launch alone does not count."""
    q, k, v = _qkv(dev, (1, 2, 301, HD), (1, 2, 301, HD), torch.bfloat16, seed=8)
    args = fv._v2_args(q, block_q=128, block_k=128, kt=True)
    assert args.k_row == 304 and args.kv_end == args.sq == 301 and args.pad == 0
    ops = fv._kernel_operands(q, k, v, args)
    assert ops[1].shape == (2, HD, 304) and not ops[1][:, :, 301:].any()
    out = torch.empty_like(ops[0])
    before = fv.flash_v2.launches
    fv._kernel_launch(*ops, out, args)
    assert fv.flash_v2.launches == before
    ref = fv.flash_v2(q, k, v, block_q=128, block_k=128, kt=True)
    torch.cuda.synchronize()
    assert torch.equal(out.view(ref.shape), ref)


def test_flash_variants_kernel_refuses_unbuilt_switches(dev):
    """Only the switch combinations the wrappers reach are built: exp with
    K^T, or the heads walk with exp, returns an error instead of launching."""
    q, k, v = _qkv(dev, (1, 2, 300, HD), (1, 2, 300, HD), torch.bfloat16, seed=9)
    good = fv._v2_args(q, block_q=128, block_k=128, kt=True)
    for args in (good._replace(exp2=False),
                 fv._mh_args(q, block_q=128, block_k=128, hper=2)._replace(exp2=False),
                 fv._mh_args(q, block_q=128, block_k=128, hper=2)._replace(k_row=304)):
        ops = fv._kernel_operands(q, k, v, args)
        with pytest.raises(RuntimeError, match="aether_flash_variants"):
            fv._kernel_launch(*ops, torch.empty_like(ops[0]), args)


def test_flash_variants_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(dev, (1, 3, 300, HD), (1, 3, 300, HD), torch.bfloat16, seed=0)
    for fn in (fv.flash_v2, fv.flash_mh, fv.flash_x):
        kw = dict(hper=1) if fn is fv.flash_mh else {}
        with pytest.raises(TypeError, match="K7-K9"):
            fn(q.float(), k.float(), v.float(), block_q=128, block_k=128, **kw)
        wide = torch.zeros((1, 2, 300, 128), device=dev, dtype=torch.bfloat16)
        with pytest.raises(NotImplementedError, match="head_dim"):
            fn(wide, wide, wide, block_q=128, block_k=128, **kw)
    with pytest.raises(ValueError, match="divisible by hper"):
        fv.flash_mh(q, k, v, hper=2)
    with pytest.raises(ValueError, match="mask_last_only"):
        fv.flash_v2(q, k, v, block_q=256, block_k=128)


# ---- the weight formats: int8_mm (torch._int_mm) and QuantLinear ----

@pytest.mark.parametrize("m,k,n", [(17, 64, 8), (300, 3072, 192), (33, 256, 64)])
def test_int8_mm_matches_plain(dev, m, k, n):
    from aether_tpu_torch.models.dit import int8_mm, int8_mm_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    before = int8_mm.launches
    got = int8_mm(a, w.t())
    assert int8_mm.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, int8_mm_plain(a, w.t()))
    assert torch.equal(got.cpu(), int8_mm_plain(a.cpu(), w.t().cpu()))


def test_int8_mm_refuses_what_int_mm_does_not_take(dev):
    from aether_tpu_torch.models.dit import int8_mm

    ok = torch.zeros((32, 64), dtype=torch.int8, device=dev)
    w = torch.zeros((64, 16), dtype=torch.int8, device=dev)
    before = int8_mm.launches
    with pytest.raises(ValueError, match="m > 16"):
        int8_mm(ok[:16], w)
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_mm(ok[:, :60], w[:60])
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_mm(ok, w[:, :12])
    with pytest.raises(TypeError, match="int8"):
        int8_mm(ok.float(), w)
    assert int8_mm.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_linear_on_cuda_matches_cpu(dev, dtype):
    """w8a8: the same codes, int32 sums and f32 epilogue on both devices, so
    the same bits; weight-only fp8 and int8: the product in another order
    (f32 accumulation), within 1e-5 of the output's scale (f32) or one bf16
    rounding (bf16)."""
    from aether_tpu_torch.models.dit import QuantLinear

    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 40, 256), generator=gen).to(dtype)
    w = torch.randn((96, 256), generator=gen) / 16.0
    b = torch.randn(96, generator=gen) * 0.1
    for codes, fmax in ((torch.int8, 127.0), (torch.float8_e4m3fn, 448.0)):
        s = w.abs().amax(dim=1) / fmax
        scaled = w / s[:, None]
        q = (torch.round(scaled) if codes == torch.int8 else scaled).to(codes)
        cpu = QuantLinear(q, s, b)
        gpu = QuantLinear(q.to(dev), s.to(dev), b.to(dev))
        for a8 in (False, True):
            with torch.no_grad():
                want, got = cpu(x, a8), gpu(x.to(dev), a8).cpu()
            assert got.dtype == dtype and got.shape == want.shape
            if a8 and codes == torch.int8:
                assert torch.equal(got, want)
            else:
                tol = 1e-5 if dtype == torch.float32 else 2 ** -7
                torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                           atol=tol * want.float().abs().max().item())


def test_quantized_dit_on_cuda_runs_w8a8(dev):
    """An int8 DiT at head_dim 64 (two heads, two blocks) on the card with
    act_quant: four int8 products a block (qkv, o, w1, w2), K1 and K2 once a
    block, finite output near the weight-only one."""
    import dataclasses

    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.models.dit import init_quantized_dit, int8_mm

    cfg = dataclasses.replace(DiTConfig.tiny(), num_heads=2, head_dim=64)
    model = init_quantized_dit(cfg, torch.int8, device=dev, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    hidden = torch.randn((1, 3, cfg.in_channels, 8, 12), generator=gen, device=dev).to(
        torch.bfloat16)
    text = torch.randn((1, cfg.max_text_seq_length, cfg.text_embed_dim), generator=gen,
                       device=dev).to(torch.bfloat16)
    t = torch.tensor([500], device=dev)
    before, k1 = int8_mm.launches, qkv_prologue.launches
    with torch.no_grad():
        a8 = model(hidden, text, t, act_quant=True).float()
        ref = model(hidden, text, t).float()
    assert int8_mm.launches == before + 4 * cfg.num_layers
    assert qkv_prologue.launches == k1 + 2 * cfg.num_layers
    assert torch.isfinite(a8).all()
    assert ((a8 - ref).norm() / ref.norm()).item() < 0.05


@pytest.mark.parametrize("codes", [torch.int8, torch.float8_e4m3fn])
def test_quantize_dit_on_cuda_matches_cpu(dev, codes):
    """Codes and scales bit-identical on both devices (every division a
    correctly rounded one), so a DiT quantized on the card equals one
    converted on the CPU."""
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.models.dit import init_dit, quantize_dit

    cfg = DiTConfig.tiny()
    cpu = quantize_dit(init_dit(cfg, dtype=torch.bfloat16, seed=3), codes)
    gpu = quantize_dit(init_dit(cfg, dtype=torch.bfloat16, seed=3).to(dev), codes)
    want, got = cpu.state_dict(), gpu.state_dict()
    for name, w in want.items():
        g = got[name].cpu()
        assert g.dtype == w.dtype, name
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8)), name

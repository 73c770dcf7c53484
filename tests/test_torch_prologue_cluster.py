"""K1's launch plan and its cluster decomposition, on the CPU, at every head
dim the kernel takes (every even one below 128: its instances at the widths
16 to 128 in steps of 16, a head dim between two running the next one up).

The Hopper kernel of ``qkv_prologue`` (``csrc/attn_prologue.cu``, one
template over the head dim) spreads one quantization cell (hper heads x
block tokens of q or k) over a thread-block cluster of ``block / rows`` CTAs
of ``rows`` rows each (256, 128 or 64 by head dim), and reduces the
cell's absmax and row-norm maximum across the cluster. The card runs the
kernel itself (``tests/test_torch_cuda.py``, ``chip_smoke.py``); here the
plan that the wrapper hands it (``_launch_plan``, decoded CTA by CTA as the
kernel decodes it, ``_cta_job``) is checked to cover every (head, row)
exactly once with every cluster inside one cell and its shared memory under
227 KB. ``_emulate`` is a model of the kernel in torch: the CTAs of the plan
reading their boxes from the fused projection, the kernel's own arithmetic
(its lanes' split of a row, the moments in double in its summation tree and
divided by the head dim, the row norms in its lanes' order, codes rounded
as its FMA-pipe trick rounds them), per-CTA maxima combined by the cluster
maximum, each CTA quantizing its own rows. It is held to
``qkv_prologue_plain`` (bit for bit but the row-norm maxima) and to the
Pallas kernel in interpret mode at the tolerances of
``tests/test_torch_ops.py::test_prologue_plain_matches_pallas``. These cases
check the kernel's design as written down in Python, not the CUDA code: the
card cases of ``tests/test_torch_cuda.py`` check that. The head_dim-64 cases
keep their names; ``*_hd`` cases take the other head dims, ``*_ragged`` the
head dims below their instance's width: boxes of the width read from column
h * head_dim (the next head's columns past it, masked to zero in the
kernel's arithmetic; TMA's zeros past the last head of a tensor; at a head
dim that is no multiple of 8 the card reads a copy whose heads lie a
multiple of 8 columns apart, zeros between them, which the same masking
makes no different), the
moments divided by the true head dim, and q, k and v written at the width
with zero columns past the head dim.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aether_tpu.ops.attn_prologue import qkv_prologue as jax_qkv_prologue
from aether_tpu_torch.config import DiTConfig
from aether_tpu_torch.ops import attn_prologue
from aether_tpu_torch.ops.attn_prologue import (
    _LOG2E,
    _launch_plan,
    _pick_pad_and_block,
    qkv_prologue_plain,
)
from aether_tpu_torch.ops.flash_attention import _heads_per_cell

torch.set_num_threads(1)

HD = 64
OTHER_HDS = (16, 32, 48, 80, 96, 112)
RAGGED_HDS = (2, 8, 24, 72, 120, 126)  # widths 16, 16, 32, 80, 128, 128
EPS = 1e-6
SMEM_LIMIT = 227 * 1024


def _cta_job(plan, x, y):
    """What CTA (x, y) of ``plan`` does, as ``csrc/attn_prologue.cu``
    decodes its block index: (tensor 0 q / 1 k / 2 v, head group, token
    tile, rank in its cluster, first row, the head indices of its boxes)."""
    tensor, g = y % 3, y // 3
    heads = tuple(g * plan.hper + j for j in range(plan.hper))
    return tensor, g, x // plan.cluster, x % plan.cluster, x * plan.rows, heads


def _plan(b, nh, s, block_q, heads_per_cell, hd=HD):
    bh = b * nh
    hper = _heads_per_cell(bh, heads_per_cell)
    s_pad, block = _pick_pad_and_block(s, block_q)
    return bh, s_pad, block, _launch_plan(bh, s_pad, block, hper, hd)


# (batch, heads, tokens S_in, s_valid, block_q, heads_per_cell)
PLAN_CASES = [
    (1, 4, 300, None, 1024, 4),     # one 384-row tile: a cluster of 3
    (2, 6, 300, 250, 1024, 4),      # hper 4, groups straddle the batches; s_valid mid-CTA
    (2, 3, 300, 200, 1024, 4),      # hper 3
    (1, 2, 1700, 1650, 1024, 4),    # hper 2, block 1024: clusters of 8, S_in < s_pad
    (1, 5, 1700, None, 1024, 4),    # hper 1 (5 heads)
    (2, 6, 1000, 999, 128, 4),      # block 128: clusters of 1
    (1, 48, 15076, 15076, 1024, 4),  # the AetherV1 window, unpadded
]


def _check_covers_every_row_once(b, nh, s, block_q, hpc, hd):
    bh, s_pad, block, plan = _plan(b, nh, s, block_q, hpc, hd)
    assert plan.block == block and plan.head_dim == hd and plan.rows in (64, 128, 256)
    assert plan.width == -(-hd // 16) * 16
    assert 1 <= plan.cluster <= {64: 16, 128: 8, 256: 4}[plan.rows]
    assert plan.cluster * plan.rows == block
    assert plan.hper * plan.rows * plan.width * 2 < plan.smem_bytes <= SMEM_LIMIT
    assert plan.grid == (s_pad // plan.rows, 3 * (bh // plan.hper))
    assert plan.grid[0] % plan.cluster == 0
    covered = np.zeros((3, bh, s_pad), np.int64)
    clusters = {}
    for y in range(plan.grid[1]):
        for x in range(plan.grid[0]):
            tensor, g, t, rank, row0, heads = _cta_job(plan, x, y)
            assert heads == tuple(range(g * plan.hper, (g + 1) * plan.hper))
            assert row0 == t * block + rank * plan.rows
            for h in heads:
                covered[tensor, h, row0:row0 + plan.rows] += 1
            cell = clusters.setdefault((y, x // plan.cluster), (tensor, g, t, set()))
            assert cell[:3] == (tensor, g, t)
            cell[3].add(rank)
    assert (covered == 1).all()
    assert all(ranks == set(range(plan.cluster)) for *_, ranks in clusters.values())
    # one cluster a (tensor, group, tile)
    assert len({v[:3] for v in clusters.values()}) == len(clusters) == (
        3 * (bh // plan.hper) * (s_pad // block))
    if nh * b % 4 == 0 and nh % 4:
        # some group holds heads of two batch elements
        assert any(len({h // nh for h in _cta_job(plan, 0, y)[5]}) == 2
                   for y in range(plan.grid[1]))


@pytest.mark.parametrize("b,nh,s,s_valid,block_q,hpc", PLAN_CASES)
def test_launch_plan_covers_every_row_once(b, nh, s, s_valid, block_q, hpc):
    """The grid's CTAs cover every (tensor, head, row) of [3, B*H, s_pad]
    exactly once, and each cluster (consecutive x at one y) is one cell."""
    _check_covers_every_row_once(b, nh, s, block_q, hpc, HD)
    assert _plan(b, nh, s, block_q, hpc)[3].rows == 128


@pytest.mark.parametrize("hd", OTHER_HDS)
@pytest.mark.parametrize("b,nh,s,s_valid,block_q,hpc", PLAN_CASES)
def test_launch_plan_covers_every_row_once_hd(b, nh, s, s_valid, block_q, hpc, hd):
    """The same at the other head dims, with the CTA rows the plan takes
    there."""
    _check_covers_every_row_once(b, nh, s, block_q, hpc, hd)


@pytest.mark.parametrize("hd", RAGGED_HDS)
@pytest.mark.parametrize("b,nh,s,s_valid,block_q,hpc", PLAN_CASES)
def test_launch_plan_covers_every_row_once_ragged(b, nh, s, s_valid, block_q, hpc, hd):
    """The same at head dims below their instance's width: the plan, rows
    and shared memory of the width."""
    _check_covers_every_row_once(b, nh, s, block_q, hpc, hd)


@pytest.mark.parametrize("hd", (16, 32))
@pytest.mark.parametrize("b,nh,s,s_valid,block_q,hpc", PLAN_CASES)
def test_launch_plan_covers_every_row_once_128_rows(monkeypatch, b, nh, s, s_valid, block_q,
                                                    hpc, hd):
    """128-row CTAs at 16 and 32, which the kernel also builds for tiles that
    are no multiple of 256, at every tile."""
    monkeypatch.setitem(attn_prologue._CTA_ROWS, hd, 128)
    _check_covers_every_row_once(b, nh, s, block_q, hpc, hd)
    assert _plan(b, nh, s, block_q, hpc, hd)[3].rows == 128


@pytest.mark.parametrize("hd,block,rows,cluster", [
    (16, 1024, 256, 4), (16, 512, 256, 2), (16, 384, 128, 3), (32, 768, 256, 3),
    (32, 128, 128, 1), (48, 1024, 128, 8), (80, 1024, 128, 8), (96, 384, 128, 3),
    (112, 1024, 64, 16), (112, 384, 64, 6), (112, 128, 64, 2),
    (24, 1024, 256, 4), (8, 384, 128, 3), (72, 1024, 128, 8), (120, 1024, 64, 16),
    (126, 128, 64, 2)])
def test_launch_plan_rows_by_head_dim(hd, block, rows, cluster):
    """The CTA rows the plan takes, as the kernel builds them: 256 at widths
    16 and 32 where the tile is a multiple of 256 (else 128), 128 at 48-96,
    64 at 112 and 128 in clusters of up to 16; a head dim below its width
    (24, 8, 72, 120, 126) takes its width's."""
    plan = _launch_plan(8, 2048 if 2048 % block == 0 else 3 * block, block, 4, hd)
    assert (plan.rows, plan.cluster) == (rows, cluster)


@pytest.mark.parametrize("kw,match", [
    (dict(bh=10, s_pad=1024, block=1024, hper=5), "head groups"),
    (dict(bh=8, s_pad=1024, block=1024, hper=3), "head groups"),
    (dict(bh=8, s_pad=768, block=384 - 64, hper=4), "token tiles"),
    (dict(bh=8, s_pad=4096, block=2048, hper=4), "token tiles"),
    (dict(bh=8, s_pad=1024, block=1024, hper=4, strides=(3 * 512 * 1024, 3 * 4 * 64 + 1)),
     "16-byte"),
    (dict(bh=8, s_pad=1024, block=1024, hper=4, ptrs=(0, 8, 16)), "16-byte"),
    (dict(bh=8, s_pad=1536, block=1024, hper=4), "multiple"),
    (dict(bh=8, s_pad=1024, block=1024, hper=4, head_dim=128), "head_dim"),
    (dict(bh=8, s_pad=1024, block=1024, hper=4, head_dim=25), "head_dim"),
    (dict(bh=8, s_pad=4096, block=2048, hper=4, head_dim=112), "token tiles"),
])
def test_launch_plan_refuses_what_the_kernel_does_not_take(kw, match):
    with pytest.raises(ValueError, match=match):
        _launch_plan(**kw)


@pytest.mark.parametrize("b", [1, 2])
def test_shipped_config_passes_the_plan(b):
    """The AetherV1 DiT's fused projection: q/k/v column views of one [B,
    S_pad, 3 * 3072] bf16 tensor, at batch 1 (reconstruction) and 2 (the
    CFG pair)."""
    cfg = DiTConfig.aetherv1()
    nh, d = cfg.num_heads, cfg.num_heads * cfg.head_dim
    assert cfg.head_dim == HD
    s = 15076
    s_pad, block = _pick_pad_and_block(s, 1024)
    stride_s = 3 * d
    stride_b = s_pad * stride_s
    plan = _launch_plan(b * nh, s_pad, block, _heads_per_cell(b * nh, 4),
                        strides=(stride_b, stride_s), ptrs=(0, 2 * d, 4 * d))
    assert (plan.cluster, plan.hper, plan.grid) == (8, 4, (120, 3 * 12 * b))


def _lanes(width):
    """(lanes a (row, head), columns a lane), as the kernel's Split<D> at the
    instance's width: 16-byte chunks of 8 columns where the width is a power
    of two, else eight lanes of width / 8 columns."""
    lanes = width // 8 if width & (width - 1) == 0 else 8
    return lanes, width // lanes


def _tree_sum(v):
    """Sum over the last axis as the kernel's tree_sum nests its adds: the
    first (largest power of two below n) terms and the rest, each the same
    way. Over 2^k terms a full binary tree of neighbours, as the lanes'
    butterfly pairs them."""
    n = v.shape[-1]
    if n == 1:
        return v[..., 0]
    h = 1
    while 2 * h < n:
        h *= 2
    return _tree_sum(v[..., :h]) + _tree_sum(v[..., h:])


def _kernel_z(box, g, bias, cos, sin, hd):
    """z of one CTA's boxes [hper, rows, width] (f32) of head dim ``hd`` in
    the kernel's arithmetic: y = x - x[0] in f32, 0 at the columns past hd
    (``g``, ``bias`` and the tables are zero there); the moments in double, each lane's
    columns in adjacent pairs (d0 + d1, d0^2 + d1^2 rounded once), the pairs
    as a tree, the lanes as a tree (the butterfly), divided by hd and rounded
    to f32; inv = rcp_rn(sqrt_rn(var + eps)); ((y - mean) * inv) * gamma +
    beta, one rounding an operation; the pair rotation (z0 * c - z1 * s, z1 *
    c + z0 * s) against ``cos`` / ``sin`` [rows, hd] (zero past the
    tables), or None. Also returns each row's |z|^2 as the kernel sums it:
    two f32 fma chains a lane (even and odd columns), their sum, then the
    lanes' butterfly."""
    width = box.shape[-1]
    n_lanes, cols = _lanes(width)
    y = box - box[..., :1]
    y[..., hd:] = 0.0
    yd = y.double().unflatten(-1, (n_lanes, cols))
    d0, d1 = yd[..., 0::2], yd[..., 1::2]
    s1 = _tree_sum(_tree_sum(d0 + d1))
    s2 = _tree_sum(_tree_sum(d0 * d0 + d1 * d1))
    m1 = s1 / hd
    var = torch.clamp(s2 / hd - m1 * m1, min=0.0)
    mean, var = m1.float()[..., None], var.float()[..., None]
    inv = torch.reciprocal(torch.sqrt(var + EPS))
    z = ((y - mean) * inv) * g + bias
    if cos is not None:
        z0, z1 = z[..., 0::2], z[..., 1::2]
        rz = torch.empty_like(z)
        rz[..., 0::2] = z0 * cos[:, 0::2] + (-z1) * sin[:, 0::2]
        rz[..., 1::2] = z1 * cos[:, 1::2] + z0 * sin[:, 1::2]
        z = rz
    lanes = z.unflatten(-1, (n_lanes, cols))  # [hper, rows, lane, columns]
    chains = []
    for parity in (0, 1):
        acc = torch.zeros(lanes.shape[:-1])
        for e in range(parity, cols, 2):  # fma(z, z, acc): z * z is exact in double
            acc = (lanes[..., e].double() ** 2 + acc.double()).float()
        chains.append(acc)
    lane_n2 = chains[0] + chains[1]
    while lane_n2.shape[-1] > 1:
        lane_n2 = lane_n2[..., 0::2] + lane_n2[..., 1::2]
    return z, lane_n2[..., 0]


def _codes(z, r):
    """rint(z * r) as the kernel rounds it: f32 z * r plus 1.5 * 2^23 in the
    FMA pipe, the code the low byte of that float's bits."""
    t = (z * r) + torch.tensor(12582912.0)
    return (t.view(torch.int32) & 0xFF).to(torch.uint8).view(torch.int8)


def _emulate(xq, xk, xv, gq, bq, gk, bk, cos, sin, *, num_heads, s_valid, quantize, hd=HD):
    """qkv_prologue as the Hopper kernel computes it, CTA by CTA of the
    launch plan: the CTA's boxes (``plan.width`` columns) read from the
    fused [B, S_in, 3 * H * hd] projection at (column (bh % H) * hd of its
    tensor, first row, batch bh // H), zero past S_in and past the tensor's
    H * hd columns, and nothing for a CTA whose rows all lie past s_valid;
    z, its absmax and largest row |z|^2 over the CTA's valid rows
    (``_kernel_z``); the cluster's maxima over its ranks; each CTA's codes
    from its own z (``_codes``), or bf16 z * fold; v copied with rows >=
    s_valid and columns past hd zeroed. q, k and v come out ``plan.width``
    wide."""
    b, s, d = xq.shape
    bh = b * num_heads
    s_pad, block = _pick_pad_and_block(s, 1024)
    plan = _launch_plan(bh, s_pad, block, _heads_per_cell(bh, 4), hd)
    width = plan.width
    s_valid = s if s_valid is None else s_valid
    # each tensor's map: zero past S_in and past its own H * hd columns
    srcs = [torch.nn.functional.pad(x.float(), (0, width, 0, s_pad - s)) for x in (xq, xk, xv)]
    pad_cols = (lambda t: None if t is None
                else torch.nn.functional.pad(t.float(), (0, width - hd)))
    gq, bq, gk, bk = (pad_cols(t) for t in (gq, bq, gk, bk))
    if cos is not None:
        cos, sin = (torch.nn.functional.pad(pad_cols(t), (0, 0, 0, max(0, s_pad - t.shape[0])))
                    for t in (cos, sin))
    fold = hd ** -0.5 * _LOG2E
    groups, n_tiles = bh // plan.hper, s_pad // block
    rows = torch.arange(plan.rows)
    outs = [torch.zeros(bh, s_pad, width, dtype=torch.int8 if quantize else xq.dtype)
            for _ in range(2)] + [torch.zeros(bh, s_pad, width, dtype=xv.dtype)]
    stats = [torch.zeros(groups, n_tiles) for _ in range(4)]  # qsc, qn, ksc, kn
    for y in range(plan.grid[1]):
        tensor, g = y % 3, y // 3
        cells = {}
        for x in range(plan.grid[0]):
            _, _, t, _, row0, heads = _cta_job(plan, x, y)
            if row0 >= s_valid:
                continue  # loads nothing, publishes zeros, writes zeros
            col0 = [(h % num_heads) * hd for h in heads]
            box = torch.stack([srcs[tensor][h // num_heads, row0:row0 + plan.rows,
                                            c:c + width] for h, c in zip(heads, col0)])
            valid = (row0 + rows < s_valid)[:, None]
            if tensor == 2:
                keep = valid & (torch.arange(width) < hd)
                outs[2][list(heads), row0:row0 + plan.rows] = torch.where(
                    keep, box, torch.zeros(())).to(xv.dtype)
                continue
            gam, bet = (gq, bq) if tensor == 0 else (gk, bk)
            z, n2 = _kernel_z(box, gam, bet,
                              None if cos is None else cos[row0:row0 + plan.rows],
                              None if sin is None else sin[row0:row0 + plan.rows], hd)
            pub = (torch.where(valid, z.abs(), torch.zeros(())).amax(),
                   torch.where(valid[:, 0], n2, torch.zeros(())).amax())
            cells.setdefault(t, []).append((x, heads, row0, valid, z, pub))
        for t, ctas in cells.items():
            cell_amax = max(c[5][0] for c in ctas)  # the cluster's maxima
            cell_n2 = max(c[5][1] for c in ctas)
            f = fold if tensor == 0 else 1.0
            stats[2 * tensor][g, t] = cell_amax * (f / 127.0)
            stats[2 * tensor + 1][g, t] = torch.sqrt(cell_n2) * f
            # 127 / amax correctly rounded, as the kernel's __fdiv_rn (a
            # Python 127.0 / t is 127 * reciprocal(t), two roundings)
            r = (torch.full((), 127.0) / torch.clamp(cell_amax, min=1e-30) if cell_amax > 0
                 else torch.zeros(()))
            for _, heads, row0, valid, z, _ in ctas:
                z = torch.where(valid, z, torch.zeros(()))
                outs[tensor][list(heads), row0:row0 + plan.rows] = (
                    _codes(z, r) if quantize else (z * f).to(xq.dtype))
    return (*outs, *stats, s_pad)


B, S, NH = 2, 300, 6  # hper 4: groups straddle the two batch elements; clusters of 3


@functools.lru_cache(maxsize=None)
def _data(hd):
    rng = np.random.default_rng(11 if hd == HD else 11 + hd)
    d = NH * hd
    xq, xk, xv = (rng.standard_normal((B, S, d)).astype(np.float32) for _ in range(3))
    gq, gk = ((1.0 + 0.1 * rng.standard_normal((hd,))).astype(np.float32) for _ in range(2))
    bq, bk = ((0.1 * rng.standard_normal((hd,))).astype(np.float32) for _ in range(2))
    ang = rng.standard_normal((S - 20, hd // 2)) * 0.5  # tables shorter than the tokens
    cos = np.repeat(np.cos(ang), 2, axis=1).astype(np.float32)
    sin = np.repeat(np.sin(ang), 2, axis=1).astype(np.float32)
    return xq, xk, xv, gq, bq, gk, bk, cos, sin


@pytest.fixture(scope="module")
def data():
    return _data(HD)


def _args(data, rope):
    arrays = list(data)
    if not rope:
        arrays[7] = arrays[8] = None
    return arrays


def _cut(got, hd):
    """The emulation's outputs with q, k and v cut to hd columns, after
    checking that the columns past hd are zero."""
    for a in got[:3]:
        assert not a[..., hd:].any()
    return [a[..., :hd] for a in got[:3]] + list(got[3:])


def _check_equals_plain(data, quantize, rope, s_valid, hd):
    t = [torch.from_numpy(a) if a is not None else None for a in _args(data, rope)]
    kw = dict(num_heads=NH, s_valid=s_valid, quantize=quantize)
    got = _cut(_emulate(*t, hd=hd, **kw), hd)
    ref = qkv_prologue_plain(*t, head_dim=hd, eps=EPS, **kw)
    assert got[7] == ref[7] == 384
    for i, (a, r) in enumerate(zip(got[:7], ref[:7])):
        assert a.dtype == r.dtype and a.shape == r.shape
        if i in (4, 6):  # qn, kn
            torch.testing.assert_close(a, r, rtol=1e-5, atol=0)
        else:
            assert torch.equal(a, r)
    if quantize:
        assert all(int(c.min()) >= -127 for c in got[:2])


def _check_matches_pallas(data, quantize, rope, s_valid, hd):
    arrays = _args(data, rope)
    j = [jnp.asarray(a) if a is not None else None for a in arrays]
    t = [torch.from_numpy(a) if a is not None else None for a in arrays]
    ref = jax_qkv_prologue(*j, num_heads=NH, head_dim=hd, eps=EPS, s_valid=s_valid,
                           quantize=quantize, interpret=True)
    got = _cut(_emulate(*t, num_heads=NH, s_valid=s_valid, quantize=quantize, hd=hd), hd)
    assert got[7] == ref[7]
    for a, r in zip(got[3:7], ref[3:7]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5)
    for a, r in zip(got[:2], ref[:2]):
        a, r = a.numpy(), np.asarray(r)
        assert a.dtype == r.dtype and a.shape == r.shape
        if quantize:
            diff = np.abs(a.astype(np.int32) - r.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        else:
            np.testing.assert_allclose(a, r, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2])[..., :hd])


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("s_valid", [None, 250])
def test_cluster_emulation_equals_plain(data, quantize, rope, s_valid):
    """The kernel's arithmetic and decomposition give the plain version's q,
    k, v and scales bit for bit (codes in [-127, 127]); the row-norm maxima,
    summed in the kernel's own order, within the card's rtol of 1e-5."""
    _check_equals_plain(data, quantize, rope, s_valid, HD)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("s_valid", [None, 250])
def test_cluster_emulation_matches_pallas(data, quantize, rope, s_valid):
    _check_matches_pallas(data, quantize, rope, s_valid, HD)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("s_valid", [None, 250])
@pytest.mark.parametrize("hd", OTHER_HDS)
def test_cluster_emulation_equals_plain_hd(hd, quantize, rope, s_valid):
    """The same at the other head dims: the lanes' split of the row, the
    moments divided by hd (not multiplied by a rounded 1 / hd) and the CTA
    rows the plan takes there."""
    _check_equals_plain(_data(hd), quantize, rope, s_valid, hd)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("hd", OTHER_HDS)
def test_cluster_emulation_matches_pallas_hd(hd, quantize, rope):
    """The Pallas kernel in interpret mode at a ragged s_valid (the plain
    version is held to it at every s_valid in tests/test_torch_ops.py)."""
    _check_matches_pallas(_data(hd), quantize, rope, 250, hd)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("s_valid", [None, 250])
@pytest.mark.parametrize("hd", RAGGED_HDS)
def test_cluster_emulation_equals_plain_ragged(hd, quantize, rope, s_valid):
    """The same at head dims below their instance's width: q, k and v at
    the width, zero past hd, and their first hd columns the plain version's
    bit for bit; the moments over the true hd."""
    _check_equals_plain(_data(hd), quantize, rope, s_valid, hd)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("hd", RAGGED_HDS)
def test_cluster_emulation_matches_pallas_ragged(hd, quantize, rope):
    """The Pallas kernel in interpret mode at the head dim itself (its blocks
    take the full head dim), against the padded emulation cut to it."""
    _check_matches_pallas(_data(hd), quantize, rope, 250, hd)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("hd", (16, 32))
def test_cluster_emulation_256_rows_equals_plain(hd, quantize):
    """CTAs of 256 rows: 2000 tokens (s_valid 1950) in two 1024-token tiles,
    each a cluster of 4; the last CTA holds the ragged rows and rows past
    S_in."""
    rng = np.random.default_rng(hd)
    arrays = [rng.standard_normal((1, 2000, 4 * hd)).astype(np.float32) for _ in range(3)]
    for _ in range(2):  # gamma, beta of q, then of k
        arrays += [(1.0 + 0.1 * rng.standard_normal((hd,))).astype(np.float32),
                   (0.1 * rng.standard_normal((hd,))).astype(np.float32)]
    ang = rng.standard_normal((1900, hd // 2))
    arrays += [np.repeat(np.cos(ang), 2, 1).astype(np.float32),
               np.repeat(np.sin(ang), 2, 1).astype(np.float32)]
    t = [torch.from_numpy(a) for a in arrays]
    kw = dict(num_heads=4, s_valid=1950, quantize=quantize)
    assert _plan(1, 4, 2000, 1024, 4, hd)[3].rows == 256
    got = _cut(_emulate(*t, hd=hd, **kw), hd)
    ref = qkv_prologue_plain(*t, head_dim=hd, eps=EPS, **kw)
    for i, (a, r) in enumerate(zip(got[:7], ref[:7])):
        if i in (4, 6):
            torch.testing.assert_close(a, r, rtol=1e-5, atol=0)
        else:
            assert torch.equal(a, r)

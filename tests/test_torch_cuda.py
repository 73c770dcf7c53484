"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present (a CPU-only
machine). ``chip_smoke.py`` checks the kernels at the main-path shape; these
cases cover the edges it does not reach: batch > 1, head groups that straddle
two batch elements, several token tiles with a ragged ``s_valid``, no RoPE,
RoPE tables shorter than the sequence, and the launch-or-raise contract. The
card's machine has no JAX, so run them without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from aether_tpu_torch.ops.attn_prologue import (
    fused_joint_attention,
    qkv_prologue,
    qkv_prologue_plain,
)
from aether_tpu_torch.ops.flash_attention import (
    flash_attention_prepacked,
    flash_attention_prepacked_plain,
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


def _inputs(dev, b, s, nh, rope_rows, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d = nh * HD
    y = torch.randn((b, s, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
    xs = (y[..., :d], y[..., d:2 * d], y[..., 2 * d:])
    norms = [1.0 + 0.1 * torch.randn(HD, generator=gen, device=dev),
             0.1 * torch.randn(HD, generator=gen, device=dev),
             1.0 + 0.1 * torch.randn(HD, generator=gen, device=dev),
             0.1 * torch.randn(HD, generator=gen, device=dev)]
    if rope_rows:
        ang = torch.randn((rope_rows, HD // 2), generator=gen, device=dev)
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


def test_fused_attention_counts_and_refuses_float_mode(dev):
    xs, norms, rope = _inputs(dev, 1, 300, 4, 300)
    kw = dict(num_heads=4, head_dim=HD, eps=1e-6)
    before = (qkv_prologue.launches, flash_attention_prepacked.launches)
    out = fused_joint_attention(*xs, *norms, *rope, **kw)
    assert out.shape == (1, 300, 4 * HD) and out.dtype == torch.bfloat16
    assert (qkv_prologue.launches - before[0],
            flash_attention_prepacked.launches - before[1]) == (1, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_joint_attention(*xs, *norms, *rope, quantize=False, **kw)

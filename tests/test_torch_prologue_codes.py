"""K1's int8 codes on half-way points: the plain PyTorch version against the
Pallas kernel in interpret mode, bit for bit (CPU).

With the norm scale 0 the normalized row is the bias exactly, so every
token of every head holds the same values and a cell's max |z| is the
bias's. The bias holds 4.21875 and +-2.109375, half of it: 2.109375 * 127 /
4.21875 is 63.5, and its code depends on the last bit of 127 / 4.21875. The
kernels divide correctly rounded (30.103704) and code it 64; 127 *
reciprocal(4.21875) (30.103703) would code it 63.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aether_tpu.ops.attn_prologue import qkv_prologue as jax_qkv_prologue
from aether_tpu_torch.ops.attn_prologue import qkv_prologue, qkv_prologue_plain

torch.set_num_threads(1)

B, S, NH = 1, 300, 4
TOP, HALF = 4.21875, 2.109375


def _inputs(hd):
    rng = np.random.default_rng(19)
    xq, xk, xv = (rng.standard_normal((B, S, NH * hd)).astype(np.float32) for _ in range(3))
    bias = rng.uniform(-TOP, TOP, hd).astype(np.float32)
    bias[:3] = (TOP, HALF, -HALF)
    scale = np.zeros(hd, np.float32)
    return xq, xk, xv, scale, bias, scale, bias


@pytest.mark.parametrize("hd", [64, 16, 8, 24, 72, 120, 126])
def test_prologue_plain_int8_codes_bit_equal_on_half_way_points(hd):
    assert HALF * 2 == TOP  # 127 * HALF / TOP is 63.5: a half-way code
    arrays = _inputs(hd)
    kw = dict(num_heads=NH, head_dim=hd, eps=1e-6, s_valid=S, quantize=True)
    ref = jax_qkv_prologue(*(jnp.asarray(a) for a in arrays), None, None, interpret=True, **kw)
    got = qkv_prologue_plain(*(torch.from_numpy(a) for a in arrays), None, None, **kw)
    assert got[7] == ref[7]
    for name, a, b in (("q", got[0], ref[0]), ("k", got[1], ref[1])):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype == np.int8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=f"{name} codes")
        # every valid token of every head: 127, then the half-way pair
        assert (a[:, :S, :3] == np.array([127, 64, -64], np.int8)).all(), name
    # the CPU wrapper is the plain version
    wrapped = qkv_prologue(*(torch.from_numpy(a) for a in arrays), None, None, **kw)
    assert all(torch.equal(x, y) for x, y in zip(wrapped[:2], got[:2]))

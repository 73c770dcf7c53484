"""K5, the GroupNorm moments, and the VAE's ``group_norm`` in the port,
against the JAX package (CPU).

``groupnorm_moments_plain`` (NCTHW) is held against the Pallas kernel run in
interpret mode on the same seeded numpy input permuted to its channels-last
layout: both are f32 sums over the same elements in different orders, so
they agree to 1e-6 relative / 1e-5 absolute (1e-4 on second moments of
~1e1). The port's ``group_norm`` is held against the JAX ``group_norm`` at
2e-5 on unit-scale outputs. The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here the wrapper takes
the plain version because the tensors lie on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aether_tpu.models.vae import group_norm as jax_group_norm
from aether_tpu.ops.groupnorm import groupnorm_moments as jax_moments
from aether_tpu_torch.models.vae import group_norm
from aether_tpu_torch.ops.groupnorm import (
    groupnorm_moments,
    groupnorm_moments_plain,
    launch_plan,
)

torch.set_num_threads(1)


def _ncthw(x_cl: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_cl.transpose(0, 4, 1, 2, 3)))


@pytest.mark.parametrize("shape,mean,std", [
    ((1, 2, 4, 6, 128), 0.0, 1.0),     # a shape the TPU kernel supports
    ((2, 3, 8, 24, 128), 3.0, 2.0),    # multi-tile grid
    ((1, 2, 4, 8, 256), 500.0, 0.5),   # a large-mean group: c0 bounds the cancellation
])
def test_moments_plain_matches_pallas_interpret(shape, mean, std):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(mean, std, size=shape).astype(np.float32)
    c0 = x[:, 0, 0, 0, :] if mean > 100 else rng.normal(size=(shape[0], shape[-1]))
    c0 = np.asarray(c0, np.float32)
    m1j, m2j = jax_moments(jnp.asarray(x), jnp.asarray(c0), interpret=True)
    m1t, m2t = groupnorm_moments_plain(_ncthw(x), torch.from_numpy(c0))
    assert m1t.dtype == m2t.dtype == torch.float32 and tuple(m1t.shape) == shape[:1] + shape[-1:]
    np.testing.assert_allclose(m1t.numpy(), np.asarray(m1j), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(m2t.numpy(), np.asarray(m2j), rtol=1e-6, atol=1e-4)


def test_moments_bf16_input_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 1.0, size=(1, 2, 8, 16, 128)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    c0 = np.zeros((1, 128), np.float32)
    m1j, m2j = jax_moments(xb, jnp.asarray(c0), interpret=True)
    xt = _ncthw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    m1t, m2t = groupnorm_moments(xt, torch.from_numpy(c0))
    np.testing.assert_allclose(m1t.numpy(), np.asarray(m1j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m2t.numpy(), np.asarray(m2j), rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    x = torch.randn(2, 16, 3, 5, 7, generator=torch.Generator().manual_seed(1))
    c0 = x[:, :, 0, 0, 0]
    before = groupnorm_moments.launches
    got = groupnorm_moments(x, c0)
    ref = groupnorm_moments_plain(x, c0)
    assert groupnorm_moments.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # a channels-last input gives the same moments
    cl = groupnorm_moments(x.to(memory_format=torch.channels_last_3d), c0)
    for a, b in zip(cl, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,c,n,channels_last,elem,aligned", [
    (2, 128, 9 * 256 * 720, False, 2, True),   # the 480p decode stage
    (2, 512, 5 * 32 * 90, False, 2, True),     # the latent stage
    (2, 128, 9 * 256 * 720, True, 2, True),
    (2, 512, 5 * 32 * 90, True, 2, True),
    (1, 16, 2 * 4 * 6, False, 4, True),        # the tiny config
    (1, 16, 2 * 4 * 6, True, 4, True),
    (2, 12, 1001, True, 2, True),              # C not a multiple of the vector
    (1, 512, 77, True, 2, False),              # unaligned input
    (1, 3000, 50, True, 4, True),              # more channel vectors than threads
])
def test_launch_plan_covers_every_element(b, c, n, channels_last, elem, aligned):
    splits, chunk, vec, g_tile = launch_plan(b, c, n, channels_last, elem, aligned)
    assert splits >= 1 and chunk % 8 == 0
    assert splits * chunk >= n and (splits - 1) * chunk < n
    assert 256 % g_tile == 0
    if channels_last:
        assert c % vec == 0 and vec in (1, 16 // elem)
        assert vec == 16 // elem or not aligned or c % (16 // elem)
        groups = c // vec
        assert g_tile <= groups
        tiles = -(-groups // g_tile)
        assert b * tiles * splits <= max(2 * 1056, b * tiles)
    else:
        assert vec == 1 and g_tile == 1
        assert b * c * splits <= max(2 * 1056, b * c)
    assert launch_plan(b, c, n, channels_last, elem, aligned) == (splits, chunk, vec, g_tile)


@pytest.mark.parametrize("shape,groups", [
    ((1, 2, 4, 6, 8), 4),       # tiny config: encoder stage, 8 channels
    ((1, 5, 8, 12, 16), 4),     # tiny config: the 16-channel stage
    ((2, 3, 4, 6, 128), 32),    # AetherV1's groups at its narrowest width
])
def test_group_norm_matches_jax(shape, groups):
    rng = np.random.default_rng(shape[-1] + shape[1])
    x = rng.normal(2.0, 3.0, size=shape).astype(np.float32)
    c = shape[-1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    ref = np.asarray(jax_group_norm(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias), groups, 1e-6))
    got = group_norm(_ncthw(x), torch.from_numpy(scale), torch.from_numpy(bias),
                     groups, 1e-6)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), ref, atol=2e-5)

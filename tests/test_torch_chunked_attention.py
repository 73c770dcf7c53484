"""Differentiable attention of the port against the JAX package (CPU).

``chunked_attention`` against ``aether_tpu.ops.chunked_attention``, and
``flash_attention_trainable`` (plain K4 forward on the CPU, blockwise
recompute backward) against the JAX custom_vjp with its Pallas forward run in
interpret mode, by the substitution ``tests/test_flash_attention.py`` uses.
Values and (dq, dk, dv) agree in f32 to 1e-5 of the reference's largest
magnitude: two f32 implementations of the same exact softmax, summed in
another order.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aether_tpu.ops.chunked_attention import (
    chunked_attention as jax_chunked_attention,
    flash_attention_trainable as jax_flash_attention_trainable,
)
from aether_tpu_torch.ops.chunked_attention import (
    chunked_attention,
    flash_attention_trainable,
)
from aether_tpu_torch.ops.flash_attention import attention_reference

torch.set_num_threads(1)

REL = 1e-5


def _close(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=REL * np.abs(ref).max(), rtol=0)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    return arrays[:3], arrays[3]  # q, k, v and a cotangent-weighting tensor


def _torch_value_and_grads(fn, arrays, w):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = fn(q, k, v)
    loss = torch.sum(out * torch.from_numpy(w)) + torch.sum(out * out)
    loss.backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


def _jax_value_and_grads(fn, arrays, w):
    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * w) + jnp.sum(out * out), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in arrays))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("shape,block_k", [
    ((1, 2, 192, 32), 1024),   # one block
    ((2, 2, 200, 32), 64),     # ragged last block
    ((1, 5, 130, 64), 128),    # head groups of 4 and 1
])
def test_chunked_value_and_grads_match_jax(shape, block_k):
    arrays, w = _inputs(shape, seed=shape[2])
    out, grads = _torch_value_and_grads(
        lambda q, k, v: chunked_attention(q, k, v, block_k=block_k), arrays, w)
    ref, ref_grads = _jax_value_and_grads(
        lambda q, k, v: jax_chunked_attention(q, k, v, block_k=block_k), arrays, w)
    _close(out, ref)
    for g, r in zip(grads, ref_grads):
        _close(g, r)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX's flash_attention_trainable with its Pallas forward interpreted
    (sys.modules: the package re-exports a function of the submodule's name)."""
    fa = sys.modules["aether_tpu.ops.flash_attention"]
    orig = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: orig(*a, **kw, interpret=True))


@pytest.mark.parametrize("shape", [(1, 2, 192, 32), (2, 3, 200, 64)])
def test_flash_trainable_value_and_grads_match_jax(pallas_interpret, shape):
    arrays, w = _inputs(shape, seed=7)
    out, grads = _torch_value_and_grads(flash_attention_trainable, arrays, w)
    ref, ref_grads = _jax_value_and_grads(jax_flash_attention_trainable, arrays, w)
    _close(out, ref)
    for g, r in zip(grads, ref_grads):
        _close(g, r)


def test_flash_trainable_grads_match_plain_autograd():
    """The blockwise backward is the true gradient of softmax attention."""
    arrays, w = _inputs((1, 2, 160, 64), seed=3)
    out, grads = _torch_value_and_grads(flash_attention_trainable, arrays, w)
    ref, ref_grads = _torch_value_and_grads(attention_reference, arrays, w)
    _close(out, ref)
    for g, r in zip(grads, ref_grads):
        _close(g, r)

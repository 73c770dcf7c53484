"""Full-width parity of the port's int8 w8a8 qkv projection against the JAX
package (CPU).

``QuantLinear``'s fused int8 w8a8 qkv of one AetherV1 block (3072 -> 9216)
against the three JAX ``_linear(..., a8=True)`` products and JAX's own
fused projection, the oracle of ``tests/test_fullwidth_parity.py::
test_fused_qkv_int8_bitmatch_at_full_width``: the same converted full-width
block (``TorchDiTRef`` filled deterministically), the same input. The port
takes the block through ``io/from_jax.py`` as JAX ``quantize_dit_params``
codes, and again through its own ``quantize_dit`` of the float block; both
must give the JAX products bit for bit (per-token activation codes, int32
sums and the f32 epilogue are exact). The tiled VAE decode at full width is
``tests/test_torch_fullwidth_decode.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aether_tpu.models.dit import _linear, _qkv_fused_projection, quantize_dit_params
from aether_tpu_torch.config import DiTConfig
from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax
from aether_tpu_torch.models.dit import DiT, QuantLinear, dit_from_state_dict, quantize_dit

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _block():
    """The converted full-width block of ``test_fullwidth_parity`` as numpy."""
    from test_fullwidth_parity import _fullwidth_jax_params

    cfg, params = _fullwidth_jax_params()
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def test_quant_linear_w8a8_qkv_bit_equal_to_jax_at_full_width():
    jcfg, params = _block()
    cfg = DiTConfig(num_layers=1)
    d = cfg.hidden_size
    assert (d, jcfg.hidden_size, cfg.num_heads, cfg.head_dim) == (3072, 3072, 48, 64)
    qtree = quantize_dit_params(jax.tree_util.tree_map(jnp.asarray, params), dtype=jnp.int8)
    attn = jax.tree_util.tree_map(lambda x: x[0], qtree["blocks"]["attn"])
    x = np.random.default_rng(5).normal(size=(1, 64, d)).astype(np.float32)
    jx = jnp.asarray(x)
    want = [np.asarray(_linear(jx, attn[f"{n}_w"], attn[f"{n}_b"], True)) for n in "qkv"]
    fused = [np.asarray(y) for y in _qkv_fused_projection(jx, attn, a8=True)]
    assert all(np.array_equal(a, b) for a, b in zip(fused, want))  # the oracle's own claim

    converted = dit_from_state_dict(
        dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, qtree), cfg), cfg)
    own = DiT(cfg)
    own.load_state_dict(dit_state_dict_from_jax(params, cfg))
    quantize_dit(own, torch.int8)
    for model in (converted, own):
        qkv = model.blocks[0].attn.qkv
        assert isinstance(qkv, QuantLinear) and qkv.q.dtype == torch.int8
        assert tuple(qkv.q.shape) == (3 * d, d)
        with torch.no_grad():
            got = qkv(torch.from_numpy(x), True).numpy()
        assert got.shape == (1, 64, 3 * d) and got.dtype == np.float32
        for j, (name, ref) in enumerate(zip("qkv", want)):
            np.testing.assert_array_equal(got[..., j * d:(j + 1) * d], ref, err_msg=name)
    assert torch.equal(converted.blocks[0].attn.qkv.q, own.blocks[0].attn.qkv.q)
    assert torch.equal(converted.blocks[0].attn.qkv.s, own.blocks[0].attn.qkv.s)

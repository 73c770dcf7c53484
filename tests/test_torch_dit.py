"""DiT of the PyTorch port against ``aether_tpu.models.dit.dit_forward`` (CPU).

Tiny config, f32, the same JAX parameters on both sides (converted by
``aether_tpu_torch.io.from_jax``). The port runs its fused attention path with
the plain K1/K2 versions; the JAX side runs the fused prologue path with the
Pallas kernels interpreted, per block and at the output.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aether_tpu.config import DiTConfig as JaxDiTConfig
from aether_tpu.models.dit import dit_forward, init_dit_params
from aether_tpu.models.rope import prepare_rotary_positional_embeddings
from aether_tpu_torch.config import DiTConfig
from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax
from aether_tpu_torch.models.dit import DiT, init_dit

torch.set_num_threads(1)

F = 3


@pytest.fixture(scope="module")
def setup():
    cfg = JaxDiTConfig.tiny()
    params = init_dit_params(jax.random.PRNGKey(3), cfg)
    model = DiT(DiTConfig.tiny())
    model.load_state_dict(dit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), DiTConfig.tiny()))
    h, w = cfg.sample_height, cfg.sample_width
    rng = np.random.default_rng(5)
    hidden = rng.normal(size=(1, F, cfg.in_channels, h, w)).astype(np.float32)
    text = rng.normal(size=(1, cfg.max_text_seq_length,
                            cfg.text_embed_dim)).astype(np.float32)
    t = np.array([500], np.int32)
    cos, sin = prepare_rotary_positional_embeddings(
        cfg, h * 8, w * 8, F, vae_scale_factor_spatial=8, fps=12)
    jax_in = tuple(jnp.asarray(a) for a in (hidden, text, t, cos, sin))
    torch_in = tuple(torch.from_numpy(np.asarray(a)) for a in (hidden, text, t, cos, sin))
    return cfg, params, model, jax_in, torch_in


# float mode: two f32 implementations of the same math (tolerance = f32
# accumulation-order noise through 2 blocks); int8 mode: identical
# quantization groups, so only rare +-1 code flips separate the two sides
@pytest.mark.parametrize("qk_int8,atol", [(False, 1e-4), (True, 2e-3)])
def test_dit_blocks_and_output_match_fused_interpret(setup, qk_int8, atol):
    cfg, params, model, jax_in, torch_in = setup
    ref, ref_blocks = dit_forward(
        params, cfg, *jax_in, attn_impl="flash_interpret", fixed_max=True,
        qk_int8=qk_int8, pv_int8=False, fused_qkv=True, collect_blocks=True)
    with torch.no_grad():
        out, blocks = model(*torch_in, qk_int8=qk_int8, collect_blocks=True)
    assert len(blocks) == cfg.num_layers
    for i, (hid, enc) in enumerate(blocks):
        np.testing.assert_allclose(hid.numpy(), np.asarray(ref_blocks[0][i]),
                                   atol=atol, err_msg=f"block {i} video")
        np.testing.assert_allclose(enc.numpy(), np.asarray(ref_blocks[1][i]),
                                   atol=atol, err_msg=f"block {i} text")
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


def test_dit_float_matches_xla_attention(setup):
    """The bar test_dit_forward_fused_matches_unfused uses: 2e-4."""
    cfg, params, model, jax_in, torch_in = setup
    ref = dit_forward(params, cfg, *jax_in, attn_impl="xla")
    with torch.no_grad():
        out = model(*torch_in, qk_int8=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


def test_init_dit_distributions_and_dtype():
    cfg = DiTConfig.tiny()
    model = init_dit(cfg, dtype=torch.bfloat16, seed=0)
    again = init_dit(cfg, dtype=torch.bfloat16, seed=0)
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert p.dtype == torch.bfloat16, name
        assert torch.equal(p, q), name  # seeded
    w = model.blocks[0].attn.qkv.weight.float()
    bound = 1.0 / np.sqrt(cfg.hidden_size)
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert torch.all(model.blocks[0].norm1.ln_scale == 1)
    assert torch.all(model.blocks[0].attn.norm_k_bias == 0)

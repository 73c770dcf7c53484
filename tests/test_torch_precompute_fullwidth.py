"""``precompute_latents`` at the full VAE width against the JAX function (CPU).

The default ``VAEConfig`` (128/256/256/512 channels, three layers a block,
the AetherV1 VAE) with the tiny DiT, on one 5x32x48 clip with disparity and
poses: the clip is small, the widths are not cut. The JAX parameters
(``init_vae_params``) reach the port through ``io/from_jax.py``; the port
takes the JAX posterior draws through its noise source; f32 on both sides.
Held as ``tests/test_torch_train_data.py`` holds the tiny config.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aether_tpu.config import PipelineConfig as JaxPipelineConfig
from aether_tpu.models.vae import init_vae_params
from aether_tpu.train.data import precompute_latents as jax_precompute_latents
from aether_tpu_torch.config import PipelineConfig
from aether_tpu_torch.io.from_jax import vae_state_dict_from_jax
from aether_tpu_torch.models import init_dit
from aether_tpu_torch.models.vae import VAE
from aether_tpu_torch.pipeline import AetherPipeline
from aether_tpu_torch.train.data import precompute_latents
from test_torch_train_data import JaxLatentNoise, assert_files_match, make_clips

torch.set_num_threads(1)


def test_precompute_latents_full_vae_width_matches_jax(tmp_path):
    jcfg = JaxPipelineConfig(dit=JaxPipelineConfig.tiny().dit)
    cfg = PipelineConfig(dit=PipelineConfig.tiny().dit)
    assert cfg.vae.block_out_channels == (128, 256, 256, 512)
    assert cfg.vae.layers_per_block == 3
    vae_tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), init_vae_params(jax.random.PRNGKey(4), jcfg.vae))
    vae = VAE(cfg.vae)
    vae.load_state_dict(vae_state_dict_from_jax(vae_tree))
    text = np.zeros((1, cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim), np.float32)
    port = AetherPipeline(cfg, init_dit(cfg.dit, seed=0), vae, text, device="cpu",
                          compute_dtype=torch.float32)
    # the JAX function reads only these three attributes of its pipeline
    jax_pipe = types.SimpleNamespace(
        config=jcfg, compute_dtype=jnp.float32,
        vae_params=jax.tree_util.tree_map(jnp.asarray, vae_tree))
    clip = make_clips()[:1]  # RGB, disparity and poses
    ours = precompute_latents(port, clip, str(tmp_path / "port"), seed=2,
                              noise=JaxLatentNoise(2))
    ref = jax_precompute_latents(jax_pipe, clip, str(tmp_path / "jax"), seed=2)
    assert_files_match(ours[0], ref[0])
    clean = np.load(ours[0])["clean_latents"]
    assert clean.shape == (2, 56, 4, 6)
    assert np.abs(clean[:, :32]).min() < np.abs(clean[:, :32]).max()

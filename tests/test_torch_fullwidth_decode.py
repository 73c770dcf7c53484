"""The tiled VAE decode at the AetherV1 VAE widths against the JAX package
(CPU).

``pipeline/aether.py::_decode_pixels_tiled`` against JAX's
(``aether_tpu/pipeline/aether.py::_decode_pixels_tiled``) on the default
``VAEConfig`` (128/256/256/512 channels, three layers a block), f32, with
the deterministic anchor VAE of the parity tests (``TorchCogVAE`` filled by
``fill_state_dict_deterministic``, converted by the JAX converter and carried
across by ``io/from_jax.py``): one (1, 2, 16, 8, 12) latent, two latent
frames through the decoder's conv caches, in 2 x 2 tiles of 6 x 8 latents
that overlap by 2, so the seams are feathered in both directions. Tolerance
max abs 1e-4 and mean 5e-6 of outputs up to about 5 (two f32
implementations of the same convolutions, the accumulation order only;
measured 5.9e-6 / 4.9e-7; the tiny config's bar is 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aether_tpu.config import PipelineConfig as JaxPipelineConfig
from aether_tpu.io.weights import convert_vae_state_dict
from aether_tpu.pipeline import aether as jax_pipe
from aether_tpu_torch.config import PipelineConfig
from aether_tpu_torch.io.from_jax import vae_state_dict_from_jax
from aether_tpu_torch.models.vae import VAE
from aether_tpu_torch.pipeline import aether as torch_pipe

torch.set_num_threads(1)


def test_tiled_decode_at_full_vae_width_matches_jax():
    from test_torch_parity import fill_state_dict_deterministic
    from test_vae_torch_parity import TorchCogVAE

    jcfg = JaxPipelineConfig(dit=JaxPipelineConfig.tiny().dit)
    cfg = PipelineConfig(dit=PipelineConfig.tiny().dit)
    assert cfg.vae.block_out_channels == jcfg.vae.block_out_channels == (128, 256, 256, 512)
    assert cfg.vae.layers_per_block == 3
    anchor = fill_state_dict_deterministic(TorchCogVAE(jcfg.vae), 913)
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  convert_vae_state_dict(anchor.state_dict(), jcfg.vae))
    del anchor
    vae = VAE(cfg.vae)
    vae.load_state_dict(vae_state_dict_from_jax(tree))
    lat = np.random.default_rng(7).normal(size=(1, 2, 16, 8, 12)).astype(np.float32)
    tiles = dict(tile_latent=(6, 8), min_overlap=(2, 2))
    assert len(torch_pipe._tile_spans(8, 6, 2)) == len(torch_pipe._tile_spans(12, 8, 2)) == 2
    ref = np.asarray(jax_pipe._decode_pixels_tiled(
        jcfg, jnp.float32, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(lat),
        **tiles))
    with torch.no_grad():
        out = torch_pipe._decode_pixels_tiled(cfg, torch.float32, vae, torch.from_numpy(lat),
                                              **tiles).numpy()
    assert out.shape == ref.shape and out.shape[0] == 1 and out.shape[2:] == (64, 96, 3)
    assert np.isfinite(out).all() and np.abs(ref).max() > 0.1
    err = np.abs(out - ref)
    assert err.max() <= 1e-4 and err.mean() <= 5e-6, (err.max(), err.mean())

"""VAE of the PyTorch port against ``aether_tpu.models.vae`` (CPU, tiny config).

Same JAX parameters on both sides (converted by ``io/from_jax.py``), f32. The
trunks run over two frame chunks threaded through conv caches; the tiled
encode and decode run on a 64x96 clip with a small latent tile so the seams
really get feathered.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aether_tpu.config import PipelineConfig as JaxPipelineConfig
from aether_tpu.io.weights import convert_vae_state_dict
from aether_tpu.pipeline import aether as jax_pipe
from aether_tpu_torch.config import PipelineConfig
from aether_tpu_torch.io.from_jax import vae_state_dict_from_jax
from aether_tpu_torch.models.vae import VAE, decode_frames, encode_moments, init_vae
from aether_tpu_torch.pipeline import aether as torch_pipe

torch.set_num_threads(1)

# two f32 implementations of the same convolutions (XLA conv2d-lowered with
# folded taps vs torch conv3d): accumulation-order noise only
ATOL = 2e-4


@pytest.fixture(scope="module")
def vaes():
    # the JAX tree is the converted deterministic anchor VAE, as in
    # test_pipeline_torch_parity.py (numpy only: no JAX init to compile)
    from test_torch_parity import fill_state_dict_deterministic
    from test_vae_torch_parity import TorchCogVAE

    cfg = JaxPipelineConfig.tiny()
    anchor = fill_state_dict_deterministic(TorchCogVAE(cfg.vae), 913)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        convert_vae_state_dict(anchor.state_dict(), cfg.vae))
    model = VAE(PipelineConfig.tiny().vae)
    model.load_state_dict(vae_state_dict_from_jax(tree))
    return cfg, jax.tree_util.tree_map(jnp.asarray, tree), model


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, err_msg=what)


def test_encode_moments_two_chunks_with_cache(vaes):
    cfg, params, model = vaes
    video = np.random.default_rng(0).uniform(-1, 1, (1, 17, 32, 48, 3)).astype(np.float32)
    cache_j = cache_t = None
    for start, end in ((0, 9), (9, 17)):  # first chunk takes the remainder
        mj, lj, cache_j = jax_pipe._encode_chunk(cfg, jnp.float32, params,
                                                 jnp.asarray(video[:, start:end]), cache_j)
        with torch.no_grad():
            mt, lt, cache_t = encode_moments(model, torch.from_numpy(video[:, start:end]),
                                             cache_t)
        assert mt.shape == mj.shape
        _close(mt, mj, f"mean {start}")
        _close(lt, lj, f"logvar {start}")
    assert len(cache_t) == len(cache_j)


def test_decode_frames_two_chunks_with_cache(vaes):
    cfg, params, model = vaes
    lat = np.random.default_rng(1).normal(size=(1, 5, 4, 6, 16)).astype(np.float32)
    cache_j = cache_t = None
    for start, end in ((0, 3), (3, 5)):
        vj, cache_j = jax_pipe._decode_chunk(cfg, jnp.float32, params,
                                             jnp.asarray(lat[:, start:end]), cache_j)
        with torch.no_grad():
            vt, cache_t = decode_frames(model, torch.from_numpy(lat[:, start:end]), cache_t)
        assert vt.shape == vj.shape
        _close(vt, vj, f"video {start}")


def test_tiled_encode_matches(vaes):
    cfg, params, model = vaes
    frames = np.random.default_rng(2).uniform(-1, 1, (17, 64, 96, 3)).astype(np.float32)
    tiles = dict(tile_latent=(6, 8), min_overlap=(2, 2))
    assert len(torch_pipe._tile_spans(8, 6, 2)) == 2
    ref = jax_pipe._encode_pixels_tiled(cfg, jnp.float32, params, jnp.asarray(frames),
                                        None, **tiles)
    with torch.no_grad():
        out = torch_pipe._encode_pixels(PipelineConfig.tiny(), torch.float32, model,
                                        torch.from_numpy(frames), None, True, **tiles)
    assert out.shape == ref.shape == (1, 5, 16, 8, 12)
    _close(out, ref, "tiled encode")


def test_tiled_decode_matches(vaes):
    cfg, params, model = vaes
    lat = np.random.default_rng(3).normal(size=(2, 5, 16, 8, 12)).astype(np.float32)
    tiles = dict(tile_latent=(6, 8), min_overlap=(2, 2))
    ref = jax_pipe._decode_pixels_tiled(cfg, jnp.float32, params, jnp.asarray(lat),
                                        **tiles)
    with torch.no_grad():
        out = torch_pipe._decode_pixels_tiled(PipelineConfig.tiny(), torch.float32, model,
                                              torch.from_numpy(lat), **tiles)
    assert out.shape == ref.shape == (2, 17, 64, 96, 3)
    _close(out, ref, "tiled decode")


def test_tile_spans_and_feather_match():
    for n, tile, ov in ((60, 32, 4), (90, 90, 6), (8, 6, 2), (12, 8, 2), (100, 32, 4)):
        assert torch_pipe._tile_spans(n, tile, ov) == jax_pipe._tile_spans(n, tile, ov)
    rng = np.random.default_rng(4)
    a = rng.normal(size=(1, 2, 10, 7, 3)).astype(np.float32)
    b = rng.normal(size=(1, 2, 6, 7, 3)).astype(np.float32)
    ref = jax_pipe._feather(jnp.asarray(a), jnp.asarray(b), 10, (6, 12), axis=2)
    out = torch_pipe._feather(torch.from_numpy(a), torch.from_numpy(b), 10, (6, 12), axis=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_init_vae_is_seeded():
    cfg = PipelineConfig.tiny().vae
    a, b = init_vae(cfg, seed=5), init_vae(cfg, seed=5)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    w = a.encoder.conv_in.weight
    assert w.abs().max() <= 1.0 / np.sqrt(w[0].numel())

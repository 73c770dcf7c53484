"""``AetherPipeline.batch_reconstruct`` in the port (CPU, tiny config, f32).

- Against serial ``__call__``s with the same seed (the port's own
  ``TorchNoise``): every window gets a serial call's noise and its own VAE
  calls, so the two agree up to the rounding of the batch-2 DiT against the
  batch-1 one (2e-6 observed; bar 1e-4).
- Against the JAX ``batch_reconstruct`` with the JAX key streams injected
  (posterior, initial and SDE draws of one window, broadcast over the batch):
  5e-3, the bar ``tests/test_torch_pipeline.py`` holds the float attention
  path to.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aether_tpu.pipeline import AetherPipeline as JaxPipeline
from aether_tpu_torch.pipeline.aether import TorchNoise

torch.set_num_threads(1)

SEED, F, H, W, STEPS = 1234, 17, 64, 96, 2
FIELDS = ("rgb", "disparity", "raymap")


def tiny_pipelines():
    """The tiny JAX trees (the deterministic anchor weights of
    ``tests/test_torch_pipeline.py``), a zero prompt and the port's f32 CPU
    pipeline on the same weights: (jax config, dit tree, vae tree, text,
    port pipeline)."""
    from test_torch_parity import TorchDiTRef, fill_state_dict_deterministic
    from test_vae_torch_parity import TorchCogVAE

    from aether_tpu.config import PipelineConfig as JaxPipelineConfig
    from aether_tpu.io.weights import convert_dit_state_dict, convert_vae_state_dict
    from aether_tpu_torch.config import PipelineConfig
    from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax, vae_state_dict_from_jax
    from aether_tpu_torch.models.dit import DiT
    from aether_tpu_torch.models.vae import VAE
    from aether_tpu_torch.pipeline import AetherPipeline

    jcfg = JaxPipelineConfig.tiny()
    dit_tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        convert_dit_state_dict(fill_state_dict_deterministic(
            TorchDiTRef(jcfg.dit), 20240817).state_dict(), jcfg.dit))
    vae_tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        convert_vae_state_dict(fill_state_dict_deterministic(
            TorchCogVAE(jcfg.vae), 913).state_dict(), jcfg.vae))
    text = np.zeros((1, jcfg.dit.max_text_seq_length, jcfg.dit.text_embed_dim), np.float32)
    cfg = PipelineConfig.tiny()
    dit, vae = DiT(cfg.dit), VAE(cfg.vae)
    dit.load_state_dict(dit_state_dict_from_jax(dit_tree, cfg.dit))
    vae.load_state_dict(vae_state_dict_from_jax(vae_tree))
    port = AetherPipeline(cfg, dit, vae, text, device="cpu", compute_dtype=torch.float32)
    return jcfg, dit_tree, vae_tree, text, port


def jax_pipeline(jcfg, dit_tree, vae_tree, text):
    """The live JAX pipeline on the same weights, f32, float attention."""
    return JaxPipeline(jcfg, jax.tree_util.tree_map(jnp.asarray, dit_tree),
                       jax.tree_util.tree_map(jnp.asarray, vae_tree), text,
                       attn_impl="xla", compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def setup():
    return tiny_pipelines()


@pytest.fixture(scope="module")
def videos():
    return np.random.default_rng(3).integers(0, 256, (2, F, H, W, 3), dtype=np.uint8)


class RecordingNoise(TorchNoise):
    """``TorchNoise`` that records the shapes it was asked for."""

    def __init__(self, seed, device):
        super().__init__(seed, device)
        self.shapes = []

    def _normal(self, shape):
        self.shapes.append(tuple(shape))
        return super()._normal(shape)


def test_batch_matches_serial_calls(setup, videos):
    port = setup[4]
    kw = dict(height=H, width=W, num_frames=F, num_inference_steps=STEPS, fps=12)
    noise = RecordingNoise(SEED, "cpu")
    batched = port.batch_reconstruct(videos, noise=noise, **kw)
    # one window's draws in the serial order: posterior, initial, one per step
    assert [s[0] for s in noise.shapes] == [1] * (2 + STEPS)
    assert len(batched) == 2 and set(batched[0].stage_seconds) == {
        "encode", "denoise", "decode"}
    for i, out in enumerate(batched):
        serial = port(task="reconstruction", video=videos[i], seed=SEED, **kw)
        assert out.rgb.shape == (F, H, W, 3) and out.raymap.shape == (F, 6, H // 8, W // 8)
        for name in FIELDS:
            np.testing.assert_allclose(getattr(out, name), getattr(serial, name),
                                       atol=1e-4, err_msg=f"window {i} {name}")


def test_batch_matches_jax_batch_reconstruct(setup, videos):
    from test_torch_pipeline import JaxKeyNoise

    *trees, port = setup
    jax_pipe = jax_pipeline(*trees)
    kw = dict(height=H, width=W, num_frames=F, num_inference_steps=STEPS, fps=12)
    ref = jax_pipe.batch_reconstruct(videos, seed=SEED, **kw)
    noise = JaxKeyNoise(SEED)
    got = port.batch_reconstruct(videos, noise=noise, **kw)
    assert noise.calls == ["posterior", "initial"] + [f"sde{i}" for i in range(STEPS)]
    for i in range(2):
        for name in FIELDS:
            np.testing.assert_allclose(getattr(got[i], name), getattr(ref[i], name),
                                       atol=5e-3, err_msg=f"window {i} {name}")

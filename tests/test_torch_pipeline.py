"""The whole reconstruction slice of the PyTorch port (CPU, tiny config).

The port's ``AetherPipeline`` runs 17 frames at 64x96 for 4 steps with the
JAX pipeline's key streams injected (``scripts/make_pipeline_goldens.py``
discipline: key -> (vae, goal, denoise) -> (init, sde) splits, SDE noise
``fold_in(key_sde, i)``), and is held against
- the committed torch-sampler goldens (the bar test_pipeline_torch_parity.py
  uses, 5e-3);
- the live JAX ``AetherPipeline`` in float attention mode (5e-3);
- the live JAX pipeline with int8 attention operands (AETHER_ATTN_QK8=1,
  Pallas kernels interpreted) at 2e-2.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aether_tpu.config import PipelineConfig as JaxPipelineConfig
from aether_tpu.io.weights import convert_dit_state_dict, convert_vae_state_dict
from aether_tpu.pipeline import AetherPipeline as JaxPipeline
from aether_tpu_torch.config import PipelineConfig
from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax, vae_state_dict_from_jax
from aether_tpu_torch.models.dit import DiT
from aether_tpu_torch.models.vae import VAE
from aether_tpu_torch.pipeline import AetherPipeline

torch.set_num_threads(1)

_FIX = pathlib.Path(__file__).parent / "fixtures" / "pipeline_e2e_goldens.npz"
SEED = 1234  # scripts/make_pipeline_goldens.py
F, H, W, STEPS = 17, 64, 96, 4


class JaxKeyNoise:
    """The JAX pipeline's draws, fed to the port: key -> (vae, goal,
    denoise), denoise -> (init, sde); the posterior from the vae key, the
    goal's posterior from the goal key, SDE noise ``fold_in(key_sde, i)``.
    ``calls`` records the order in which the port asks for them."""

    def __init__(self, seed: int):
        key_vae, key_goal, key_denoise = jax.random.split(jax.random.PRNGKey(seed), 3)
        self.key_vae, self.key_goal = key_vae, key_goal
        self.key_noise, self.key_sde = jax.random.split(key_denoise)
        self.calls = []

    def _draw(self, key, shape):
        return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape), jnp.float32)))

    def posterior(self, shape):
        self.calls.append("posterior")
        return self._draw(self.key_vae, shape)

    def goal(self, shape):
        self.calls.append("goal")
        return self._draw(self.key_goal, shape)

    def initial(self, shape):
        self.calls.append("initial")
        return self._draw(self.key_noise, shape)

    def sde(self, step, shape):
        self.calls.append(f"sde{step}")
        return self._draw(jax.random.fold_in(self.key_sde, step), shape)


@pytest.fixture(scope="module")
def setup():
    from test_torch_parity import TorchDiTRef, fill_state_dict_deterministic
    from test_vae_torch_parity import TorchCogVAE

    jcfg = JaxPipelineConfig.tiny()
    dit_tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        convert_dit_state_dict(fill_state_dict_deterministic(
            TorchDiTRef(jcfg.dit), 20240817).state_dict(), jcfg.dit))
    vae_tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        convert_vae_state_dict(fill_state_dict_deterministic(
            TorchCogVAE(jcfg.vae), 913).state_dict(), jcfg.vae))
    text = np.zeros((1, jcfg.dit.max_text_seq_length, jcfg.dit.text_embed_dim),
                    np.float32)

    cfg = PipelineConfig.tiny()
    dit, vae = DiT(cfg.dit), VAE(cfg.vae)
    dit.load_state_dict(dit_state_dict_from_jax(dit_tree, cfg.dit))
    vae.load_state_dict(vae_state_dict_from_jax(vae_tree))
    port = AetherPipeline(cfg, dit, vae, text, device="cpu",
                          compute_dtype=torch.float32)
    golden = np.load(_FIX)
    return jcfg, dit_tree, vae_tree, text, port, golden


def _run_port(port, video):
    noise = JaxKeyNoise(SEED)
    out = port(task="reconstruction", video=video, height=H, width=W,
               num_frames=F, num_inference_steps=STEPS, fps=12, noise=noise)
    assert noise.calls == ["posterior", "initial"] + [f"sde{i}" for i in range(STEPS)]
    return out


def _run_jax(setup, attn_impl):
    jcfg, dit_tree, vae_tree, text, _, golden = setup
    pipe = JaxPipeline(jcfg, jax.tree_util.tree_map(jnp.asarray, dit_tree),
                       jax.tree_util.tree_map(jnp.asarray, vae_tree), text,
                       attn_impl=attn_impl, compute_dtype=jnp.float32)
    return pipe(task="reconstruction", video=golden["video"], height=H, width=W,
                num_frames=F, num_inference_steps=STEPS, fps=12, seed=SEED)


def _max_diffs(a, b):
    return {name: float(np.max(np.abs(getattr(a, name) - b[name])))
            for name in ("rgb", "disparity", "raymap")}


def test_reconstruction_matches_torch_goldens(setup):
    *_, port, golden = setup
    out = _run_port(port, golden["video"])
    assert out.rgb.shape == (F, H, W, 3) and out.disparity.shape == (F, H, W)
    assert out.raymap.shape == (F, 6, H // 8, W // 8)
    assert set(out.stage_seconds) == {"encode", "denoise", "decode"}
    diffs = _max_diffs(out, {n: golden[f"reconstruction_{n}"]
                             for n in ("rgb", "disparity", "raymap")})
    assert max(diffs.values()) < 5e-3, diffs


@pytest.mark.parametrize("qk8,attn_impl,atol", [
    ("0", "xla", 5e-3),
    ("1", "flash_interpret", 2e-2),
])
def test_reconstruction_matches_live_jax(setup, monkeypatch, qk8, attn_impl, atol):
    *_, port, golden = setup
    monkeypatch.setenv("AETHER_ATTN_QK8", qk8)
    ref = _run_jax(setup, attn_impl)
    out = _run_port(port, golden["video"])
    diffs = _max_diffs(out, {n: getattr(ref, n) for n in ("rgb", "disparity", "raymap")})
    assert max(diffs.values()) < atol, diffs


def test_unported_tasks_and_cfg_raise(setup):
    """Prediction, planning and CFG are ported (tests/test_torch_pipeline_cfg.py):
    what still raises is what the JAX pipeline refuses, such as a video for
    prediction. CFG on reconstruction runs the batch-2 pair, whose uncond
    stream masks nothing, so it gives the guidance-1 result up to the
    batch-2 DiT's rounding."""
    *_, port, golden = setup
    with pytest.raises(ValueError, match="`video` is only supported"):
        port(task="prediction", video=golden["video"], height=H, width=W,
             num_frames=F)
    kw = dict(task="reconstruction", video=golden["video"], height=H, width=W,
              num_frames=F, num_inference_steps=2, fps=12)
    plain = port(noise=JaxKeyNoise(SEED), **kw)
    cfg = port(noise=JaxKeyNoise(SEED), guidance_scale=3.0, use_dynamic_cfg=False, **kw)
    for name in ("rgb", "disparity", "raymap"):
        np.testing.assert_allclose(getattr(cfg, name), getattr(plain, name), atol=1e-5)


@pytest.mark.parametrize("frames", [17, 41, 18])
def test_raymap_fold_matches_jax(frames):
    from aether_tpu.pipeline.aether import pack_raymap as jax_pack
    from aether_tpu.pipeline.aether import unpack_raymap as jax_unpack
    from aether_tpu_torch.pipeline.aether import pack_raymap, unpack_raymap

    rm = np.random.default_rng(frames).normal(size=(1, frames, 6, 3, 4)).astype(np.float32)
    packed = pack_raymap(torch.from_numpy(rm))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_pack(jnp.asarray(rm))))
    np.testing.assert_array_equal(
        unpack_raymap(packed, frames).numpy(),
        np.asarray(jax_unpack(jnp.asarray(packed.numpy()), frames)))

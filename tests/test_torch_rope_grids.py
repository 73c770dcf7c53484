"""The port's RoPE tables at the real deployment grids (CPU).

``aether_tpu_torch.models.rope`` is a numpy copy of the JAX module. Here its
tables at 480x720 are held:

- the crop grid (CogVideoX 1.0, AetherV1): 11 latent frames on the 60x90
  base, a 30x45 patch grid, 14850 video tokens, against the independent
  oracle of ``tests/test_fullwidth_parity.py::_oracle_rope_tables`` (2e-6,
  that test's bar) and against the JAX tables bit for bit;
- the "slice" grid (CogVideoX 1.5, ``patch_size_t=2``): 12 latent frames fold
  into 6 token frames on the 60x90 base, 8100 video tokens, against the JAX
  tables (``aether_tpu/models/rope.py:144-153``) bit for bit.
"""

import dataclasses

import numpy as np
import pytest

from aether_tpu.config import DiTConfig as JaxDiTConfig
from aether_tpu.models import rope as jax_rope
from aether_tpu_torch.config import DiTConfig
from aether_tpu_torch.models import rope
from test_fullwidth_parity import _oracle_rope_tables


@pytest.mark.parametrize("fps", [12, 24])
def test_crop_tables_at_the_real_grid(fps):
    cfg = DiTConfig.aetherv1()
    cos, sin = rope.prepare_rotary_positional_embeddings(
        cfg, 480, 720, 11, vae_scale_factor_spatial=8, base_fps=12, fps=fps)
    assert cos.shape == sin.shape == (11 * 30 * 45, cfg.head_dim)
    oc, os_ = _oracle_rope_tables(cfg.head_dim, 30, 45, 11, cfg.sample_height // 2,
                                  cfg.sample_width // 2, fps_factor=12 / fps,
                                  theta=cfg.rope_theta)
    np.testing.assert_allclose(cos, oc, atol=2e-6)
    np.testing.assert_allclose(sin, os_, atol=2e-6)
    jc, js = jax_rope.prepare_rotary_positional_embeddings(
        JaxDiTConfig.aetherv1(), 480, 720, 11, vae_scale_factor_spatial=8, base_fps=12,
        fps=fps)
    np.testing.assert_array_equal(cos, np.asarray(jc))
    np.testing.assert_array_equal(sin, np.asarray(js))


@pytest.mark.parametrize("frames", [11, 12])
def test_slice_tables_at_the_real_grid(frames):
    """12 latent frames (the 1.5 DiT's 6 token frames) and 11, which the
    slice grid rounds up to 6 as the reference does."""
    kw = dict(patch_size_t=2, ofs_embed_dim=512)
    cfg = dataclasses.replace(DiTConfig.aetherv1(), **kw)
    cos, sin = rope.prepare_rotary_positional_embeddings(
        cfg, 480, 720, frames, vae_scale_factor_spatial=8, base_fps=12, fps=12)
    assert cos.shape == sin.shape == (6 * 30 * 45, cfg.head_dim)
    jc, js = jax_rope.prepare_rotary_positional_embeddings(
        dataclasses.replace(JaxDiTConfig.aetherv1(), **kw), 480, 720, frames,
        vae_scale_factor_spatial=8, base_fps=12, fps=12)
    np.testing.assert_array_equal(cos, np.asarray(jc))
    np.testing.assert_array_equal(sin, np.asarray(js))
    # at 480x720 the patch grid is the whole 30x45 base, so the slice grid's
    # positions are the crop grid's: the 1.0 tables of the 6 token frames
    crop = rope.prepare_rotary_positional_embeddings(
        DiTConfig.aetherv1(), 480, 720, 6, vae_scale_factor_spatial=8)
    np.testing.assert_array_equal(cos, crop[0])
    np.testing.assert_array_equal(sin, crop[1])

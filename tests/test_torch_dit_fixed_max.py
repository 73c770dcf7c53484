"""The DiT's unfused fixed-max attention (K3, K6) against JAX (CPU).

Tiny config, f32, the same JAX parameters on both sides. The port's DiT under
``AETHER_ATTN_FUSED=0`` (QK8 0 and 1) and ``AETHER_ATTN_PV8=1`` runs the plain
versions of K3 and K6 through ``flash_attention(fixed_max=True, ...)``; the
JAX side runs ``dit_forward(attn_impl="flash_interpret", fused_qkv=False,
...)`` with the Pallas kernels interpreted.

Tolerances, on the block outputs and the v-prediction:
- QK8=0: 1e-4, f32 accumulation-order noise through 2 blocks (the bar of the
  other DiT tests).
- QK8=1: 2e-3, the fused int8 path's bar (tests/test_torch_dit.py): the
  codes agree except where a product lands on a rounding boundary.
- PV8=1: 2e-3 as well. p8 = rint(127 p) is rounded against the same
  integer running max on both sides (per 1024-column block); it flips by one
  only where the two exp2s differ in the last bit at a .5 boundary, which
  moves one attention output by up to max|v| / l (measured 1.3e-4 here).
"""

import numpy as np
import pytest
import torch

import jax

from aether_tpu.config import DiTConfig as JaxDiTConfig
from aether_tpu.models.dit import dit_forward, init_dit_params
from aether_tpu.models.rope import prepare_rotary_positional_embeddings
from aether_tpu_torch.config import DiTConfig
from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax
from aether_tpu_torch.models import dit as dit_module
from aether_tpu_torch.models.dit import DiT

torch.set_num_threads(1)

F = 3


@pytest.fixture(scope="module")
def setup():
    cfg = JaxDiTConfig.tiny()
    params = init_dit_params(jax.random.PRNGKey(7), cfg)
    model = DiT(DiTConfig.tiny())
    model.load_state_dict(dit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), DiTConfig.tiny()))
    h, w = cfg.sample_height, cfg.sample_width
    rng = np.random.default_rng(8)
    hidden = rng.normal(size=(2, F, cfg.in_channels, h, w)).astype(np.float32)
    text = rng.normal(size=(2, cfg.max_text_seq_length,
                            cfg.text_embed_dim)).astype(np.float32)
    t = np.array([700, 700], np.int32)
    cos, sin = prepare_rotary_positional_embeddings(
        cfg, h * 8, w * 8, F, vae_scale_factor_spatial=8, fps=12)
    jax_in = tuple(jax.numpy.asarray(a) for a in (hidden, text, t, cos, sin))
    torch_in = tuple(torch.from_numpy(np.asarray(a)) for a in (hidden, text, t, cos, sin))
    return cfg, params, model, jax_in, torch_in


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(dit_module, name)

    def counted(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(dit_module, name, counted)
    return calls


# (env settings, JAX dit_forward options, tolerance)
CASES = [
    ({"AETHER_ATTN_FUSED": "0", "AETHER_ATTN_QK8": "0"},
     dict(qk_int8=False, pv_int8=False), 1e-4),
    ({"AETHER_ATTN_FUSED": "0", "AETHER_ATTN_QK8": "1"},
     dict(qk_int8=True, pv_int8=False), 2e-3),
    ({"AETHER_ATTN_PV8": "1", "AETHER_ATTN_QK8": "1"},
     dict(qk_int8=True, pv_int8=True), 2e-3),
]


@pytest.mark.parametrize("env,jax_opts,atol", CASES)
def test_unfused_fixed_max_matches_interpret(setup, monkeypatch, env, jax_opts, atol):
    cfg, params, model, jax_in, torch_in = setup
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    attn = _spy(monkeypatch, "flash_attention")
    fused = _spy(monkeypatch, "fused_joint_attention")
    ref, ref_blocks = dit_forward(
        params, cfg, *jax_in, attn_impl="flash_interpret", fixed_max=True,
        fused_qkv=False, collect_blocks=True, **jax_opts)
    with torch.no_grad():
        out, blocks = model(*torch_in, collect_blocks=True)
    assert len(fused) == 0 and len(attn) == cfg.num_layers
    assert attn[0] == dict(fixed_max=True, **jax_opts)
    for i, (hid, enc) in enumerate(blocks):
        np.testing.assert_allclose(hid.numpy(), np.asarray(ref_blocks[0][i]),
                                   atol=atol, err_msg=f"block {i} video")
        np.testing.assert_allclose(enc.numpy(), np.asarray(ref_blocks[1][i]),
                                   atol=atol, err_msg=f"block {i} text")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)
    # the keyword overrides pick the same path without the environment
    for name in env:
        monkeypatch.delenv(name)
    with torch.no_grad():
        explicit = model(*torch_in, fixed_max=True, fused_qkv=False, **jax_opts)
    assert torch.equal(explicit, out)


def test_pv8_without_qk8_raises_the_jax_error(setup, monkeypatch):
    cfg, params, model, jax_in, torch_in = setup
    monkeypatch.setenv("AETHER_ATTN_PV8", "1")
    monkeypatch.setenv("AETHER_ATTN_QK8", "0")
    with pytest.raises(ValueError, match="pv_int8 requires qk_int8"):
        dit_forward(params, cfg, *jax_in, attn_impl="flash_interpret")
    with pytest.raises(ValueError, match="pv_int8 requires qk_int8"):
        model(*torch_in)


def test_fused_stays_the_default(setup, monkeypatch):
    """FUSED unset and PV8=0: the fused K1 + K2 path, not K3."""
    cfg, _, model, _, torch_in = setup
    monkeypatch.setenv("AETHER_ATTN_PV8", "0")
    attn = _spy(monkeypatch, "flash_attention")
    fused = _spy(monkeypatch, "fused_joint_attention")
    with torch.no_grad():
        model(*torch_in)
    assert (len(fused), len(attn)) == (cfg.num_layers, 0)

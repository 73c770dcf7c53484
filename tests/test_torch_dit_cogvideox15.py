"""The CogVideoX-1.5 branch of the port's DiT (``patch_size_t`` and the ofs
embedding) against the JAX package on the CPU.

The config is ``DiTConfig.tiny()`` with ``patch_size_t=2`` and
``ofs_embed_dim = time_embed_dim``; four latent frames fold into two token
frames. The same JAX parameters go to both sides (``io.from_jax``), the
inputs are made from a numpy seed, and the RoPE tables are JAX's "slice"
grid. Tolerances (outputs of magnitude up to about 3):

- the forward in f32: 2e-4 on the "xla" route (the bar of
  ``test_torch_dit.py::test_dit_float_matches_xla_attention``), 1e-4 on the
  fused route (plain K1/K2 against the Pallas kernels in interpret mode, the
  bar of ``test_dit_blocks_and_output_match_fused_interpret``);
- the forward in bf16: 6e-2 absolute and 1e-2 mean absolute, about four bf16
  ulps of the largest outputs: two implementations of the same bf16
  arithmetic round their intermediate casts apart once in a while;
- patchify and unpatchify: bit for bit (a reshape and a permute), the
  patch projection within 1e-5 (f32 summation order);
- the loss's gradient: 1e-4 of each tensor's largest gradient, the loss
  rtol 1e-5 (``test_torch_dit_train.py``'s bars);
The weight formats, the converters, the checkpoint, the random inits and
the mesh runs are in ``test_torch_dit_cogvideox15_io.py``:

- quantized trees: codes and scales bit for bit, the weight-only forward
  1e-5 (``test_torch_quant.py``'s bar); w8a8 5e-3 and 1e-4 mean absolute: at
  batch 2 the f32 summation order of the two libraries moves a few
  activations across a rounding half, one int8 code apart (measured 1.1e-3
  and 2.7e-5; the tiny config without the 1.5 fields reads 7.6e-4 on the
  same batch-2 inputs, so the 1.5 branch adds nothing to it);
- the tp = 2, sp = 2 and dp = 2 forwards of two gloo ranks: 1e-5 of the
  one-process forward (the JAX mesh forward shards no ofs embedding, so one
  process, itself held to JAX above, is the reference).
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aether_tpu.config import DiTConfig as JaxDiTConfig
from aether_tpu.config import SchedulerConfig as JaxSchedulerConfig
from aether_tpu.models.dit import (
    _patchify as jax_patchify,
    _unpatchify as jax_unpatchify,
    dit_forward,
    init_dit_params,
)
from aether_tpu.models.rope import prepare_rotary_positional_embeddings
from aether_tpu.schedule.dpm import compute_alphas_cumprod
from aether_tpu.train.step import diffusion_loss as jax_diffusion_loss
from aether_tpu_torch.config import DiTConfig, SchedulerConfig
from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax
from aether_tpu_torch.models.dit import DiT
from aether_tpu_torch.train.step import diffusion_loss, noise_schedule

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
KW = dict(dataclasses.asdict(JaxDiTConfig.tiny()), patch_size_t=2,
          ofs_embed_dim=JaxDiTConfig.tiny().time_embed_dim)
JCFG, CFG = JaxDiTConfig(**KW), DiTConfig(**KW)
F = 4  # latent frames: two token frames at patch_size_t 2
H, W = JCFG.sample_height, JCFG.sample_width


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tables(frames=F):
    return prepare_rotary_positional_embeddings(JCFG, H * 8, W * 8, frames,
                                                vae_scale_factor_spatial=8, fps=12)


@pytest.fixture(scope="module")
def setup():
    params = init_dit_params(jax.random.PRNGKey(4), JCFG)
    model = DiT(CFG)
    model.load_state_dict(dit_state_dict_from_jax(_np_tree(params), CFG))
    rng = np.random.default_rng(15)
    hidden = rng.normal(size=(2, F, JCFG.in_channels, H, W)).astype(np.float32)
    text = rng.normal(size=(2, JCFG.max_text_seq_length, JCFG.text_embed_dim)).astype(np.float32)
    t = np.array([500, 80], np.int32)
    cos, sin = _tables()
    return params, model, (hidden, text, t, np.asarray(cos), np.asarray(sin))


def _jax_in(inputs, dtype=jnp.float32):
    hidden, text, t, cos, sin = inputs
    return (jnp.asarray(hidden, dtype), jnp.asarray(text), jnp.asarray(t),
            jnp.asarray(cos), jnp.asarray(sin))


def _torch_in(inputs, dtype=torch.float32):
    hidden, text, t, cos, sin = (torch.from_numpy(np.asarray(a)) for a in inputs)
    return hidden.to(dtype), text, t, cos, sin


def test_the_config_builds_with_the_wider_projections():
    """``DiT(DiTConfig(patch_size_t=2, ofs_embed_dim=512))``, the AetherV1
    width with the 1.5 fields, on the meta device."""
    with torch.device("meta"):
        model = DiT(DiTConfig(patch_size_t=2, ofs_embed_dim=512))
    assert tuple(model.proj.weight.shape) == (3072, 2 * 2 * 2 * 96)
    assert tuple(model.proj_out.weight.shape) == (2 * 2 * 2 * 56, 3072)
    assert tuple(model.ofs_embed.w1.weight.shape) == (512, 512)
    with pytest.raises(ValueError, match="dims must match"):
        DiT(DiTConfig(**dict(KW, ofs_embed_dim=2 * KW["time_embed_dim"])))


def test_patch_tokens_and_unpatchify_match_jax(setup):
    params, model, (hidden, *_) = setup
    pe = params["patch_embed"]
    ref = jax_patchify(jnp.asarray(hidden), pe["proj_w"], pe["proj_b"], JCFG.patch_size, 2)
    with torch.no_grad():
        tokens = model._patch_tokens(torch.from_numpy(hidden))
        got = model.proj(tokens)
    assert tuple(got.shape) == (2, (F // 2) * (H // 2) * (W // 2), CFG.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # the token features are (c, pt, ph, pw): JAX's layout, bit for bit
    ref_tokens = jax_patchify(jnp.asarray(hidden), jnp.eye(tokens.shape[-1]),
                              jnp.zeros(tokens.shape[-1]), JCFG.patch_size, 2)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    out_feat = 2 * JCFG.patch_size ** 2 * JCFG.out_channels
    head = np.random.default_rng(2).normal(size=(2, tokens.shape[1], out_feat)).astype(np.float32)
    ref = jax_unpatchify(jnp.asarray(head), F, H // 2, W // 2, JCFG.out_channels,
                         JCFG.patch_size, 2)
    got = model._unpatchify(torch.from_numpy(head), F, H // 2, W // 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


ROUTES = {"xla": (dict(attn_impl="xla"), dict(attn_impl="xla")),
          "fused": (dict(attn_impl="flash_interpret", fixed_max=True, qk_int8=False,
                         pv_int8=False, fused_qkv=True),
                    dict(attn_impl="flash", fixed_max=True, qk_int8=False, pv_int8=False,
                         fused_qkv=True))}
BARS = {("f32", "xla"): (2e-4, None), ("f32", "fused"): (1e-4, None),
        ("bf16", "xla"): (6e-2, 1e-2), ("bf16", "fused"): (6e-2, 1e-2)}


@pytest.mark.parametrize("ofs", [None, 2.0])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_dit_forward(setup, dtype, route, ofs):
    params, model, inputs = setup
    jopts, topts = ROUTES[route]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jparams = jax.tree_util.tree_map(lambda x: x.astype(jdt), params)
    jofs = None if ofs is None else jnp.asarray([ofs], jnp.float32)
    ref = np.asarray(dit_forward(jparams, JCFG, *_jax_in(inputs, jdt), ofs=jofs, **jopts)
                     ).astype(np.float32)
    tofs = None if ofs is None else torch.tensor([ofs])
    with torch.no_grad():
        out = copy.deepcopy(model).to(tdt)(*_torch_in(inputs, tdt), ofs=tofs,
                                           **topts).float().numpy()
    assert out.shape == ref.shape == (2, F, JCFG.out_channels, H, W)
    assert np.isfinite(out).all()
    atol, mean_bar = BARS[dtype, route]
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)
    if mean_bar is not None:
        assert np.abs(out - ref).mean() <= mean_bar


def test_ofs_none_is_zeros_and_ofs_moves_the_output(setup):
    _, model, inputs = setup
    args = _torch_in(inputs)
    with torch.no_grad():
        none = model(*args, attn_impl="xla")
        zeros = model(*args, attn_impl="xla", ofs=torch.zeros(2))
        two = model(*args, attn_impl="xla", ofs=torch.tensor([2.0, 2.0]))
    assert torch.equal(none, zeros)
    assert (two - none).abs().max() > 1e-3


def test_a_frame_count_patch_size_t_does_not_divide_raises(setup):
    _, model, inputs = setup
    hidden, text, t, _, _ = _torch_in(inputs)
    cos, sin = (torch.from_numpy(np.asarray(a)) for a in _tables(F - 1))
    with pytest.raises(ValueError, match="not a multiple of patch_size_t 2"):
        model(hidden[:, :F - 1], text, t, cos, sin, attn_impl="xla")


def test_diffusion_loss_grad_matches_jax(setup):
    params, model, _ = setup
    b = 2
    rng = np.random.default_rng(9)
    clean = rng.normal(size=(b, F, 56, H, W)).astype(np.float32)
    cond = rng.normal(size=(b, F, 40, H, W)).astype(np.float32)
    text = rng.normal(size=(b, JCFG.max_text_seq_length, JCFG.text_embed_dim)).astype(np.float32)
    t = np.array([17, 831], np.int64)
    eps = rng.normal(size=clean.shape).astype(np.float32)
    cos, sin = _tables()
    batch = (clean, cond, text, np.asarray(cos), np.asarray(sin))
    alphas = compute_alphas_cumprod(JaxSchedulerConfig.aetherv1())
    sqrt_a = jnp.asarray(np.sqrt(alphas), jnp.float32)
    sqrt_1ma = jnp.asarray(np.sqrt(1.0 - alphas), jnp.float32)

    def jax_loss(p):
        return jax_diffusion_loss(p, JCFG, sqrt_a, sqrt_1ma, *(jnp.asarray(a) for a in batch),
                                  jax.random.PRNGKey(0), "xla", t=jnp.asarray(t, jnp.int32),
                                  eps=jnp.asarray(eps))

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(params)
    ref_sd = dit_state_dict_from_jax(_np_tree(ref_grads), CFG)
    model.zero_grad(set_to_none=True)
    loss = diffusion_loss(model, *noise_schedule(SchedulerConfig.aetherv1(), "cpu"),
                          *(torch.from_numpy(a) for a in batch), attn_impl="xla",
                          t=torch.from_numpy(t), eps=torch.from_numpy(eps), remat=True)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    assert set(grads) == set(ref_sd)
    for name in ("ofs_embed.w1.weight", "ofs_embed.w2.bias", "proj.weight", "proj_out.weight"):
        assert grads[name].abs().max() > 0, name
    for name, g in grads.items():
        ref = ref_sd[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-12, err_msg=name)

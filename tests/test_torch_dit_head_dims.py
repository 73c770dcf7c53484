"""The DiT's attention route at head_dim 24, 64, 72, 112, 120, 128, 160 and 256
against JAX (CPU).

The JAX ``dit_forward`` takes the fused K1 + K2 path only at an even
head_dim below 128 (``aether_tpu/models/dit.py:819-825``); at 128 and above the
unfused wrapper turns the fixed max off and takes K4 with the "vpu"
denominator. The port's DiT routes alike: at 128 and above it calls
``flash_attention`` and never ``fused_joint_attention`` (160 and 256: K4 on
the card's instances above 128; also at ``AETHER_ATTN_FIXED_MAX=0``, the
same route). The tiny config
with one head at each head dim, the same JAX parameters on both sides
(``dit_state_dict_from_jax``), one batch-1 3-frame forward at t = 700 at the
default attention settings, JAX through the Pallas kernels in interpret mode
(``attn_impl="flash_interpret"``). 24, 72 and 120 are head dims that the
card runs on the next width's instances (32, 80 and 128: the prologue
writing q, k and v that wide with zero columns, K2 reading them in place);
here they take the fused route as JAX does. Tolerance 2e-3 of the output (mean
magnitude about 0.5): f32 order-of-sum noise through 2 blocks sits near 1e-4
at 112; the fused path at 128, where JAX runs K4, departed by 0.157.
The loss and its gradients at head_dim 128 and 256, where K4 "vpu" enters
the training forward (``flash_train``), agree with ``jax.value_and_grad`` as
in ``tests/test_torch_dit_train.py``: the loss to 1e-5 relative, each
gradient to 1e-4 of its largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aether_tpu.config import DiTConfig as JaxDiTConfig
from aether_tpu.config import SchedulerConfig as JaxSchedulerConfig
from aether_tpu.models.dit import dit_forward, init_dit_params
from aether_tpu.models.rope import prepare_rotary_positional_embeddings
from aether_tpu.schedule.dpm import compute_alphas_cumprod
from aether_tpu.train.step import diffusion_loss as jax_diffusion_loss
from aether_tpu_torch.config import DiTConfig, SchedulerConfig
from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax
from aether_tpu_torch.models import dit as dit_module
from aether_tpu_torch.models.dit import DiT
from aether_tpu_torch.train.step import diffusion_loss, noise_schedule

torch.set_num_threads(1)

F = 3
ATOL = 2e-3


def _configs(hd):
    return (dataclasses.replace(JaxDiTConfig.tiny(), num_heads=1, head_dim=hd),
            dataclasses.replace(DiTConfig.tiny(), num_heads=1, head_dim=hd))


def _model(params, cfg):
    model = DiT(cfg)
    model.load_state_dict(dit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return model


def _count_calls(monkeypatch, name):
    calls = []
    orig = getattr(dit_module, name)

    def counted(*a, **kw):
        calls.append(name)
        return orig(*a, **kw)

    monkeypatch.setattr(dit_module, name, counted)
    return calls


@pytest.mark.parametrize("hd,fused", [(64, True), (112, True), (128, False), (24, True),
                                      (72, True), (120, True), (160, False), (256, False)])
def test_default_route_matches_jax_at_head_dim(monkeypatch, hd, fused):
    _check_route(monkeypatch, hd, fused)


@pytest.mark.parametrize("hd", [160, 256])
def test_fixed_max_off_route_matches_jax_at_wide_head_dim(monkeypatch, hd):
    """At ``AETHER_ATTN_FIXED_MAX=0`` (both packages read it) the route above
    128 is the one of the defaults: K4 "vpu" in every block."""
    monkeypatch.setenv("AETHER_ATTN_FIXED_MAX", "0")
    _check_route(monkeypatch, hd, False)


def _check_route(monkeypatch, hd, fused):
    jcfg, cfg = _configs(hd)
    params = init_dit_params(jax.random.PRNGKey(7), jcfg)
    model = _model(params, cfg)
    h, w = jcfg.sample_height, jcfg.sample_width
    rng = np.random.default_rng(hd)
    hidden = rng.normal(size=(1, F, jcfg.in_channels, h, w)).astype(np.float32)
    text = rng.normal(size=(1, jcfg.max_text_seq_length,
                            jcfg.text_embed_dim)).astype(np.float32)
    t = np.array([700], np.int32)
    cos, sin = prepare_rotary_positional_embeddings(
        jcfg, h * 8, w * 8, F, vae_scale_factor_spatial=8, fps=12)
    arrays = (hidden, text, t, np.asarray(cos), np.asarray(sin))
    ref = dit_forward(params, jcfg, *(jnp.asarray(a) for a in arrays),
                      attn_impl="flash_interpret")
    k1k2 = _count_calls(monkeypatch, "fused_joint_attention")
    unfused = _count_calls(monkeypatch, "flash_attention")
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in arrays))
    n = cfg.num_layers
    assert (len(k1k2), len(unfused)) == ((n, 0) if fused else (0, n))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_loss_and_gradients_at_head_dim_128_match_jax():
    _check_loss_and_gradients(128, 4)


def test_loss_and_gradients_at_head_dim_256_match_jax():
    _check_loss_and_gradients(256, 5)


def _check_loss_and_gradients(hd, seed):
    jcfg, cfg = _configs(hd)
    params = init_dit_params(jax.random.PRNGKey(seed), jcfg)
    model = _model(params, cfg)
    b, f, h, w = 2, 2, jcfg.sample_height, jcfg.sample_width
    rng = np.random.default_rng(9)
    clean = rng.normal(size=(b, f, 56, h, w)).astype(np.float32)
    cond = rng.normal(size=(b, f, 40, h, w)).astype(np.float32)
    text = rng.normal(size=(b, jcfg.max_text_seq_length,
                            jcfg.text_embed_dim)).astype(np.float32)
    t = np.array([17, 831], np.int64)
    eps = rng.normal(size=clean.shape).astype(np.float32)
    cos, sin = prepare_rotary_positional_embeddings(
        jcfg, h * 8, w * 8, f, vae_scale_factor_spatial=8, fps=12)
    batch = (clean, cond, text, np.asarray(cos), np.asarray(sin))
    alphas = compute_alphas_cumprod(JaxSchedulerConfig.aetherv1())

    def jax_loss(p):
        return jax_diffusion_loss(
            p, jcfg, jnp.asarray(np.sqrt(alphas), jnp.float32),
            jnp.asarray(np.sqrt(1.0 - alphas), jnp.float32),
            *(jnp.asarray(a) for a in batch), jax.random.PRNGKey(0), "xla",
            t=jnp.asarray(t, jnp.int32), eps=jnp.asarray(eps))

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(params)
    ref_sd = dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads), cfg)
    tables = noise_schedule(SchedulerConfig.aetherv1(), "cpu")
    loss = diffusion_loss(model, *tables, *(torch.from_numpy(a) for a in batch),
                          attn_impl="flash_train", t=torch.from_numpy(t),
                          eps=torch.from_numpy(eps), remat=True)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(ref_sd)
    for name, g in grads.items():
        want = ref_sd[name].numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + 1e-12, err_msg=name)

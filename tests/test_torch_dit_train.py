"""The DiT's unfused attention path, remat and loss gradient against JAX (CPU).

Tiny config, f32, the same JAX parameters on both sides (converted by
``aether_tpu_torch.io.from_jax``). The unfused path (fused qkv projection,
per-head QK LayerNorm, RoPE, then ``attn_impl``) is held against
``dit_forward`` with the matching attention; the fixed-max-off "flash" path
(K4's plain version) against the Pallas kernel interpreted. Tolerance 1e-4:
f32 accumulation-order noise through 2 blocks, the bar the port's fused-path
test uses. Gradients of ``diffusion_loss`` with injected (t, eps) agree with
``jax.grad`` to 1e-4 of each tensor's largest magnitude.
"""

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
ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = JaxDiTConfig.tiny()
    params = init_dit_params(jax.random.PRNGKey(4), cfg)
    model = DiT(DiTConfig.tiny())
    model.load_state_dict(dit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), DiTConfig.tiny()))
    h, w = cfg.sample_height, cfg.sample_width
    rng = np.random.default_rng(6)
    hidden = rng.normal(size=(1, F, cfg.in_channels, h, w)).astype(np.float32)
    text = rng.normal(size=(1, cfg.max_text_seq_length,
                            cfg.text_embed_dim)).astype(np.float32)
    t = np.array([321], np.int32)
    cos, sin = prepare_rotary_positional_embeddings(
        cfg, h * 8, w * 8, F, vae_scale_factor_spatial=8, fps=12)
    jax_in = tuple(jnp.asarray(a) for a in (hidden, text, t, cos, sin))
    torch_in = tuple(torch.from_numpy(np.asarray(a)) for a in (hidden, text, t, cos, sin))
    return cfg, params, model, jax_in, torch_in


@pytest.mark.parametrize("port_impl,jax_impl", [
    ("xla", "xla"), ("flash_train", "xla"), ("chunked", "chunked")])
def test_unfused_forward_matches_jax(setup, port_impl, jax_impl):
    cfg, params, model, jax_in, torch_in = setup
    ref, ref_blocks = dit_forward(params, cfg, *jax_in, attn_impl=jax_impl,
                                  collect_blocks=True)
    with torch.no_grad():
        out, blocks = model(*torch_in, attn_impl=port_impl, collect_blocks=True)
    for i, (hid, enc) in enumerate(blocks):
        np.testing.assert_allclose(hid.numpy(), np.asarray(ref_blocks[0][i]),
                                   atol=ATOL, err_msg=f"block {i} video")
        np.testing.assert_allclose(enc.numpy(), np.asarray(ref_blocks[1][i]),
                                   atol=ATOL, err_msg=f"block {i} text")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def _count_calls(monkeypatch, name):
    calls = []
    orig = getattr(dit_module, name)

    def counted(*a, **kw):
        calls.append(name)
        return orig(*a, **kw)

    monkeypatch.setattr(dit_module, name, counted)
    return calls


def test_flash_without_fixed_max_matches_pallas(setup, monkeypatch):
    """attn_impl="flash", fixed max off: the unfused path through K4."""
    cfg, params, model, jax_in, torch_in = setup
    calls = _count_calls(monkeypatch, "flash_attention")
    ref = dit_forward(params, cfg, *jax_in, attn_impl="flash_interpret",
                      fixed_max=False)
    with torch.no_grad():
        out = model(*torch_in, attn_impl="flash", fixed_max=False)
    assert len(calls) == cfg.num_layers
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_fixed_max_env_off_routes_inference_through_k4(setup, monkeypatch):
    """AETHER_ATTN_FIXED_MAX=0: the default forward takes K4, as the JAX
    dit_forward(fixed_max=False) does; FUSED and PV8 no longer apply."""
    cfg, params, model, jax_in, torch_in = setup
    monkeypatch.setenv("AETHER_ATTN_FIXED_MAX", "0")
    monkeypatch.setenv("AETHER_ATTN_PV8", "1")
    k4 = _count_calls(monkeypatch, "flash_attention")
    fused = _count_calls(monkeypatch, "fused_joint_attention")
    ref = dit_forward(params, cfg, *jax_in, attn_impl="flash_interpret",
                      fixed_max=False)
    with torch.no_grad():
        out = model(*torch_in)
    assert (len(k4), len(fused)) == (cfg.num_layers, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_default_path_is_the_fused_one_unchanged(setup, monkeypatch):
    """The default forward still runs K1 + K2 (float operands under the test
    settings) and equals the explicit fused call bit for bit."""
    cfg, params, model, jax_in, torch_in = setup
    fused = _count_calls(monkeypatch, "fused_joint_attention")
    k4 = _count_calls(monkeypatch, "flash_attention")
    with torch.no_grad():
        out = model(*torch_in)
        explicit = model(*torch_in, attn_impl="flash", fixed_max=True, qk_int8=False)
    assert (len(fused), len(k4)) == (2 * cfg.num_layers, 0)
    assert torch.equal(out, explicit)
    ref = dit_forward(params, cfg, *jax_in, attn_impl="flash_interpret",
                      fixed_max=True, qk_int8=False, pv_int8=False, fused_qkv=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_unknown_attn_impl_raises(setup):
    _, _, model, _, torch_in = setup
    with pytest.raises(ValueError, match="attn_impl"):
        model(*torch_in, attn_impl="flash_interpret")


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_gives_identical_outputs_and_grads(setup):
    _, _, model, _, torch_in = setup
    results = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        out = model(*torch_in, attn_impl="flash_train", remat=remat)
        (out * out).mean().backward()
        results.append((out.detach(), _grads(model)))
    model.zero_grad(set_to_none=True)
    (out0, g0), (out1, g1) = results
    assert torch.equal(out0, out1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_params_are_trainable(setup):
    _, _, model, _, _ = setup
    from aether_tpu_torch.models.dit import init_dit

    assert all(p.requires_grad for p in model.parameters())
    assert all(p.requires_grad for p in init_dit(DiTConfig.tiny()).parameters())


@pytest.fixture(scope="module")
def loss_case(setup):
    """A batch, injected (t, eps), and the JAX loss and gradient on it."""
    cfg, params, _, _, _ = setup
    b, f, h, w = 2, 2, cfg.sample_height, cfg.sample_width
    rng = np.random.default_rng(9)
    clean = rng.normal(size=(b, f, 56, h, w)).astype(np.float32)
    cond = rng.normal(size=(b, f, 40, h, w)).astype(np.float32)
    text = rng.normal(size=(b, cfg.max_text_seq_length,
                            cfg.text_embed_dim)).astype(np.float32)
    t = np.array([17, 831], np.int64)
    eps = rng.normal(size=clean.shape).astype(np.float32)
    cos, sin = prepare_rotary_positional_embeddings(
        cfg, h * 8, w * 8, f, vae_scale_factor_spatial=8, fps=12)
    batch = (clean, cond, text, np.asarray(cos), np.asarray(sin))
    alphas = compute_alphas_cumprod(JaxSchedulerConfig.aetherv1())
    sqrt_a = jnp.asarray(np.sqrt(alphas), jnp.float32)
    sqrt_1ma = jnp.asarray(np.sqrt(1.0 - alphas), jnp.float32)

    def jax_loss(p):
        return jax_diffusion_loss(
            p, cfg, sqrt_a, sqrt_1ma, *(jnp.asarray(a) for a in batch),
            jax.random.PRNGKey(0), "xla", t=jnp.asarray(t, jnp.int32),
            eps=jnp.asarray(eps))

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(params)
    ref_sd = dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads),
                                     DiTConfig.tiny())
    return batch, t, eps, float(ref_loss), ref_sd


@pytest.mark.parametrize("port_impl", ["xla", "flash_train"])
def test_diffusion_loss_grad_matches_jax(setup, loss_case, port_impl):
    model = setup[2]
    batch, t, eps, ref_loss, ref_sd = loss_case
    model.zero_grad(set_to_none=True)
    tables = noise_schedule(SchedulerConfig.aetherv1(), "cpu")
    loss = diffusion_loss(
        model, *tables, *(torch.from_numpy(a) for a in batch),
        attn_impl=port_impl, t=torch.from_numpy(t), eps=torch.from_numpy(eps),
        remat=True)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    grads = _grads(model)
    model.zero_grad(set_to_none=True)
    assert set(grads) == set(ref_sd)
    for name, g in grads.items():
        ref = ref_sd[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=name)

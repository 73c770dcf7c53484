"""Weight formats of the PyTorch port against the JAX package (CPU, tiny config).

fp8 e4m3 and int8 weight-only, and int8 w8a8 (``act_quant``): the port's
``quantize_dit`` / ``init_quantized_dit`` / ``QuantLinear`` / ``int8_mm``
against ``quantize_dit_params`` / ``init_quantized_dit_params`` / ``_linear``
/ ``_linear_w8a8``, the quantized DiT against ``dit_forward``, and an int8 +
``act_quant`` reconstruction request against the JAX pipeline with its key
streams injected. Weights cross through ``io.from_jax``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aether_tpu.config import DiTConfig as JaxDiTConfig
from aether_tpu.models.dit import (
    _linear,
    dit_forward,
    init_dit_params,
    init_quantized_dit_params,
    quantize_dit_params,
)
from aether_tpu.models.rope import prepare_rotary_positional_embeddings
from aether_tpu_torch.config import DiTConfig
from aether_tpu_torch.io.from_jax import _codes, dit_state_dict_from_jax
from aether_tpu_torch.models.dit import (
    DiT,
    Linear,
    QuantLinear,
    dit_from_state_dict,
    init_dit,
    init_quantized_dit,
    int8_mm,
    int8_mm_plain,
    quantize_activations,
    quantize_dit,
)

torch.set_num_threads(1)

FORMATS = {"fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn), "int8": (jnp.int8, torch.int8)}
F = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, for bit-exact comparison of codes of any dtype."""
    return t.contiguous().view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@pytest.fixture(scope="module")
def params():
    return init_dit_params(jax.random.PRNGKey(3), JaxDiTConfig.tiny())


@pytest.fixture(scope="module")
def inputs():
    cfg = JaxDiTConfig.tiny()
    h, w = cfg.sample_height, cfg.sample_width
    rng = np.random.default_rng(5)
    hidden = rng.normal(size=(1, F, cfg.in_channels, h, w)).astype(np.float32)
    text = rng.normal(size=(1, cfg.max_text_seq_length, cfg.text_embed_dim)).astype(np.float32)
    t = np.array([500], np.int32)
    cos, sin = prepare_rotary_positional_embeddings(
        cfg, h * 8, w * 8, F, vae_scale_factor_spatial=8, fps=12)
    return hidden, text, t, cos, sin


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_quantize_dit_matches_quantize_dit_params(params, fmt):
    """Codes bit-exact and scales exact against the JAX quantizer; the fused
    qkv equals q, k and v quantized apart (per-row scales)."""
    jdtype, tdtype = FORMATS[fmt]
    cfg = DiTConfig.tiny()
    model = DiT(cfg)
    model.load_state_dict(dit_state_dict_from_jax(_np_tree(params), cfg))
    d = cfg.hidden_size
    apart = torch.nn.ModuleList()  # q, k and v of every block as Linears of their own
    for block in model.blocks:
        for j in range(3):
            lin = Linear(d, d)
            lin.weight.data.copy_(block.attn.qkv.weight.detach()[j * d:(j + 1) * d])
            lin.bias.data.copy_(block.attn.qkv.bias.detach()[j * d:(j + 1) * d])
            apart.append(lin)
    quantize_dit(model, tdtype)
    quantize_dit(apart, tdtype)
    qtree = quantize_dit_params(jax.tree_util.tree_map(lambda x: x, params), dtype=jdtype)
    ref = dit_state_dict_from_jax(_np_tree(qtree), cfg)
    got = model.state_dict()
    assert set(got) == set(ref)
    n_codes = 0
    for name, r in ref.items():
        g = got[name]
        if name.endswith(".q"):
            n_codes += 1
            assert g.dtype == r.dtype == tdtype, name
            assert torch.equal(_bits(g), _bits(r)), name
        elif name.endswith(".s"):
            assert g.dtype == torch.float32 and torch.equal(g, r), name
        else:
            assert torch.equal(g.float(), r), name
    assert n_codes == 6 + 6 * cfg.num_layers  # every linear of the DiT
    for i, block in enumerate(model.blocks):
        for j in range(3):
            one = apart[3 * i + j]
            assert torch.equal(_bits(one.q), _bits(block.attn.qkv.q[j * d:(j + 1) * d]))
            assert torch.equal(one.s, block.attn.qkv.s[j * d:(j + 1) * d])


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_init_quantized_dit_layout(fmt):
    """Structure, shapes and dtypes of ``quantize_dit(init_dit(bf16))`` and of
    the JAX ``init_quantized_dit_params`` tree carried across; the JAX
    init's distributions (tests/test_models.py:242 pins the JAX side)."""
    jdtype, tdtype = FORMATS[fmt]
    cfg = DiTConfig.tiny()
    got = init_quantized_dit(cfg, tdtype, seed=0)
    want = quantize_dit(init_dit(cfg, dtype=torch.bfloat16, seed=0), tdtype)
    layout = {k: (tuple(v.shape), v.dtype) for k, v in got.state_dict().items()}
    assert layout == {k: (tuple(v.shape), v.dtype) for k, v in want.state_dict().items()}
    jtree = init_quantized_dit_params(jax.random.PRNGKey(0), JaxDiTConfig.tiny(), dtype=jdtype)
    jsd = dit_state_dict_from_jax(_np_tree(jtree), cfg)
    assert {k: tuple(v.shape) for k, v in jsd.items()} == {k: s for k, (s, _) in layout.items()}
    assert all(jsd[k].dtype == layout[k][1] for k in jsd if k.endswith(".q"))
    for mod in got.modules():
        if isinstance(mod, QuantLinear):
            fan_in = mod.q.shape[1]
            codes = mod.q.float()
            if tdtype == torch.int8:  # uniform(-2, 2) truncated
                assert set(codes.unique().tolist()) <= {-1.0, 0.0, 1.0}
            assert codes.abs().max() <= 2.0 and codes.std() > 0.3
            assert torch.equal(mod.s, torch.full_like(mod.s, 1.0 / fan_in ** 0.5 / 2.0))
            assert mod.bias.dtype == torch.bfloat16
            assert mod.bias.float().abs().max() <= 1.0 / fan_in ** 0.5


# the shapes of tests/test_models.py:393
@pytest.mark.parametrize("fmt,a8", [("fp8", False), ("int8", False), ("int8", True),
                                    ("fp8", True)])
def test_quant_linear_matches_jax_linear(fmt, a8):
    """Weight-only: f32 products in another summation order, within 1e-5 of
    the output's scale. w8a8: activation codes and scales exact, the int32
    sums exact, the output bit-exact. fp8 under a8 takes the weight-only
    branch (tests/test_models.py:407-412)."""
    jdtype, _ = FORMATS[fmt]
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 96)).astype(np.float32) / 8.0
    x = rng.normal(size=(5, 33, 64)).astype(np.float32)
    b = (rng.normal(size=(96,)) * 0.1).astype(np.float32)
    tree = {"attn": {"q_w": jnp.asarray(w)}}
    quantize_dit_params(tree, dtype=jdtype)
    leaf = _np_tree(tree["attn"]["q_w"])
    ref = np.asarray(_linear(jnp.asarray(x), tree["attn"]["q_w"], jnp.asarray(b), a8=a8))
    lin = QuantLinear(_codes(leaf["q"].T), torch.from_numpy(leaf["s"].copy()), torch.from_numpy(b))
    with torch.no_grad():
        got = lin(torch.from_numpy(x), a8).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    if fmt == "int8" and a8:
        xf = jnp.asarray(x)
        sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-6) / 127.0
        xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
        sums = jax.lax.dot_general(xq, jnp.asarray(leaf["q"]), (((2,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
        pq, psx = quantize_activations(torch.from_numpy(x))
        flipped = (pq.int() - torch.from_numpy(np.array(xq)).int()).abs()
        # the K1 rule would allow codes +-1 on <= 1e-3 of them; measured: none
        assert flipped.max() == 0, float((flipped > 0).float().mean())
        assert np.array_equal(psx.numpy(), np.asarray(sx))
        port_sums = int8_mm(pq.reshape(-1, 64), lin.q.t()).reshape(5, 33, 96)
        assert port_sums.dtype == torch.int32
        assert np.array_equal(port_sums.numpy(), np.asarray(sums))
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_int8_mm_plain_is_exact_and_cpu_launches_nothing():
    """The plain product is exact at the largest sums int8 can make (k = 12288,
    every product 127 * 127 or -127 * 127), and a CPU call is no launch."""
    k = 12288
    a = torch.full((3, k), 127, dtype=torch.int8)
    a[1] = -127
    b = torch.full((k, 2), 127, dtype=torch.int8)
    b[:, 1] = torch.tensor([127, -127], dtype=torch.int8).repeat(k // 2)
    before = int8_mm.launches
    got = int8_mm(a, b)
    assert int8_mm.launches == before
    want = torch.tensor([[127 * 127 * k, 0], [-127 * 127 * k, 0], [127 * 127 * k, 0]],
                        dtype=torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(int8_mm_plain(a, b), want)


def _port_quantized(params, fmt):
    jdtype, _ = FORMATS[fmt]
    qtree = quantize_dit_params(jax.tree_util.tree_map(lambda x: x, params), dtype=jdtype)
    return qtree, dit_from_state_dict(dit_state_dict_from_jax(_np_tree(qtree), DiTConfig.tiny()),
                                      DiTConfig.tiny())


@pytest.mark.parametrize("fmt,act_quant", [("fp8", False), ("int8", False), ("int8", True),
                                           ("fp8", True)])
@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_quantized_dit_forward_matches_dit_forward(params, inputs, fmt, act_quant, attn_impl):
    """The port's fused path (plain K1/K2, float attention) and its unfused
    "xla" path against ``dit_forward(attn_impl="xla")`` on the same
    quantized tree, weight-only and with ``act_quant``. Bar 1e-5 (outputs
    up to 2.4): f32 summation order through two blocks; measured at most
    1.5e-6 in every case, so no activation code moved."""
    qtree, model = _port_quantized(params, fmt)
    ref = np.asarray(dit_forward(qtree, JaxDiTConfig.tiny(),
                                 *(jnp.asarray(a) for a in inputs), attn_impl="xla",
                                 act_quant=act_quant))
    with torch.no_grad():
        out = model(*(torch.from_numpy(np.asarray(a)) for a in inputs), qk_int8=False,
                    attn_impl=attn_impl, act_quant=act_quant).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_act_quant_changes_only_int8_codes(params, inputs):
    """``act_quant`` moves the int8 model (w8a8 runs) and leaves the fp8 one
    bit-identical (fp8 takes the weight-only branch)."""
    args = [torch.from_numpy(np.asarray(a)) for a in inputs]
    outs = {}
    for fmt in FORMATS:
        model = _port_quantized(params, fmt)[1]
        with torch.no_grad():
            outs[fmt] = [model(*args, qk_int8=False, act_quant=aq) for aq in (False, True)]
    assert torch.equal(*outs["fp8"])
    assert not torch.equal(*outs["int8"])


def _tiny_quantized_pipelines(act_quant):
    from test_torch_batch_reconstruct import tiny_pipelines

    from aether_tpu.pipeline import AetherPipeline as JaxPipeline
    from aether_tpu_torch.pipeline import AetherPipeline

    jcfg, dit_tree, vae_tree, text, port = tiny_pipelines()
    qtree = quantize_dit_params(jax.tree_util.tree_map(jnp.asarray, dit_tree), dtype=jnp.int8)
    dit = dit_from_state_dict(dit_state_dict_from_jax(_np_tree(qtree), port.config.dit),
                              port.config.dit)
    qport = AetherPipeline(port.config, dit, port.vae, text, device="cpu",
                           compute_dtype=torch.float32, act_quant=act_quant)
    jpipe = JaxPipeline(jcfg, qtree, jax.tree_util.tree_map(jnp.asarray, vae_tree), text,
                        attn_impl="xla", compute_dtype=jnp.float32, act_quant=act_quant)
    return qport, jpipe


def test_int8_act_quant_request_matches_jax_pipeline():
    """A tiny 17x64x96 reconstruction, 4 steps, int8 codes with int8
    activations, the JAX key streams injected, against the JAX pipeline.
    Bars: max abs 4e-2 and mean abs 2e-3 of each output. The port's fused
    attention and JAX's "xla" one differ in f32 summation order (1e-6); a
    difference at a rounding boundary moves an activation code by one, and
    four sampler steps carry it on. Measured: max 1.5e-2 (rgb), 2.0e-2
    (disparity, up to 12), 1.1e-2 (raymap), means 6e-4 to 1.6e-3; the same
    request weight-only reads max 5.3e-3, mean 4e-4."""
    from test_torch_pipeline import SEED, JaxKeyNoise

    port, jpipe = _tiny_quantized_pipelines(True)
    video = np.random.default_rng(11).integers(0, 256, (17, 64, 96, 3), dtype=np.uint8)
    kw = dict(task="reconstruction", video=video, height=64, width=96, num_frames=17,
              num_inference_steps=4, fps=12)
    ref = jpipe(seed=SEED, **kw)
    out = port(noise=JaxKeyNoise(SEED), **kw)
    for name in ("rgb", "disparity", "raymap"):
        got, want = getattr(out, name), np.asarray(getattr(ref, name))
        assert got.shape == want.shape and np.isfinite(got).all(), name
        diff = np.abs(got - want)
        assert diff.max() < 4e-2 and diff.mean() < 2e-3, (name, diff.max(), diff.mean())


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_pipeline_keeps_quantized_buffer_dtypes(fmt, compute_dtype):
    """Building the pipeline moves the models without casting them: codes
    keep their dtype, scales stay f32 (``Module.to(dtype)`` would cast fp8
    codes and the scales)."""
    from aether_tpu_torch.config import PipelineConfig
    from aether_tpu_torch.models.vae import init_vae
    from aether_tpu_torch.pipeline import AetherPipeline

    _, tdtype = FORMATS[fmt]
    cfg = PipelineConfig.tiny()
    dit = init_quantized_dit(cfg.dit, tdtype, seed=0)
    text = np.zeros((1, cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim), np.float32)
    pipe = AetherPipeline(cfg, dit, init_vae(cfg.vae, dtype=compute_dtype), text,
                          device="cpu", compute_dtype=compute_dtype, act_quant=fmt == "int8")
    quant = [m for m in pipe.dit.modules() if isinstance(m, QuantLinear)]
    assert len(quant) == 6 + 6 * cfg.dit.num_layers
    assert all(m.q.dtype == tdtype and m.s.dtype == torch.float32 for m in quant)
    assert not any(isinstance(p, torch.nn.Parameter) and p.dtype in (torch.int8,
                   torch.float8_e4m3fn) for p in pipe.dit.parameters())

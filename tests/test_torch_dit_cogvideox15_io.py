"""The CogVideoX-1.5 DiT of the port (``patch_size_t`` and the ofs
embedding) in its weight formats, converters, checkpoint, random inits and
over a mesh, against the JAX package on the CPU. The config, the inputs and
the tolerances are ``test_torch_dit_cogvideox15.py``'s (its docstring lists
them)."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aether_tpu.io import weights as jax_weights
from aether_tpu.config import DiTConfig as JaxDiTConfig
from aether_tpu.models.dit import (
    dit_forward,
    init_dit_params,
    init_quantized_dit_params,
    quantize_dit_params,
)
from aether_tpu_torch.config import DiTConfig, PipelineConfig
from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax
from aether_tpu_torch.io.weights import (
    convert_dit_state_dict,
    dit_config_from_state_dict,
    load_checkpoint,
    save_checkpoint,
)
from aether_tpu_torch.models.dit import (
    DiT,
    QuantLinear,
    dit_from_state_dict,
    init_dit,
    init_quantized_dit,
    quantize_dit,
)
from aether_tpu_torch.parallel.launch import spawn
from test_torch_dit_cogvideox15 import (  # noqa: F401  (setup is a fixture)
    CFG,
    HERE,
    JCFG,
    KW,
    _jax_in,
    _np_tree,
    _torch_in,
    setup,
)

torch.set_num_threads(1)


FORMATS = {"fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn), "int8": (jnp.int8, torch.int8)}


def _bits(t):
    return t.view(torch.int8) if t.element_size() == 1 else t


@pytest.mark.parametrize("fmt", ["bf16", "fp8", "int8"])
def test_state_dict_from_jax_trees(setup, fmt):
    """``dit_state_dict_from_jax`` on the bf16 tree and on
    ``quantize_dit_params``' fp8 and int8 trees: the port's own conversion
    and quantization give the same tensors bit for bit (JAX quantizes the
    ofs and time embeddings' w1 and w2 too), and the quantized forward
    matches ``dit_forward`` on the tree."""
    params, _, inputs = setup
    bf16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params)
    sd = dit_state_dict_from_jax(_np_tree(bf16), CFG)
    assert {"ofs_embed.w1.weight", "ofs_embed.w1.bias", "ofs_embed.w2.weight",
            "ofs_embed.w2.bias"} <= set(sd)
    assert tuple(sd["proj.weight"].shape) == (CFG.hidden_size, 2 * 4 * CFG.in_channels)
    assert tuple(sd["proj_out.weight"].shape) == (2 * 4 * CFG.out_channels, CFG.hidden_size)
    for name, tensor in sd.items():  # f32 of the bf16 values
        assert torch.equal(tensor, tensor.bfloat16().float()), name
    if fmt == "bf16":
        return
    jdtype, tdtype = FORMATS[fmt]
    qtree = quantize_dit_params(jax.tree_util.tree_map(lambda x: x, params), dtype=jdtype)
    ref = dit_state_dict_from_jax(_np_tree(qtree), CFG)
    assert "ofs_embed.w1.q" in ref and "ofs_embed.w2.q" in ref and "time_embed.w1.q" in ref
    model = DiT(CFG)
    model.load_state_dict(dit_state_dict_from_jax(_np_tree(params), CFG))
    got = quantize_dit(model, tdtype).state_dict()
    assert set(got) == set(ref)
    for name, r in ref.items():
        if name.endswith(".q"):
            assert got[name].dtype == r.dtype == tdtype and torch.equal(
                _bits(got[name]), _bits(r)), name
        else:
            assert torch.equal(got[name].float(), r.float()), name
    qmodel = dit_from_state_dict(ref, CFG)
    assert isinstance(qmodel.ofs_embed.w1, QuantLinear)
    for act_quant in (False, True):
        want = np.asarray(dit_forward(qtree, JCFG, *_jax_in(inputs), attn_impl="xla",
                                      act_quant=act_quant, ofs=jnp.asarray([2.0])))
        with torch.no_grad():
            out = qmodel(*_torch_in(inputs), attn_impl="xla", act_quant=act_quant,
                         ofs=torch.tensor([2.0])).numpy()
        if not act_quant:
            np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
        else:  # codes one apart where summation order moves x / sx across a half
            np.testing.assert_allclose(out, want, rtol=0, atol=5e-3)
            assert np.abs(out - want).mean() <= 1e-4


def _hf_state_dict(params):
    """An upstream (diffusers) CogVideoX-1.5 transformer state dict of the
    JAX tree: a Linear ``patch_embed.proj`` [D, C*pt*p*p], ``proj_out``
    [pt*p*p*C_out, D] and ``ofs_embedding.linear_{1,2}``."""
    p = _np_tree(params)

    def lin(w, b):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(w).T)), torch.from_numpy(b)

    sd = {}

    def put(name, w, b):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = lin(w, b)

    pe, te, oe = p["patch_embed"], p["time_embed"], p["ofs_embed"]
    put("patch_embed.proj", pe["proj_w"], pe["proj_b"])
    put("patch_embed.text_proj", pe["text_w"], pe["text_b"])
    put("time_embedding.linear_1", te["w1"], te["b1"])
    put("time_embedding.linear_2", te["w2"], te["b2"])
    put("ofs_embedding.linear_1", oe["w1"], oe["b1"])
    put("ofs_embedding.linear_2", oe["w2"], oe["b2"])
    blk = p["blocks"]
    for i in range(JCFG.num_layers):
        pre = f"transformer_blocks.{i}"
        for n in ("norm1", "norm2"):
            put(f"{pre}.{n}.linear", blk[n]["w"][i], blk[n]["b"][i])
            sd[f"{pre}.{n}.norm.weight"] = torch.from_numpy(blk[n]["ln_scale"][i])
            sd[f"{pre}.{n}.norm.bias"] = torch.from_numpy(blk[n]["ln_bias"][i])
        a = blk["attn"]
        for n in "qkv":
            put(f"{pre}.attn1.to_{n}", a[f"{n}_w"][i], a[f"{n}_b"][i])
        put(f"{pre}.attn1.to_out.0", a["o_w"][i], a["o_b"][i])
        for n in "qk":
            sd[f"{pre}.attn1.norm_{n}.weight"] = torch.from_numpy(a[f"norm_{n}_scale"][i])
            sd[f"{pre}.attn1.norm_{n}.bias"] = torch.from_numpy(a[f"norm_{n}_bias"][i])
        put(f"{pre}.ff.net.0.proj", blk["mlp"]["w1"][i], blk["mlp"]["b1"][i])
        put(f"{pre}.ff.net.2", blk["mlp"]["w2"][i], blk["mlp"]["b2"][i])
    sd["norm_final.weight"] = torch.from_numpy(p["norm_final"]["scale"])
    sd["norm_final.bias"] = torch.from_numpy(p["norm_final"]["bias"])
    put("norm_out.linear", p["norm_out"]["w"], p["norm_out"]["b"])
    sd["norm_out.norm.weight"] = torch.from_numpy(p["norm_out"]["ln_scale"])
    sd["norm_out.norm.bias"] = torch.from_numpy(p["norm_out"]["ln_bias"])
    put("proj_out", p["proj_out"]["w"], p["proj_out"]["b"])
    return sd


def test_convert_dit_state_dict_matches_jax_converter(setup):
    params, _, inputs = setup
    hf = _hf_state_dict(params)
    got = convert_dit_state_dict(hf, CFG)
    want = dit_state_dict_from_jax(_np_tree(jax_weights.convert_dit_state_dict(hf, JCFG)), CFG)
    assert set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name].float(), w), name
    assert dit_config_from_state_dict(got, DiTConfig.tiny()) == CFG
    assert dit_config_from_state_dict(dit_state_dict_from_jax(
        _np_tree(init_dit_params(jax.random.PRNGKey(0), JaxDiTConfig.tiny())),
        DiTConfig.tiny()), CFG) == DiTConfig.tiny()


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_checkpoint_round_trip(tmp_path, setup, quantize):
    """A converted 1.5 checkpoint (the convert CLI on safetensors shards)
    passes ``--verify`` and loads back through ``load_checkpoint`` as the
    same DiT: its config read from the tensors, its forward bit-identical
    to the one built from the state dict in memory."""
    from safetensors.torch import save_file

    from aether_tpu_torch.io import convert

    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))
    try:
        from make_synthetic_checkpoint import write_synthetic_checkpoint
    finally:
        sys.path.pop(0)

    params, _, inputs = setup
    _, vdir = write_synthetic_checkpoint(tmp_path / "hf", "tiny", seed=0)
    tdir = tmp_path / "hf" / "transformer15"
    tdir.mkdir()
    save_file({k: v.contiguous() for k, v in _hf_state_dict(params).items()},
              str(tdir / "diffusion_pytorch_model.safetensors"))
    out = tmp_path / f"ckpt_{quantize}"
    manifest = convert.convert(str(tdir), vdir, str(out), quantize, "tiny", verify=True)
    assert manifest["ok"], manifest["checks"]
    assert (manifest["patch_size_t"], manifest["ofs_embed_dim"]) == (2, CFG.ofs_embed_dim)
    dit, _, _ = load_checkpoint(str(out), PipelineConfig.tiny())
    assert dit.cfg == CFG
    model = DiT(CFG)
    model.load_state_dict(dit_state_dict_from_jax(_np_tree(params), CFG))
    if quantize == "int8":
        quantize_dit(model, torch.int8)
    args = _torch_in(inputs)
    with torch.no_grad():
        want = model(*args, attn_impl="xla", ofs=torch.tensor([1.0]))
        got = dit(*args, attn_impl="xla", ofs=torch.tensor([1.0]))
    assert torch.equal(got, want)
    # save_checkpoint / load_checkpoint of the port's own state dict too
    save_checkpoint(str(tmp_path / "again"), model.state_dict(), {}, np.zeros((8, 32)))
    dit_sd = torch.load(str(tmp_path / "again" / "dit.pt"), weights_only=True)
    again = dit_from_state_dict(dit_sd, dit_config_from_state_dict(dit_sd, DiTConfig.tiny()))
    with torch.no_grad():
        assert torch.equal(again(*args, attn_impl="xla", ofs=torch.tensor([1.0])), want)


def test_random_inits_draw_the_ofs_embedding():
    """``init_dit`` and ``init_quantized_dit`` (the ``--random-init``
    builders) draw ``ofs_embed`` with JAX's distributions: uniform(+-1 /
    sqrt(fan_in)) weights and biases; codes uniform(-2, 2) cast, scales
    1 / sqrt(fan_in) / 2, bf16 biases; the same layout as the JAX trees."""
    od = CFG.ofs_embed_dim
    model = init_dit(CFG, dtype=torch.bfloat16, seed=1)
    for lin in (model.ofs_embed.w1, model.ofs_embed.w2):
        bound = 1.0 / np.sqrt(od)
        assert lin.weight.dtype == torch.bfloat16
        assert 0.5 * bound < lin.weight.float().abs().max() <= bound
        assert 0.5 * bound < lin.bias.float().abs().max() <= bound
    for fmt, (jdtype, tdtype) in FORMATS.items():
        q = init_quantized_dit(CFG, tdtype, seed=1)
        ref = dit_state_dict_from_jax(_np_tree(init_quantized_dit_params(
            jax.random.PRNGKey(0), JCFG, dtype=jdtype)), CFG)
        got = q.state_dict()
        assert set(got) == set(ref), fmt
        for name, r in ref.items():
            assert got[name].shape == r.shape and got[name].dtype == (
                r.dtype if name.endswith((".q", ".s")) else torch.bfloat16), name
        w1 = q.ofs_embed.w1
        assert torch.all(w1.s == 1.0 / od ** 0.5 / 2.0)
        assert w1.q.float().abs().max() <= 2.0 and w1.bias.float().abs().max() <= 1 / od ** 0.5


# name -> (batch, mesh axes, forward options)
MESH_CASES = {
    "tp2": (2, dict(dp=1, tp=2), dict(fixed_max=True, qk_int8=False)),
    "tp2_int8_w8a8": (2, dict(dp=1, tp=2), dict(fixed_max=True, qk_int8=False, act_quant=True)),
    "sp2": (1, dict(dp=1, tp=1, sp=2), dict(fixed_max=True, qk_int8=False)),
    "dp2": (2, dict(dp=2, tp=1), dict(fixed_max=True, qk_int8=False)),
}


def test_mesh_forwards_match_one_process(setup):
    params, _, inputs = setup
    state = dit_state_dict_from_jax(_np_tree(params), CFG)
    ofs = torch.tensor([2.0, 0.5])  # per-row values: dp splits them with the batch
    cases = []
    for name, (batch, axes, opts) in MESH_CASES.items():
        case_in = tuple(a[:batch] if i < 3 else a for i, a in enumerate(inputs))
        cases.append(dict(name=name, cfg=KW, state=state, inputs=case_in, mesh=axes,
                          opts=dict(opts, ofs=ofs[:batch]),
                          quant=torch.int8 if "int8" in name else None))
    ranks = spawn("test_torch_parallel_dit:rank_cases", 2, dict(cases=cases),
                  extra_path=[HERE], env={"OMP_NUM_THREADS": "1"})
    for case in cases:
        model = DiT(CFG)
        model.load_state_dict(state)
        if case["quant"] is not None:
            quantize_dit(model, case["quant"])
        with torch.no_grad():
            ref = model(*(torch.from_numpy(np.asarray(a)) for a in case["inputs"]),
                        **case["opts"]).numpy()
        for rank, got in enumerate(ranks):
            assert got[case["name"]].shape == ref.shape
            np.testing.assert_allclose(got[case["name"]], ref, rtol=0, atol=1e-5,
                                       err_msg=f"{case['name']} rank {rank}")

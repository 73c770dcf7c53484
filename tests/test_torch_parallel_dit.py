"""The port's DiT over a mesh of gloo ranks on the CPU, against the JAX
package's sharded forward on the conftest's 8-device CPU mesh.

Ranks are separate processes (``parallel.launch.spawn``, the variables
torchrun sets); every case of one world size runs in one spawn. The JAX side
builds the same ``make_mesh(dp, tp, sp)`` over the first devices of the
8-device mesh, with its Pallas kernels in interpret mode
(``attn_impl="flash_interpret"``), from the same numpy weights and inputs:

- tp = 2, dp = 2 and dp x tp = 2 x 2 through K1 + K2 (the fused path), the
  unfused K3 path (``fused_qkv=False``; at dp = 2 over a batch of one, where
  JAX's ``_fused_mesh_ok`` takes it too) and K4 (``fixed_max=False``): 2e-4
  in f32, the JAX tests' bar (``tests/test_sharded_inference.py``);
- the int8 QK^T at tp = 2, and at six heads (three a rank: head groups of
  3, as the 48-head model has at tp = 8): against JAX's sharded int8 run at
  the float tolerance, its stats being grouped the same, and against the
  unsharded float forward within 5e-2 (``test_sharded_inference.py:103``);
- ``shard_params`` on int8 w8a8, int8 weight-only and fp8 ``QuantLinear``s:
  the port's unsharded forward of the same codes within 1e-5.

The sequence-parallel cases are in ``test_torch_parallel_sp.py``.
"""

import os

import numpy as np
import pytest
import torch

from aether_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = dict(num_layers=2, num_heads=4, head_dim=16, text_embed_dim=32,
           max_text_seq_length=8, time_embed_dim=32, sample_height=8, sample_width=10)
CFG6 = dict(CFG, num_heads=6)
CONFIGS = {"cfg": CFG, "cfg6": CFG6}
F, H, W = 3, 8, 10
ENV = {"OMP_NUM_THREADS": "1"}


def rank_cases(cases):
    """Every case's forward on this rank: {name: output} and {name +
    "/collectives": (all-reduces, all-gathers) of the forward}. A case holds
    the DiT config and state dict, the inputs, the mesh axes, the forward's
    options, an optional weight format and the ``AETHER_SP_RING`` setting."""
    import torch.distributed as dist

    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.models.dit import DiT, quantize_dit
    from aether_tpu_torch.parallel import initialize, make_mesh, shard_params

    torch.set_num_threads(1)
    initialize(device="cpu")
    calls = {"all_reduce": 0, "all_gather": 0}

    def counted(name):
        real = getattr(dist, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)

        setattr(dist, name, call)

    counted("all_reduce")
    counted("all_gather")
    outs = {}
    for case in cases:
        model = DiT(DiTConfig(**case["cfg"]))
        model.load_state_dict(case["state"])
        if case.get("quant"):
            quantize_dit(model, case["quant"])
        shard_params(model, make_mesh(**case["mesh"]))
        os.environ["AETHER_SP_RING"] = "1" if case.get("ring") else "0"
        calls.update(all_reduce=0, all_gather=0)
        with torch.no_grad():
            out = model(*(torch.from_numpy(a) for a in case["inputs"]), **case["opts"])
        outs[case["name"]] = out.numpy()
        outs[case["name"] + "/collectives"] = (calls["all_reduce"], calls["all_gather"])
        if case.get("quant"):
            blk = model.blocks[0]
            outs[case["name"] + "/layout"] = {
                "qkv": (blk.attn.qkv.q.clone(), blk.attn.qkv.s.clone()),
                "w1": (blk.mlp.w1.q.clone(), blk.mlp.w1.s.clone()),
                "w2": (blk.mlp.w2.inner.q.clone(), blk.mlp.w2.inner.s.clone())}
    return outs


def make_case(cfg_kw, batch, seed=6, height=H):
    """(JAX config, JAX params, port state dict, inputs) of a small DiT, its
    latents (batch, F, C, height, W)."""
    import jax

    from aether_tpu.config import DiTConfig as JaxDiTConfig
    from aether_tpu.models.dit import init_dit_params
    from aether_tpu.models.rope import prepare_rotary_positional_embeddings
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax

    cfg = JaxDiTConfig(**cfg_kw)
    params = init_dit_params(jax.random.PRNGKey(seed), cfg)
    state = dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                    DiTConfig(**cfg_kw))
    rng = np.random.default_rng(12)
    hidden = rng.normal(size=(batch, F, cfg.in_channels, height, W)).astype(np.float32)
    text = rng.normal(size=(batch, cfg.max_text_seq_length,
                            cfg.text_embed_dim)).astype(np.float32)
    t = np.full((batch,), 500, np.int64)
    cos, sin = prepare_rotary_positional_embeddings(
        cfg, height * 8, W * 8, F, vae_scale_factor_spatial=8, fps=12)
    inputs = (hidden, text, t, np.asarray(cos, np.float32), np.asarray(sin, np.float32))
    return cfg, params, state, inputs


def jax_forward(cfg, params, inputs, mesh_axes=None, **opts):
    """JAX ``dit_forward`` on ``make_mesh(**mesh_axes)`` over the first
    devices (flash kernels interpreted), or unsharded without axes."""
    import jax
    import jax.numpy as jnp

    from aether_tpu.models.dit import dit_forward
    from aether_tpu.parallel.mesh import dit_param_sharding, make_mesh, shard_params

    hidden, text, t, cos, sin = (jnp.asarray(a) for a in inputs)
    t = t.astype(jnp.int32)
    if mesh_axes is None:
        return np.asarray(dit_forward(params, cfg, hidden, text, t, cos, sin, **opts))
    n = int(np.prod([v for v in mesh_axes.values() if v]))
    mesh = make_mesh(**mesh_axes, devices=jax.devices()[:n])
    sharded = shard_params(params, dit_param_sharding(cfg, mesh), mesh)
    with mesh:
        out = jax.jit(lambda p, x, e, ts: dit_forward(
            p, cfg, x, e, ts, cos, sin, attn_impl="flash_interpret", mesh=mesh,
            **opts))(sharded, hidden, text, t)
    return np.asarray(out)


# name -> (config, batch, mesh axes, options): the port's forward options,
# which are also JAX dit_forward's
CASES = {
    "tp2": ("cfg", 2, dict(dp=1, tp=2), dict(fixed_max=True, qk_int8=False)),
    "dp2": ("cfg", 2, dict(dp=2, tp=1), dict(fixed_max=True, qk_int8=False)),
    # dp does not divide the batch and tp is 1: the unfused path, unsharded
    # (JAX _fused_mesh_ok)
    "dp2_batch1": ("cfg", 1, dict(dp=2, tp=1), dict(fixed_max=True, qk_int8=False)),
    "tp2_unfused": ("cfg", 2, dict(dp=1, tp=2),
                    dict(fixed_max=True, qk_int8=False, fused_qkv=False)),
    "tp2_k4": ("cfg", 2, dict(dp=1, tp=2), dict(fixed_max=False)),
    "tp2_int8": ("cfg", 2, dict(dp=1, tp=2), dict(fixed_max=True, qk_int8=True)),
    "tp2_hper3_int8": ("cfg6", 1, dict(dp=1, tp=2), dict(fixed_max=True, qk_int8=True)),
    "dp2_tp2": ("cfg", 2, dict(dp=2, tp=2), dict(fixed_max=True, qk_int8=False)),
    "dp2_tp2_unfused": ("cfg", 2, dict(dp=2, tp=2),
                        dict(fixed_max=True, qk_int8=False, fused_qkv=False)),
}
QUANT = {"w8a8": (torch.int8, True), "int8_weight_only": (torch.int8, False),
         "fp8": (torch.float8_e4m3fn, False)}


def _world(mesh_axes):
    return int(np.prod([v for v in mesh_axes.values() if v]))


@pytest.fixture(scope="module")
def setup():
    made = {key: make_case(CONFIGS[key[0]], key[1])
            for key in {(c, b) for c, b, _, _ in CASES.values()} | {("cfg", 2)}}
    cases = {2: [], 4: []}
    for name, (cfg_name, batch, axes, opts) in CASES.items():
        _, _, state, inputs = made[cfg_name, batch]
        cases[_world(axes)].append(dict(name=name, cfg=CONFIGS[cfg_name], state=state,
                                        inputs=inputs, mesh=axes, opts=opts))
    _, _, state, inputs = made["cfg", 2]
    for name, (dtype, a8) in QUANT.items():
        cases[2].append(dict(name=name, cfg=CFG, state=state, inputs=inputs,
                             mesh=dict(dp=1, tp=2), quant=dtype,
                             opts=dict(fixed_max=True, qk_int8=False, act_quant=a8)))
    ranks = {n: spawn(f"{__name__}:rank_cases", n, dict(cases=c), extra_path=[HERE], env=ENV)
             for n, c in cases.items()}
    return made, ranks


def _rank_outputs(ranks, name, axes):
    outs = [r[name] for r in ranks[_world(axes)]]
    for i, out in enumerate(outs[1:], 1):
        np.testing.assert_array_equal(out, outs[0], err_msg=f"rank {i} differs from rank 0")
    return outs[0]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_forward_matches_jax_sharded(setup, name):
    made, ranks = setup
    cfg_name, batch, axes, opts = CASES[name]
    cfg, params, _, inputs = made[cfg_name, batch]
    got = _rank_outputs(ranks, name, axes)
    ref = jax_forward(cfg, params, inputs, axes, **opts)
    assert got.shape == ref.shape == inputs[0].shape[:2] + (cfg.out_channels, H, W)
    np.testing.assert_allclose(got, ref, atol=2e-4, err_msg=name)
    if opts.get("qk_int8"):
        unsharded = jax_forward(cfg, params, inputs, attn_impl="xla")
        np.testing.assert_allclose(got, unsharded, atol=5e-2, err_msg=f"{name} vs float")


# (all-reduces, all-gathers) of one forward of the 2-block DiT: two a block
# at tp > 1 (after attn.o and mlp.w2) and one after proj_out; w8a8 adds the
# per-token activation maximum before each block's two; the patch embedding
# gathers its columns twice (video, text); dp gathers the output once
COLLECTIVES = {"tp2": (2 * 2 + 1, 2), "dp2": (0, 1), "dp2_tp2": (2 * 2 + 1, 2 + 1),
               "w8a8": (2 * 2 * 2 + 1, 2), "tp2_k4": (2 * 2 + 1, 2)}


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collectives_of_a_forward(setup, name):
    _, ranks = setup
    world = 4 if name == "dp2_tp2" else 2
    for rank, got in enumerate(ranks[world]):
        assert got[name + "/collectives"] == COLLECTIVES[name], (rank, name)


@pytest.mark.parametrize("name", list(QUANT))
def test_quantized_linears_shard_to_the_unsharded_forward(setup, name):
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.models.dit import DiT, quantize_dit

    made, ranks = setup
    _, _, state, inputs = made["cfg", 2]
    dtype, a8 = QUANT[name]
    model = DiT(DiTConfig(**CFG))
    model.load_state_dict(state)
    quantize_dit(model, dtype)
    with torch.no_grad():
        ref = model(*(torch.from_numpy(a) for a in inputs), fixed_max=True, qk_int8=False,
                    act_quant=a8).numpy()
    got = _rank_outputs(ranks, name, dict(dp=1, tp=2))
    np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=name)
    # each rank's codes are its rows (column split; the per-output scales
    # follow) or its columns (row split; the scales stay whole), and the
    # fused qkv's rows are its heads' q, k and v
    full = model.blocks[0]
    d, m = CFG["num_heads"] * CFG["head_dim"], full.mlp.w1.q.shape[0]
    for rank, out in enumerate(ranks[2]):
        layout = out[name + "/layout"]
        rows = torch.cat([torch.arange(j * d + rank * d // 2, j * d + (rank + 1) * d // 2)
                          for j in range(3)])
        expect = {"qkv": (full.attn.qkv.q[rows], full.attn.qkv.s[rows]),
                  "w1": (full.mlp.w1.q[rank * m // 2:(rank + 1) * m // 2],
                         full.mlp.w1.s[rank * m // 2:(rank + 1) * m // 2]),
                  "w2": (full.mlp.w2.q[:, rank * m // 2:(rank + 1) * m // 2], full.mlp.w2.s)}
        for key, (q, sc) in expect.items():
            assert layout[key][0].dtype == dtype, key
            assert torch.equal(layout[key][0].view(torch.int8), q.view(torch.int8)), key
            assert torch.equal(layout[key][1], sc), key

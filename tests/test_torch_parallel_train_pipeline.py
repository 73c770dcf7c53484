"""The port's GPipe executor (``parallel/pipeline.py``) over gloo ranks on
the CPU, against the JAX ``make_pipeline_block_scan`` on the conftest's
8-device CPU mesh (``tests/test_pipeline_parallel.py``).

Each (pp, dp, n_micro, batch) case runs the 4-block test DiT of the JAX
tests, its weights converted from the JAX init, on ``pp * dp`` spawned
ranks (``parallel.launch.spawn``): the forward through the executor and the
gradients of ``sum(out ** 2)``, seeded and reduced as the executor says
(``seed_loss``, ``reduce_grads``), against one ``jax.value_and_grad`` of the
same loss through the JAX executor on the same mesh. Tolerances: the
forward 2e-4 (``test_pipeline_parallel.py:84``), the gradients atol 5e-3 /
rtol 1e-3 (``:109``). One case runs the port with remat (``:113``). The
shape guards raise the JAX messages (``:188``).
"""

import os

import numpy as np
import pytest
import torch

from aether_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ENV = {"OMP_NUM_THREADS": "1"}
F, H, W = 3, 8, 12
CFG = dict(num_layers=4, num_heads=4, head_dim=16, text_embed_dim=32,
           max_text_seq_length=8, time_embed_dim=32, sample_height=8, sample_width=12)
# (pp, dp, n_micro, batch, remat): the JAX forward test's cases, its dp one
# at four ranks (pp 2, dp 2) in place of eight
CASES = [(4, 1, 4, 4, False), (2, 1, 4, 8, True), (2, 2, 4, 8, False)]


def _inputs(batch, seed=21):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(batch, F, 96, H, W)).astype(np.float32)
    text = rng.normal(size=(batch, 8, 32)).astype(np.float32)
    t = rng.integers(0, 1000, size=(batch,)).astype(np.int64)
    return hidden, text, t


def _rope():
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings

    cos, sin = prepare_rotary_positional_embeddings(
        DiTConfig(**CFG), H * 8, W * 8, F, vae_scale_factor_spatial=8, fps=12)
    return np.asarray(cos, np.float32), np.asarray(sin, np.float32)


def rank_cases(cases, state, guards=False):
    """Every case on this rank: the executor's output and the reduced
    gradients of ``sum(out ** 2)``; with ``shard`` the model keeps its
    stage's blocks (``shard_blocks_pp``) and returns those gradients by
    their unsharded names. ``guards`` adds :func:`rank_guards`' messages."""
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.models.dit import DiT
    from aether_tpu_torch.parallel import initialize
    from aether_tpu_torch.parallel.pipeline import (
        make_pipeline_block_scan,
        make_pp_mesh,
        shard_blocks_pp,
    )

    torch.set_num_threads(1)
    initialize(device="cpu")
    cos, sin = (torch.from_numpy(a) for a in _rope())
    outs = {}
    for case in cases:
        pp, dp, n_micro, batch, remat = case["key"]
        mesh = make_pp_mesh(pp, dp)
        model = DiT(DiTConfig(**CFG))
        model.load_state_dict(state)
        if case["shard"]:
            shard_blocks_pp(model, mesh)
        scan = make_pipeline_block_scan(mesh, n_micro)
        hidden, text, t = (torch.from_numpy(a) for a in _inputs(batch))
        out = model(hidden, text, t, cos, sin, attn_impl="xla", remat=remat, block_scan=scan)
        scan.seed_loss(out.square().sum()).backward()
        scan.reduce_grads(model)
        start = getattr(model.blocks, "start", 0)
        grads = {}
        for name, p in model.named_parameters():
            if name.startswith("blocks.") and case["shard"]:
                i, rest = name.split(".", 2)[1:]
                name = f"blocks.{int(i) + start}.{rest}"
            grads[name] = p.grad.numpy().copy()
        outs[case["key"]] = (out.detach().numpy(), grads)
    if guards:
        outs["guards"] = rank_guards()
    return outs


def rank_guards():
    """The executor's checks on four joined ranks: {name: message} of
    each."""
    from torch.distributed.device_mesh import init_device_mesh

    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.models.dit import DiT
    from aether_tpu_torch.parallel.pipeline import (
        make_pipeline_block_scan,
        make_pp_mesh,
        shard_blocks_pp,
    )

    cos, sin = (torch.from_numpy(a) for a in _rope())
    hidden, text, t = (torch.from_numpy(a) for a in _inputs(4))
    got = {}

    def catch(name, fn):
        try:
            fn()
            got[name] = None
        except ValueError as e:
            got[name] = str(e)

    model = DiT(DiTConfig(**CFG))
    mesh4 = make_pp_mesh(4, 1)

    def fwd(m, scan, **kw):
        with torch.no_grad():
            return m(hidden, text, t, cos, sin, attn_impl="xla", block_scan=scan, **kw)

    catch("n_micro", lambda: fwd(model, make_pipeline_block_scan(mesh4, 3)))
    catch("dp", lambda: fwd(model, make_pipeline_block_scan(make_pp_mesh(2, 2), 4)))
    six = DiT(DiTConfig(**dict(CFG, num_layers=6)))
    catch("layers", lambda: fwd(six, make_pipeline_block_scan(mesh4, 4)))
    catch("shard_layers", lambda: shard_blocks_pp(DiT(DiTConfig(**dict(CFG, num_layers=6))),
                                                  mesh4))
    catch("extra_axes", lambda: make_pipeline_block_scan(
        init_device_mesh("cpu", (2, 2), mesh_dim_names=("tp", "pp")), 2))
    catch("no_pp", lambda: make_pipeline_block_scan(
        init_device_mesh("cpu", (4,), mesh_dim_names=("dp",)), 2))
    catch("collect", lambda: fwd(model, make_pipeline_block_scan(mesh4, 4), collect_blocks=True))
    return got


@pytest.fixture(scope="module")
def setup():
    import jax

    from aether_tpu.config import DiTConfig as JaxDiTConfig
    from aether_tpu.models.dit import init_dit_params
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax

    jcfg = JaxDiTConfig(**CFG)
    params = init_dit_params(jax.random.PRNGKey(21), jcfg)
    state = dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                    DiTConfig(**CFG))
    by_world = {}
    for i, key in enumerate(CASES):
        # the remat case keeps its stage's blocks, the others the whole stack
        by_world.setdefault(key[0] * key[1], []).append(dict(key=key, shard=i % 2 == 1))
    ranks = {n: spawn(f"{__name__}:rank_cases", n, dict(cases=c, state=state, guards=n == 4),
                      extra_path=[HERE], env=ENV)
             for n, c in by_world.items()}
    return jcfg, params, ranks, [r["guards"] for r in ranks[4]]


def _jax_value_and_grads(jcfg, params, key):
    """The JAX executor's output and the gradients of sum(out ** 2) on the
    (dp, pp) mesh over the first devices."""
    import jax
    import jax.numpy as jnp

    from aether_tpu.models.dit import dit_forward
    from aether_tpu.parallel.pipeline import make_pipeline_block_scan, make_pp_mesh
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax

    pp, dp, n_micro, batch, _ = key
    hidden, text, t = _inputs(batch)
    cos, sin = (jnp.asarray(a) for a in _rope())
    mesh = make_pp_mesh(pp, dp, devices=jax.devices()[:pp * dp])
    scan = make_pipeline_block_scan(mesh, n_micro=n_micro)

    def loss(p):
        out = dit_forward(p, jcfg, jnp.asarray(hidden), jnp.asarray(text),
                          jnp.asarray(t, jnp.int32), cos, sin, attn_impl="xla",
                          block_scan=scan)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    grads = dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                                    DiTConfig(**CFG))
    return np.asarray(out), {k: v.numpy() for k, v in grads.items()}


@pytest.mark.parametrize("key", CASES, ids=[f"pp{c[0]}_dp{c[1]}_m{c[2]}_b{c[3]}"
                                            + ("_remat" if c[4] else "") for c in CASES])
def test_pp_forward_and_grads_match_jax_executor(setup, key):
    jcfg, params, ranks, _ = setup
    ref_out, ref_grads = _jax_value_and_grads(jcfg, params, key)
    results = [r[key] for r in ranks[key[0] * key[1]]]
    # a rank holding its stage's blocks has their gradients only; together
    # the ranks hold every one
    assert set().union(*(grads for _, grads in results)) == set(ref_grads)
    for rank, (out, grads) in enumerate(results):
        assert out.shape == ref_out.shape == (key[3], F, 56, H, W)
        np.testing.assert_allclose(out, ref_out, atol=2e-4, err_msg=f"rank {rank}")
        for name, g in grads.items():
            np.testing.assert_allclose(g, ref_grads[name], atol=5e-3, rtol=1e-3,
                                       err_msg=f"rank {rank} {name}")
    # the gradients are not vacuous: every block's weights moved
    assert min(float(np.abs(g).max()) for _, grads in results for n, g in grads.items()
               if n.endswith("mlp.w1.weight")) > 1e-3


GUARDS = {
    "n_micro": "batch 4 not divisible by n_micro 3",
    "dp": "microbatch 1 not divisible by dp 2",
    "layers": "layers 6 not divisible by pp 4",
    "shard_layers": "layers 6 not divisible by pp 4",
    "extra_axes": "composes with 'dp' only",
    "no_pp": "has no 'pp' axis",
    "collect": "collect_blocks is unsupported",
}


@pytest.mark.parametrize("name", list(GUARDS))
def test_pp_shape_guards(setup, name):
    for rank, got in enumerate(setup[3]):
        assert got[name] is not None and GUARDS[name] in got[name], (rank, got[name])

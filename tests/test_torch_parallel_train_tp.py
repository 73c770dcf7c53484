"""The port's ``Trainer`` on ("dp", "tp") meshes of gloo ranks, against the
JAX mesh ``Trainer`` on the conftest's 8-device CPU mesh, and the sharded
global-norm clip against the unsharded norm.

The JAX trainers start from ``seed=0`` on ``make_mesh(dp, tp)`` over the
first devices; the port's start from the converted JAX weights, train on the
same ``synthetic_batches`` and get the JAX key stream's (t, eps) injected for
the whole batch (each rank keeps its dp rows). Tolerances are
``tests/test_fsdp.py``'s (``:102-109``): losses rtol 2e-4 / atol 2e-5,
parameters and EMA rtol 5e-4 / atol 5e-5.

The clip: the gradient norm each step reads over tp = 2, dp = 2 (the dp
mean all-reduced), dp x tp = 2 x 2 with and without FSDP, and pp = 2, on
every rank, against the one-process port trainer's on the same weights and
draws, within 1e-5 relative (an f32 sum in another order); a norm that
counted a replicated piece twice would be off by a factor up to 2.
"""

import os

import numpy as np
import pytest
import torch

from torch_train_ranks import jax_draws, jax_state_dict, rank_trainers, spawn_async

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ENV = {"OMP_NUM_THREADS": "1"}
BATCH, STEPS, DATA_SEED = 4, 3, 3
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, total_steps=6, grad_clip_norm=0.1,
             remat=False, log_every=1)
# name -> (world, mesh spec, fsdp); the JAX comparison's meshes first
MESHES = {"tp2": (2, ("tp", 1, 2), False), "dp2_tp2": (4, ("tp", 2, 2), False),
          "dp2": (2, ("tp", 2, 1), False), "dp2_tp2_fsdp": (4, ("tp", 2, 2), True),
          "pp2": (2, ("pp", 2, 1), False)}
JAX_MESHES = {"tp2": dict(dp=1, tp=2), "dp2_tp2": dict(dp=2, tp=2)}


@pytest.fixture(scope="module")
def setup():
    import jax

    from aether_tpu.config import DiTConfig as JaxDiTConfig
    from aether_tpu.models.dit import init_dit_params
    from aether_tpu.parallel.mesh import make_mesh
    from aether_tpu.train.trainer import TrainConfig, Trainer, synthetic_batches
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.train.trainer import (
        TrainConfig as PortTrainConfig,
        Trainer as PortTrainer,
        synthetic_batches as port_batches,
    )
    from torch_train_ranks import ListNoise

    cfg = JaxDiTConfig.tiny()
    params = jax.jit(init_dit_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    init = jax_state_dict(params)
    draws = jax_draws(0, (BATCH, 2, 56, 8, 12), STEPS)
    cases = {}
    for name, (world, spec, fsdp) in MESHES.items():
        cases.setdefault(world, []).append(dict(
            name=name, mesh=spec, fsdp=fsdp, init=init, draws=draws, train=TRAIN,
            batch=BATCH, data_seed=DATA_SEED, steps=STEPS))
    futures = {n: spawn_async("torch_train_ranks:rank_trainers", n, dict(cases=c),
                              extra_path=[HERE], env=ENV) for n, c in cases.items()}
    # the one-process port trainer: the norms' reference
    one = PortTrainer(DiTConfig.tiny(), PortTrainConfig(**TRAIN), device="cpu",
                      init_params={k: torch.from_numpy(v) for k, v in init.items()},
                      noise=ListNoise(draws))
    one_norms, batches = [], port_batches(DiTConfig.tiny(), batch_size=BATCH, seed=DATA_SEED)
    for _ in range(STEPS):
        one.fit(batches, steps=1)
        one_norms.append(float(one.state.optimizer.grad_norm))
    refs = {}
    for name, axes in JAX_MESHES.items():
        n = axes["dp"] * axes["tp"]
        jt = Trainer(cfg, TrainConfig(**TRAIN), seed=0, init_params=params,
                     mesh=make_mesh(**axes, devices=jax.devices()[:n]))
        losses = jt.fit(synthetic_batches(cfg, batch_size=BATCH, seed=DATA_SEED), steps=STEPS)
        refs[name] = (losses, jax_state_dict(jt.state.params),
                      jax_state_dict(jt.state.ema_params))
    return dict(refs=refs, init=init, one_norms=one_norms,
                ranks={n: f.result() for n, f in futures.items()})


@pytest.mark.parametrize("name", list(JAX_MESHES))
def test_mesh_trainer_matches_jax_mesh_trainer(setup, name):
    world = MESHES[name][0]
    results = [r[name] for r in setup["ranks"][world]]
    losses, params, ema = setup["refs"][name]
    for rank, res in enumerate(results):
        assert res["step"] == STEPS
        np.testing.assert_allclose(res["losses"], losses, rtol=2e-4, atol=2e-5,
                                   err_msg=f"rank {rank}")
        assert res["losses"] == results[0]["losses"]  # every rank reports one loss
    state = results[0]["state"]
    assert set(state["params"]) == set(params)
    init = setup["init"]
    assert max(float(np.abs(params[n] - init[n]).max()) for n in init) > 1e-4
    for key, ref in (("params", params), ("ema_params", ema)):
        for n, want in ref.items():
            np.testing.assert_allclose(state[key][n].numpy(), want, rtol=5e-4, atol=5e-5,
                                       err_msg=f"{name} {key} {n}")


@pytest.mark.parametrize("name", list(MESHES))
def test_global_norm_clip_matches_unsharded_norm(setup, name):
    world = MESHES[name][0]
    want = setup["one_norms"]
    assert min(want) > TRAIN["grad_clip_norm"]  # the clip scaled every step's gradients
    for rank, r in enumerate(setup["ranks"][world]):
        np.testing.assert_allclose(r[name]["norms"], want, rtol=1e-5, err_msg=f"rank {rank}")


def test_sp_and_dp_gathers_refuse_a_gradient():
    """``all_gather_cat`` (the sp K/V and dp output gathers, whose ranks
    hold different gradients of the result) raises on a tensor that needs a
    gradient instead of dropping the other ranks' share; without one it
    runs (inference)."""
    from aether_tpu_torch.models.dit import all_gather_cat

    t = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="carries no gradient"):
        all_gather_cat(t, 0, None)
    with torch.no_grad(), pytest.raises(Exception) as err:
        all_gather_cat(t, 0, None)  # passes the check; no process group here
    assert "carries no gradient" not in str(err.value)

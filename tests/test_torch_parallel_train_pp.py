"""The port's ``Trainer`` on a ("dp", "pp") mesh of gloo ranks, against the
JAX pp ``Trainer`` and the unsharded one on the conftest's 8-device CPU mesh
(``tests/test_pipeline_parallel.py:122-186``).

The JAX trainers start from ``seed=5`` and draw (t, eps) from their key
stream; the port's start from the converted JAX weights and get the same
draws injected (``torch_train_ranks.jax_draws``), for the whole batch on
every rank (the executor cuts each rank's dp rows). Tolerances are ``tests/test_fsdp.py``'s
(``:102-109``): losses rtol 2e-4 / atol 2e-5, parameters and EMA rtol 5e-4 /
atol 5e-5; the losses against the unsharded JAX trainer at the JAX pp
test's rtol 1e-4. As ``test_pp_train_step_matches_unsharded`` (``:122-163``)
holds the JAX pp step to the JAX unsharded one, ``make_train_step(
block_scan=...)`` takes one AdamW step of the tiny DiT at pp = 2 against
the port's unsharded ``make_train_step`` (held to JAX in
``test_torch_train_step.py``) at that test's bars. The ranks run while the
JAX references compile.
"""

import os

import numpy as np
import pytest
import torch

from torch_train_ranks import jax_draws, jax_state_dict, rank_trainers, spawn_async

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ENV = {"OMP_NUM_THREADS": "1"}
BATCH, STEPS, SEED = 4, 2, 5
TRAIN = dict(learning_rate=1e-4, total_steps=2, warmup_steps=1, log_every=1, remat=False)
# name -> (pp, dp, remat): the JAX test's pp = 2, and pp x dp = 2 x 2
MESHES = {"pp2": (2, 1, False), "pp2_dp2": (2, 2, True)}


def _step_batch():
    """The JAX pp train-step test's batch shapes (``test_pipeline_parallel.
    py:134-150``), seeded: 4 rows of latents of the tiny DiT."""
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings

    cfg = DiTConfig.tiny()
    cos, sin = prepare_rotary_positional_embeddings(cfg, 64, 96, 3, vae_scale_factor_spatial=8,
                                                    fps=12)
    rng = np.random.default_rng(3)
    return {
        "clean_latents": rng.normal(size=(4, 3, cfg.out_channels, 8, 12)).astype(np.float32),
        "condition_latents": rng.normal(
            size=(4, 3, cfg.in_channels - cfg.out_channels, 8, 12)).astype(np.float32),
        "text_embeds": rng.normal(size=(4, 8, 32)).astype(np.float32),
        "rope_cos": np.asarray(cos, np.float32), "rope_sin": np.asarray(sin, np.float32),
    }


def rank_train_step(state, batch, t, eps):
    """One ``make_train_step(block_scan=...)`` AdamW step (lr 1e-4) of the
    tiny DiT at pp = 2, n_micro = 2, and one unsharded step from the same
    weights: {"pp" / "one": (loss, the updated parameters by unsharded
    names)} (the pp parameters on rank 0)."""
    from aether_tpu_torch.config import DiTConfig, SchedulerConfig
    from aether_tpu_torch.models.dit import DiT
    from aether_tpu_torch.parallel import is_main
    from aether_tpu_torch.parallel.mesh import ParamLayout
    from aether_tpu_torch.parallel.pipeline import (
        make_pipeline_block_scan,
        make_pp_mesh,
        shard_blocks_pp,
    )
    from aether_tpu_torch.train.step import create_train_state, make_train_step

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for name in ("one", "pp"):
        model = DiT(DiTConfig.tiny())
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        block_scan = None
        if name == "pp":
            mesh = make_pp_mesh(2, 1)
            shard_blocks_pp(model, mesh)
            block_scan = make_pipeline_block_scan(mesh, 2)
        st = create_train_state(model, learning_rate=1e-4)
        step = make_train_step(SchedulerConfig.aetherv1(), block_scan=block_scan)
        loss = step(st, tb, t=torch.from_numpy(t), eps=torch.from_numpy(eps))
        named = dict(model.named_parameters())
        params = (ParamLayout(model, mesh).gather(lambda n: named[n]) if block_scan
                  else model.state_dict())
        out[name] = (float(loss), {k: v.detach().numpy() for k, v in params.items()}
                     if is_main() else None)
    return out


def rank_pp(cases, step_args=None):
    """The trainer cases, then (at pp = 2) the train-step case."""
    out = rank_trainers(cases)
    if step_args is not None:
        out["train_step"] = rank_train_step(**step_args)
    return out


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp

    from aether_tpu.config import DiTConfig as JaxDiTConfig
    from aether_tpu.models.dit import init_dit_params
    from aether_tpu.parallel.pipeline import make_pp_mesh
    from aether_tpu.train.trainer import TrainConfig, Trainer, synthetic_batches

    cfg = JaxDiTConfig.tiny()
    tc = TrainConfig(**TRAIN)
    init_jit = jax.jit(init_dit_params, static_argnums=1)
    # the Trainer's own init (init_dit_params at its seed), compiled once
    ref = Trainer(cfg, tc, seed=SEED, init_params=init_jit(jax.random.PRNGKey(SEED), cfg))
    init = jax_state_dict(ref.state.params)
    draws = jax_draws(SEED, (BATCH, 2, 56, 8, 12), STEPS)
    # the train-step case: the trainer's weights, a batch, the draws of a key
    key_t, key_eps = jax.random.split(jax.random.PRNGKey(11))
    batch = _step_batch()
    t = np.asarray(jax.random.randint(key_t, (4,), 0, 1000)).astype(np.int64)
    eps = np.array(jax.random.normal(key_eps, batch["clean_latents"].shape, jnp.float32))
    step_args = dict(state=init, batch=batch, t=t, eps=eps)
    cases = {}
    for name, (n_pp, dp, remat) in MESHES.items():
        cases.setdefault(n_pp * dp, []).append(dict(
            name=name, mesh=("pp", n_pp, dp), n_micro=2, init=init, draws=draws,
            train=dict(TRAIN, remat=remat), batch=BATCH, data_seed=0, steps=STEPS))
    futures = {n: spawn_async(f"{__name__}:rank_pp", n,
                              dict(cases=c, step_args=step_args if n == 2 else None),
                              extra_path=[HERE], env=ENV) for n, c in cases.items()}

    ref_losses = ref.fit(synthetic_batches(cfg, batch_size=BATCH), steps=STEPS)
    pp = Trainer(cfg, tc, mesh=make_pp_mesh(2, 1, devices=jax.devices()[:2]), seed=SEED,
                 pp_microbatches=2)
    pp_losses = pp.fit(synthetic_batches(cfg, batch_size=BATCH), steps=STEPS)
    return dict(ref=(ref_losses, jax_state_dict(ref.state.params),
                     jax_state_dict(ref.state.ema_params)),
                pp=(pp_losses, jax_state_dict(pp.state.params),
                    jax_state_dict(pp.state.ema_params)),
                step_init=step_args["state"],
                ranks={n: f.result() for n, f in futures.items()})


@pytest.mark.parametrize("name", list(MESHES))
def test_pp_trainer_matches_jax_pp_trainer(setup, name):
    n_pp, dp, _ = MESHES[name]
    results = [r[name] for r in setup["ranks"][n_pp * dp]]
    losses, params, ema = setup["pp"]
    for rank, res in enumerate(results):  # every rank reports the same loss
        assert res["step"] == STEPS
        np.testing.assert_allclose(res["losses"], losses, rtol=2e-4, atol=2e-5,
                                   err_msg=f"rank {rank}")
        assert res["losses"] == results[0]["losses"]
    state = results[0]["state"]
    assert set(state["params"]) == set(params) == set(state["ema_params"])
    init = setup["ref"][1]
    # the second update moved the weights (the first has lr 0): not vacuous
    assert max(float(np.abs(state["params"][n].numpy() - init[n]).max()) for n in init) > 0
    for key, ref in (("params", params), ("ema_params", ema)):
        for n, want in ref.items():
            np.testing.assert_allclose(state[key][n].numpy(), want, rtol=5e-4, atol=5e-5,
                                       err_msg=f"{key} {n}")


@pytest.mark.parametrize("name", list(MESHES))
def test_pp_trainer_matches_unsharded_jax_trainer(setup, name):
    n_pp, dp, _ = MESHES[name]
    res = setup["ranks"][n_pp * dp][0][name]
    losses, params, _ = setup["ref"]
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-4)
    for n, want in params.items():
        np.testing.assert_allclose(res["state"]["params"][n].numpy(), want, rtol=5e-4,
                                   atol=5e-5, err_msg=n)


def test_pp_train_step_matches_unsharded_step(setup):
    rank0, rank1 = (r["train_step"] for r in setup["ranks"][2])
    (loss, params), (want_loss, want) = rank0["pp"], rank0["one"]
    assert loss == rank1["pp"][0]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert set(params) == set(want)
    # an AdamW step moves every weight by about lr = 1e-4: not vacuous
    init = setup["step_init"]
    assert min(float(np.abs(params[n] - init[n]).max()) for n in init) > 5e-5
    for n, w in want.items():
        np.testing.assert_allclose(params[n], w, atol=1e-5, rtol=1e-4, err_msg=n)

"""``train/step.py``: one ``make_train_step`` step against the JAX step (CPU).

Tiny config, the same converted parameters, the JAX step's own (t, eps)
draws injected. Tolerances as in ``tests/test_torch_train.py``: loss 1e-5
relative, parameters 1e-4 absolute (a tenth of one AdamW step at lr 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aether_tpu.config import DiTConfig as JaxDiTConfig
from aether_tpu.config import SchedulerConfig as JaxSchedulerConfig
from aether_tpu.models.dit import init_dit_params
from aether_tpu.train.step import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)
from aether_tpu.train.trainer import synthetic_batches as jax_synthetic_batches
from aether_tpu_torch.config import DiTConfig, SchedulerConfig
from aether_tpu_torch.io.from_jax import dit_state_dict_from_jax
from aether_tpu_torch.models.dit import DiT
from aether_tpu_torch.train.step import create_train_state, make_train_step
from aether_tpu_torch.train.trainer import batch_to_device

torch.set_num_threads(1)

PARAM_ATOL = 1e-4


def _jax_sd(tree):
    return dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                   DiTConfig.tiny())


def test_train_step_matches_jax_step():
    """``make_train_step`` over ``create_train_state`` (plain AdamW, no
    schedule): one step at the JAX step's own (t, eps) draws."""
    cfg = JaxDiTConfig.tiny()
    params = init_dit_params(jax.random.PRNGKey(1), cfg)
    batch = next(jax_synthetic_batches(cfg, batch_size=2, seed=8))
    key = jax.random.PRNGKey(5)
    state, tx = jax_create_train_state(params, learning_rate=1e-3)
    state, ref_loss = jax.jit(jax_make_train_step(cfg, JaxSchedulerConfig.aetherv1(), tx))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    key_t, key_eps = jax.random.split(key)
    t = torch.from_numpy(np.asarray(jax.random.randint(key_t, (2,), 0, 1000)).astype(np.int64))
    eps = torch.from_numpy(np.array(jax.random.normal(
        key_eps, batch["clean_latents"].shape, jnp.float32)))

    model = DiT(DiTConfig.tiny())
    init = _jax_sd(params)
    model.load_state_dict(init)
    ours = create_train_state(model, learning_rate=1e-3)
    loss = make_train_step(SchedulerConfig.aetherv1())(
        ours, batch_to_device(batch, "cpu"), t=t, eps=eps)
    assert ours.step == 1
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    params_now = model.state_dict()
    assert max(float((params_now[n] - init[n]).abs().max()) for n in init) > 1e-4
    for name, ref in _jax_sd(state.params).items():
        np.testing.assert_allclose(params_now[name].numpy(), ref.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)

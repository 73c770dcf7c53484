"""Config, RoPE and DPM schedule of the PyTorch port against the JAX package."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aether_tpu import config as jax_config
from aether_tpu.models.rope import (
    prepare_rotary_positional_embeddings as jax_rope,
)
from aether_tpu.schedule.dpm import dpm_step as jax_dpm_step
from aether_tpu.schedule.dpm import make_sampling_plan as jax_plan
from aether_tpu_torch import config as torch_config
from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings
from aether_tpu_torch.schedule.dpm import dpm_step, make_sampling_plan

torch.set_num_threads(1)

_PLAN_FIELDS = ("timesteps", "sqrt_alpha", "sqrt_one_minus_alpha", "mult1",
                "mult2", "mult3", "mult4", "mult_noise", "second_order")


@pytest.mark.parametrize("preset", ["aetherv1", "tiny"])
@pytest.mark.parametrize("name", ["DiTConfig", "VAEConfig", "PipelineConfig"])
def test_config_fields_match(name, preset):
    cls_j, cls_t = getattr(jax_config, name), getattr(torch_config, name)
    a, b = getattr(cls_j, preset)(), getattr(cls_t, preset)()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [f.name for f in dataclasses.fields(cls_j)] == \
        [f.name for f in dataclasses.fields(cls_t)]


def test_scheduler_config_fields_match():
    assert dataclasses.asdict(jax_config.SchedulerConfig.aetherv1()) == \
        dataclasses.asdict(torch_config.SchedulerConfig.aetherv1())


@pytest.mark.parametrize("steps", [4, 50])
def test_sampling_plan_matches(steps):
    j = jax_plan(jax_config.SchedulerConfig(), steps)
    t = make_sampling_plan(torch_config.SchedulerConfig(), steps)
    assert t.num_steps == j.num_steps == steps
    assert t.init_noise_sigma == j.init_noise_sigma
    for name in _PLAN_FIELDS:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the degenerate ends stay finite through the IEEE-inf arithmetic
    assert t.mult1[0] == 0.0 and t.mult2[-1] == -1.0 and t.mult_noise[-1] == 0.0


@pytest.mark.parametrize("steps", [4, 50])
def test_dpm_step_matches_with_injected_noise(steps):
    j_plan = jax_plan(jax_config.SchedulerConfig(), steps)
    t_plan = make_sampling_plan(torch_config.SchedulerConfig(), steps)
    rng = np.random.default_rng(11)
    shape = (1, 3, 56, 4, 6)
    x = rng.standard_normal(shape).astype(np.float32)
    old_j = jnp.zeros(shape, jnp.float32)
    old_t = torch.zeros(shape)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for i in range(steps):
        v = rng.standard_normal(shape).astype(np.float32)
        noise = rng.standard_normal(shape).astype(np.float32)
        xj, old_j = jax_dpm_step(j_plan, i, xj, jnp.asarray(v), old_j,
                                 jnp.asarray(noise))
        xt, old_t = dpm_step(t_plan, i, xt, torch.from_numpy(v), old_t,
                             torch.from_numpy(noise))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6,
                                   atol=1e-6, err_msg=f"step {i}")
        np.testing.assert_allclose(old_t.numpy(), np.asarray(old_j), rtol=1e-6,
                                   atol=1e-6, err_msg=f"x0 step {i}")


@pytest.mark.parametrize("preset,hw,f_lat,fps", [
    ("aetherv1", (480, 720), 11, 12),
    ("aetherv1", (480, 720), 5, 8),
    ("tiny", (64, 96), 5, 12),
])
def test_rope_tables_identical(preset, hw, f_lat, fps):
    cj = getattr(jax_config.DiTConfig, preset)()
    ct = getattr(torch_config.DiTConfig, preset)()
    a = jax_rope(cj, hw[0], hw[1], f_lat, fps=fps)
    b = prepare_rotary_positional_embeddings(ct, hw[0], hw[1], f_lat, fps=fps)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)

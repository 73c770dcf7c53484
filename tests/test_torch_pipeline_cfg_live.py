"""Prediction and planning of the PyTorch port against the live JAX pipeline
(CPU, tiny config; the inputs, steps and injected draws of
``test_torch_pipeline_cfg.py``).

- ``xla`` attention on the JAX side, the port's default (fused, float
  operands under the tests' QK8=0) on its own: 5e-3, as reconstruction's
  test (measured 6.9e-5).
- ``AETHER_ATTN_FUSED=0`` and QK8=1: both sides run the unfused fixed-max
  attention with int8 q/k (the Pallas K3 interpreted; the port's K3 plain
  version) at 2e-2, the bar of reconstruction's int8 run (measured 2.0e-3:
  codes that land on a rounding boundary differ by one, and 2 CFG steps
  carry it through the decode).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aether_tpu.pipeline import AetherPipeline as JaxPipeline
from test_torch_pipeline import setup  # noqa: F401  (fixture)
from test_torch_pipeline_cfg import SEED, _inputs, _max_diffs, _run_port

torch.set_num_threads(1)


def _run_jax(setup, task, attn_impl):
    jcfg, dit_tree, vae_tree, text, _, golden = setup
    if attn_impl != "xla":
        # the DiT reads AETHER_ATTN_FUSED when it is traced: no trace made
        # under another setting may be reused
        jax.clear_caches()
    pipe = JaxPipeline(jcfg, jax.tree_util.tree_map(jnp.asarray, dit_tree),
                       jax.tree_util.tree_map(jnp.asarray, vae_tree), text,
                       attn_impl=attn_impl, compute_dtype=jnp.float32)
    return pipe(task=task, seed=SEED, **_inputs(golden, task))


@pytest.mark.parametrize("task", ["prediction", "planning"])
@pytest.mark.parametrize("fused,qk8,attn_impl,atol", [
    ("1", "0", "xla", 5e-3),
    ("0", "1", "flash_interpret", 2e-2),
])
def test_task_matches_live_jax(setup, monkeypatch, task, fused, qk8, attn_impl, atol):
    *_, port, golden = setup
    monkeypatch.setenv("AETHER_ATTN_FUSED", fused)
    monkeypatch.setenv("AETHER_ATTN_QK8", qk8)
    ref = _run_jax(setup, task, attn_impl)
    out = _run_port(port, golden, task)
    diffs = _max_diffs(out, {n: getattr(ref, n) for n in ("rgb", "disparity", "raymap")})
    assert max(diffs.values()) < atol, diffs

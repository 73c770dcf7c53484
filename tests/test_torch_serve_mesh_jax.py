"""The port's server over a mesh of two gloo ranks against the JAX
``JobRunner`` on the conftest's CPU mesh at the same dp / tp (CPU, tiny
config, f32, float attention on both sides).

This file holds dp = 2; ``test_torch_serve_mesh_jax_tp.py`` runs the same
checks at tp = 2 (one mesh a file keeps each under a minute).

The ranks (``torch_serve_ranks.serve_rank``, rank 0 serving HTTP) and the
JAX runner get the same weights and the JAX key streams' draws (each rank
draws them with ``JaxKeyNoise``). A two-window reconstruction job and
a prediction job without the post-reconstruction (which
``test_torch_serve_mesh.py`` holds to one process; leaving it out here
spares the JAX runner a compile per mesh) export rgb and disparity and save
poses within 5e-3 of the JAX runner's, the bar of
``test_torch_serve_parity.py``. Two JAX runners (a job each) work side by
side on their worker threads while the ranks serve.
"""

import os

import numpy as np
import pytest
import torch

from torch_serve_ranks import (
    SavedOutputs,
    jobs,
    params_of,
    poses_of,
    start_ranks,
    wait_runner,
)

torch.set_num_threads(1)

RECON, _, PRED = jobs()  # the prediction without its post-reconstruction
AXES = {"dp2": dict(dp=2, tp=1)}


def _jax_runner(trees, axes, output_dir, job):
    """A JAX ``JobRunner`` over the JAX pipeline on the conftest's CPU mesh,
    ``job`` submitted (its worker thread runs it, so the runners of both
    meshes and both jobs compile side by side): (runner, job id)."""
    import jax
    import jax.numpy as jnp

    from aether_tpu.apps import serve as jax_serve
    from aether_tpu.parallel.mesh import make_mesh
    from aether_tpu.pipeline import AetherPipeline as JaxPipeline

    jcfg, dit_tree, vae_tree, text = trees
    pipe = JaxPipeline(jcfg, jax.tree_util.tree_map(jnp.asarray, dit_tree),
                       jax.tree_util.tree_map(jnp.asarray, vae_tree), text,
                       attn_impl="xla", compute_dtype=jnp.float32,
                       mesh=make_mesh(**axes, devices=jax.devices()[:2]))
    runner = jax_serve.JobRunner(pipe, str(output_dir))
    return runner, runner.submit(params_of(job))


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """The module's mesh (``AXES``): its ranks serving while the JAX runners
    work."""
    axes_by_name = request.module.AXES
    from test_torch_batch_reconstruct import tiny_pipelines

    from aether_tpu.apps import demo as jax_demo

    *trees, port = tiny_pipelines()
    ranks = {name: start_ranks(port, None, axes, [RECON, PRED], tmp_path_factory.mktemp(name))
             for name, axes in axes_by_name.items()}
    saved = SavedOutputs(jax_demo, install=False)
    jax_runs = {}
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setattr(jax_demo, "save_output", saved)
        runners = {name: [_jax_runner(trees, axes, tmp_path_factory.mktemp(f"jax_{name}"), job)
                          for job in (RECON, PRED)] for name, axes in axes_by_name.items()}
        for name, pair in runners.items():
            statuses = [wait_runner(runner, job_id) for runner, job_id in pair]
            assert all(s["status"] == "done" for s in statuses), statuses
            jax_runs[name] = dict(poses=[poses_of(runner.output_dir, st)
                                         for (runner, _), st in zip(pair, statuses)])
    # each export's arrays, by the job directory save_output wrote into
    by_dir = dict(zip(saved.dirs, saved.calls))
    for name, pair in runners.items():
        jax_runs[name]["saved"] = [by_dir[os.path.join(runner.output_dir, job_id)]
                                   for runner, job_id in pair]
    return {name: (r.join(timeout=240)[0], jax_runs[name]) for name, r in ranks.items()}


def test_mesh_jobs_match_the_jax_job_runner(runs):
    (name, (leader, jax_run)), = runs.items()
    assert leader["client_error"] is None, leader["client_error"]
    assert [s["status"] for s in leader["statuses"]] == ["done", "done"]
    for i, what in enumerate(("reconstruction", "prediction")):
        for got, want, field in zip(leader["saved"][i], jax_run["saved"][i], ("rgb", "disp")):
            assert got.shape == want.shape, (what, field)
            np.testing.assert_allclose(got, want, atol=5e-3, err_msg=f"{name} {what} {field}")
        np.testing.assert_allclose(leader["poses"][i], jax_run["poses"][i], atol=5e-3,
                                   err_msg=f"{name} {what} poses")

"""The port's server jobs against the JAX ``JobRunner`` (CPU, tiny config).

Both runners get the same weights (the tiny JAX trees converted through
``io/from_jax.py``) and the JAX pipeline's draws: the port's pipeline is
wrapped so that each call passes ``noise=JaxKeyNoise(seed)``. A
reconstruction job and a prediction job then export the same rgb and
disparity and save the same poses, at the bar of
``tests/test_torch_pipeline.py::test_reconstruction_matches_live_jax`` at
QK8=0 / xla: 5e-3.
"""

import time

import numpy as np
import torch

from aether_tpu_torch.apps import serve

torch.set_num_threads(1)

class JaxDrawsPipeline:
    """The port's pipeline with the JAX pipeline's draws: every call passes
    ``noise=JaxKeyNoise(seed)``, so that a job sees the JAX job's noise."""

    def __init__(self, pipe):
        self.pipe, self.config, self.device = pipe, pipe.config, pipe.device

    def __call__(self, **kw):
        from test_torch_pipeline import JaxKeyNoise

        return self.pipe(noise=JaxKeyNoise(kw["seed"]), **kw)


class SavedOutputs:
    """Wraps a demo module's ``save_output``: records the rgb and disparity
    a job exports and returns what the original writes."""

    def __init__(self, module, monkeypatch):
        self.original, self.calls = module.save_output, []
        monkeypatch.setattr(module, "save_output", self)

    def __call__(self, rgb, disparity, args, **kw):
        self.calls.append((np.array(rgb), np.array(disparity)))
        return self.original(rgb, disparity, args, **kw)


def _run_job(runner, params):
    job = runner.submit(dict(params))
    for _ in range(3000):
        status = runner.status(job)
        if status["status"] in ("done", "error"):
            break
        time.sleep(0.1)
    assert status["status"] == "done", status.get("error")
    poses = next(a for a in status["artifacts"] if a.endswith("_poses.txt"))
    return np.loadtxt(f"{runner.output_dir}/{poses[len('/outputs/'):]}")


def test_jobs_match_the_jax_job_runner(tmp_path, monkeypatch):
    """One reconstruction job (two windows) and one prediction job (CFG, a
    generated raymap, the post-reconstruction) on the same weights and draws
    as the JAX ``JobRunner``: the exported rgb and disparity and the saved
    poses agree at 5e-3, the bar of ``test_reconstruction_matches_live_jax``
    at QK8=0 / xla."""
    from test_torch_batch_reconstruct import jax_pipeline, tiny_pipelines
    from test_torch_serve import gif_bytes, png_bytes

    from aether_tpu.apps import demo as jax_demo
    from aether_tpu.apps import serve as jax_serve
    from aether_tpu_torch.apps import demo

    jcfg, dit_tree, vae_tree, text, port = tiny_pipelines()
    jax_runner = jax_serve.JobRunner(jax_pipeline(jcfg, dit_tree, vae_tree, text),
                                     str(tmp_path / "jax"))
    runner = serve.JobRunner(JaxDrawsPipeline(port), str(tmp_path / "port"))
    saved_jax = SavedOutputs(jax_demo, monkeypatch)
    saved = SavedOutputs(demo, monkeypatch)
    jobs = [
        {"task": "reconstruction", "num_frames": "17", "stride": "8", "steps": "2",
         "height": "64", "width": "96", "seed": "11"},
        {"task": "prediction", "num_frames": "17", "steps": "2", "height": "64",
         "width": "96", "raymap": "forward_right", "seed": "12"},
    ]
    uploads = {"video": {"filename": "v.gif", "data": gif_bytes(25)},
               "image": {"filename": "i.png", "data": png_bytes(9)}}
    for fields in jobs:
        fields = dict(fields, **uploads)
        if fields["task"] == "reconstruction":
            fields.pop("image")
        else:
            fields.pop("video")
        want = _run_job(jax_runner, jax_serve._fields_to_params(fields, None))
        got = _run_job(runner, serve._fields_to_params(fields, None))
        (rgb_ref, disp_ref), (rgb, disp) = saved_jax.calls[-1], saved.calls[-1]
        assert rgb.shape == rgb_ref.shape and disp.shape == disp_ref.shape
        diffs = {"rgb": np.abs(rgb - rgb_ref).max(), "disparity": np.abs(disp - disp_ref).max(),
                 "poses": np.abs(got - want).max()}
        assert max(diffs.values()) < 5e-3, (fields["task"], diffs)

"""The deferred drivers over the port's pipeline (CPU, tiny config, f32).

The window driver (``pipeline/windowing.py``) and both eval drivers
(``eval/video_depth.py``, ``eval/rel_pose.py``) dispatch through
``defer_host`` (and ``iter_resolved``), serially and batched. Each is held
bit for bit to its run over the undeferred pipeline (every call resolved
before it returns), counts its deferred dispatches, and its batched run is
held to the JAX driver's at 5e-3 (``test_torch_windowing.py``'s and
``test_torch_eval_e2e.py``'s bar), the JAX key streams injected.
"""

import numpy as np
import pytest
import torch

import aether_tpu_torch.pipeline.aether as port_aether

torch.set_num_threads(1)

F, H, W = 17, 64, 96
ATOL = 5e-3
FIELDS = ("rgb", "disparity", "raymap")


@pytest.fixture(scope="module")
def setup():
    from test_torch_batch_reconstruct import jax_pipeline, tiny_pipelines

    jcfg, dit_tree, vae_tree, text, port = tiny_pipelines()
    return port, jax_pipeline(jcfg, dit_tree, vae_tree, text)


class Undeferred:
    """The port's pipeline, JAX draws injected, every call resolved before it
    returns (``defer_host`` dropped): the drivers' undeferred runs.
    ``dp`` > 1 gives it a mesh stand-in with that dp, so that the
    relative-pose driver batches (the pipeline itself runs unsharded)."""

    def __init__(self, pipe, defer: bool = False, dp: int = 1):
        self.pipe, self.config, self.device, self.defer = pipe, pipe.config, pipe.device, defer
        self.mesh = _FakeMesh(dp) if dp > 1 else None
        self.deferred = 0

    def _run(self, fn, kw):
        from test_torch_pipeline import JaxKeyNoise

        asked = kw.pop("defer_host", False)
        self.deferred += bool(asked and self.defer)
        out = fn(**kw, noise=JaxKeyNoise(kw["seed"]), defer_host=asked and self.defer)
        if asked and not self.defer:  # resolved before it returns
            return port_aether.DeferredOutput(lambda: out)
        return out

    def __call__(self, **kw):
        return self._run(self.pipe, kw)

    def batch_reconstruct(self, videos, **kw):
        return self._run(lambda **k: self.pipe.batch_reconstruct(videos, **k), kw)


class _FakeMesh:
    """What ``axis_size`` reads of a ('dp', 'tp') mesh, and what the JAX
    drivers read (``mesh.shape``)."""

    def __init__(self, dp):
        self.mesh_dim_names, self._dims = ("dp", "tp"), (dp, 1)
        self.shape = {"dp": dp, "tp": 1}

    def size(self, i):
        return self._dims[i]


class JaxWithMesh:
    """The JAX pipeline seen through a dp mesh stand-in (the rel-pose
    driver's batched branch), its calls unsharded."""

    def __init__(self, pipe, dp):
        self.pipe, self.config, self.mesh = pipe, pipe.config, _FakeMesh(dp)

    def __call__(self, **kw):
        return self.pipe(**kw)

    def batch_reconstruct(self, videos, **kw):
        return self.pipe.batch_reconstruct(videos, **kw)


def _same(a, b, what):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=f"{what} {name}")


def test_deferred_window_driver(setup):
    from aether_tpu.pipeline import windowing as jw
    from aether_tpu_torch.pipeline import windowing as tw

    port, jax_pipe = setup
    clip = np.random.default_rng(5).integers(0, 256, (25, H, W, 3), dtype=np.uint8)
    kw = dict(height=H, width=W, num_frames=F, stride=8, num_inference_steps=1, seed=77)
    for batch_windows in (1, 2):
        deferred = Undeferred(port, defer=True)
        got, starts, n = tw.run_windowed_reconstruction(deferred, clip,
                                                        batch_windows=batch_windows, **kw)
        ref, _, _ = tw.run_windowed_reconstruction(Undeferred(port), clip,
                                                   batch_windows=batch_windows, **kw)
        assert deferred.deferred == (2 if batch_windows == 1 else 1)
        assert (starts, n) == ([0, 8], F) and len(got) == len(ref) == 2
        for i in range(2):
            _same(got[i], ref[i], f"batch_windows={batch_windows} window {i}")
    jref, _, _ = jw.run_windowed_reconstruction(jax_pipe, clip, batch_windows=2, **kw)
    for i in range(2):
        for name in FIELDS:
            np.testing.assert_allclose(getattr(got[i], name), getattr(jref[i], name),
                                       atol=ATOL, err_msg=f"window {i} {name}")


def test_deferred_video_depth_driver(setup):
    from aether_tpu.eval.video_depth import process_with_sliding_window as jax_driver
    from aether_tpu_torch.eval.video_depth import process_with_sliding_window

    port, jax_pipe = setup
    clip = np.random.default_rng(6).uniform(0, 1, (F, H, 128, 3))  # one window x two tiles
    kw = dict(num_inference_steps=1, seed=3, window_frames=F, temporal_stride=8,
              tile=(H, W), spatial_overlap=(8, 12))
    for batch_calls in (1, 2):
        deferred = Undeferred(port, defer=True)
        got = process_with_sliding_window(deferred, clip, batch_calls=batch_calls, **kw)
        ref = process_with_sliding_window(Undeferred(port), clip, batch_calls=batch_calls, **kw)
        assert deferred.deferred == (2 if batch_calls == 1 else 1)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    want = jax_driver(jax_pipe, clip, batch_calls=2, **kw)
    for a, b in zip(got, want):
        assert np.abs(a - b).max() < ATOL


def test_deferred_rel_pose_driver(setup):
    from aether_tpu.eval.rel_pose import process_video_with_sliding_window as jax_driver
    from aether_tpu_torch.eval.rel_pose import process_video_with_sliding_window

    port, jax_pipe = setup
    clip = np.random.default_rng(7).uniform(0, 1, (33, H, W, 3))
    kw = dict(num_inference_steps=1, seed=5, window_frames=F, temporal_stride=16)
    for dp in (1, 2):
        deferred = Undeferred(port, defer=True, dp=dp)
        got = process_video_with_sliding_window(deferred, clip, **kw)
        ref = process_video_with_sliding_window(Undeferred(port, dp=dp), clip, **kw)
        assert deferred.deferred == (2 if dp == 1 else 1)
        for key in ("poses", "focals", "rgb", "disparity"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=f"dp={dp} {key}")
    want = jax_driver(JaxWithMesh(jax_pipe, 2), clip, **kw)
    for key in ("disparity", "rgb"):
        assert np.abs(np.asarray(got[key]) - np.asarray(want[key])).max() < ATOL, key

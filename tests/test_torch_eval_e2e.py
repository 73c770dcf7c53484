"""Both evaluation drivers end to end over the real tiny pipelines (CPU).

The port's pipeline and the JAX one on the same weights (the tiny JAX trees
converted through ``io/from_jax.py``), the port's with the JAX draws
(``JaxKeyNoise`` on every call), through each driver's JAX and port
versions: the outputs agree at 5e-3, the bar of
``tests/test_torch_pipeline.py::test_reconstruction_matches_live_jax`` at
QK8=0 / xla.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ATOL = 5e-3


@pytest.fixture(scope="module")
def pipelines():
    from test_torch_batch_reconstruct import jax_pipeline, tiny_pipelines
    from test_torch_serve_parity import JaxDrawsPipeline

    jcfg, dit_tree, vae_tree, text, port = tiny_pipelines()
    return jax_pipeline(jcfg, dit_tree, vae_tree, text), JaxDrawsPipeline(port)


class Counted:
    """Counts a pipeline's calls."""

    def __init__(self, pipe):
        self.pipe, self.calls = pipe, 0

    def __call__(self, **kw):
        self.calls += 1
        return self.pipe(**kw)


def test_video_depth_matches_jax(pipelines):
    """25 frames x 64 x 128: two temporal windows (starts 0 and 8) x two
    horizontal 64x96 tiles, so both feathers and both scale alignments run."""
    from aether_tpu.eval.video_depth import process_with_sliding_window as jax_driver
    from aether_tpu_torch.eval.video_depth import process_with_sliding_window

    jax_pipe, port = pipelines
    video = np.random.default_rng(6).uniform(0, 1, (25, 64, 128, 3))
    kw = dict(num_inference_steps=2, seed=3, window_frames=17, temporal_stride=8,
              tile=(64, 96), spatial_overlap=(8, 12))
    counted = Counted(port)
    rgb, disp = process_with_sliding_window(counted, video, **kw)
    rgb_ref, disp_ref = jax_driver(jax_pipe, video, **kw)
    assert counted.calls == 4
    assert rgb.shape == (25, 64, 128, 3) and disp.shape == (25, 64, 128)
    assert np.isfinite(disp).all() and rgb.min() >= 0.0 and rgb.max() <= 1.0
    diffs = {"rgb": np.abs(rgb - rgb_ref).max(), "disparity": np.abs(disp - disp_ref).max()}
    assert max(diffs.values()) < ATOL, diffs


def test_rel_pose_matches_jax(pipelines):
    """25 frames x 64 x 96 in two windows (starts 0 and 8): per-window Kalman
    smoothing, the pose alignment and the blend."""
    from aether_tpu.eval.rel_pose import process_video_with_sliding_window as jax_driver
    from aether_tpu_torch.eval.rel_pose import process_video_with_sliding_window

    jax_pipe, port = pipelines
    video = np.random.default_rng(7).uniform(0, 1, (25, 64, 96, 3))
    kw = dict(num_inference_steps=2, seed=5, window_frames=17, temporal_stride=8)
    counted = Counted(port)
    got = process_video_with_sliding_window(counted, video, **kw)
    ref = jax_driver(jax_pipe, video, **kw)
    assert counted.calls == 2 and got["poses"].shape == (25, 4, 4)
    rot = got["poses"][:, :3, :3]
    assert np.abs(np.einsum("tij,tik->tjk", rot, rot) - np.eye(3)).max() < 1e-6
    diffs = {k: np.abs(np.asarray(got[k]) - np.asarray(ref[k])).max()
             for k in ("rgb", "disparity", "poses")}
    diffs["focals"] = np.abs(got["focals"] / ref["focals"] - 1.0).max()
    assert max(diffs.values()) < ATOL, diffs

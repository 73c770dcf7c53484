"""The port's sliding-window driver and blend (``pipeline/windowing.py``)
against the JAX package's (CPU).

- Window starts and ``fit_num_frames``: equal.
- The blend on seeded windows against JAX ``blend_and_merge_window_results``:
  the host blending is the same float64 numpy on both sides and the torch
  geometry agrees with JAX to f32 rounding, so rgb, disparity and poses agree
  within 1e-5 and pointmaps within 1e-4 (values up to ~1e1).
- The blend against ``tests/fixtures/blend_oracle.npz`` (the serial
  per-frame oracle), with the bars ``tests/test_pipeline.py`` uses.
- ``run_windowed_reconstruction`` on the tiny torch pipeline against the JAX
  driver on the same weights, with the JAX key streams injected: windows
  within 5e-3, as ``tests/test_torch_pipeline.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

import aether_tpu.pipeline.windowing as jw
import aether_tpu_torch.pipeline.windowing as tw
from aether_tpu.geometry import camera_pose_to_raymap, get_intrinsics

torch.set_num_threads(1)

_FIX = pathlib.Path(__file__).parent / "fixtures" / "blend_oracle.npz"


class Window:
    def __init__(self, rgb, disparity, raymap):
        self.rgb, self.disparity, self.raymap = rgb, disparity, raymap


@pytest.mark.parametrize("total,size,stride", [
    (41, 41, 24), (30, 41, 24), (65, 41, 24), (90, 41, 24), (60, 17, 8), (100, 33, 10)])
def test_window_starts_match_jax(total, size, stride):
    assert tw.get_window_starts(total, size, stride) == jw.get_window_starts(total, size,
                                                                             stride)


@pytest.mark.parametrize("total,requested", [(65, 41), (30, 41), (20, 41), (41, 25)])
def test_fit_num_frames_matches_jax(total, requested):
    assert tw.fit_num_frames(total, requested) == jw.fit_num_frames(total, requested)


def test_fit_num_frames_rejects_short_videos():
    with pytest.raises(ValueError, match="video too short"):
        tw.fit_num_frames(10, 41)


def test_stitching_matches_jax(rng):
    prev, curr = rng.normal(size=(20, 3, 4)), rng.normal(size=(17, 3, 4))
    np.testing.assert_array_equal(tw.stitch_overlap(prev, curr, 6),
                                  jw.stitch_overlap(prev, curr, 6))
    poses = np.tile(np.eye(4), (2, 9, 1, 1))
    poses[:, :, :3, 3] = rng.normal(size=(2, 9, 3))
    np.testing.assert_array_equal(tw.stitch_poses(poses[0], poses[1], 4),
                                  jw.stitch_poses(poses[0], poses[1], 4))


def _seeded_windows(rng, starts, frames=17, h=32, w=48):
    """Windows along one smooth trajectory, each with its own scale and
    noise, as a window's outputs look after the pipeline."""
    total = starts[-1] + frames
    t = np.linspace(0, 1, total)
    poses = np.tile(np.eye(4), (total, 1, 1))
    angle = 0.4 * t
    poses[:, 0, 0] = poses[:, 2, 2] = np.cos(angle)
    poses[:, 0, 2], poses[:, 2, 0] = np.sin(angle), -np.sin(angle)
    poses[:, :3, 3] = np.stack([t, 0.2 * t, 0.5 * t], 1)
    windows = []
    for i, s in enumerate(starts):
        k, _ = get_intrinsics(frames, h, w, focal=40.0 + 2 * i)
        raymap = np.asarray(camera_pose_to_raymap(poses[s:s + frames], np.asarray(k),
                                                  height=h, width=w))
        raymap = raymap + rng.normal(size=raymap.shape).astype(np.float32) * 1e-3
        disparity = rng.uniform(0.2, 1.0, (frames, h, w)).astype(np.float32) * (1 + 0.1 * i)
        rgb = rng.uniform(0, 1, (frames, h, w, 3)).astype(np.float32)
        windows.append(Window(rgb, disparity, raymap))
    return windows


@pytest.mark.parametrize("smooth,method,align", [
    (False, "kalman", False), (True, "kalman", False), (True, "simple", True),
    (False, "kalman", True)])
def test_blend_matches_jax(rng, smooth, method, align):
    starts = [0, 8, 16]
    windows = _seeded_windows(rng, starts)
    kw = dict(smooth_camera=smooth, smooth_method=method, align_pointmaps=align)
    got = tw.blend_and_merge_window_results(windows, starts, 32, 48, **kw)
    ref = jw.blend_and_merge_window_results(windows, starts, 32, 48, **kw)
    total = starts[-1] + 17
    for name, a, b, tol in zip(("rgb", "disparity", "poses", "pointmaps"), got, ref,
                               (1e-5, 1e-5, 1e-5, 1e-4)):
        assert a.shape == np.asarray(b).shape and a.shape[0] == total, name
        np.testing.assert_allclose(a, np.asarray(b), atol=tol, err_msg=name)


def test_blend_matches_serial_oracle():
    g = np.load(_FIX)
    starts = [int(s) for s in g["starts"]]
    results = [Window(g[f"in_rgb_{i}"], g[f"in_disp_{i}"], g[f"in_raymap_{i}"])
               for i in range(len(starts))]
    _, h, w = results[0].disparity.shape
    rgb, disp, poses, pms = tw.blend_and_merge_window_results(
        results, starts, h, w, smooth_camera=False, align_pointmaps=False)
    np.testing.assert_allclose(rgb, g["rgb"], atol=1e-6)
    np.testing.assert_allclose(disp, g["disparity"], atol=1e-6)
    np.testing.assert_allclose(poses, g["poses"], atol=1e-6)
    np.testing.assert_allclose(pms, g["pointmaps"], atol=1e-4)
    rgb, disp, poses, pms = tw.blend_and_merge_window_results(
        results, starts, h, w, smooth_camera=False, align_pointmaps=True)
    np.testing.assert_allclose(rgb, g["pm_rgb"], atol=1e-6)
    np.testing.assert_allclose(poses, g["pm_poses"], atol=1e-6)
    np.testing.assert_allclose(pms, g["pm_pointmaps"], atol=1e-4)


class InjectedJaxNoise:
    """The port's pipeline with the JAX key streams of each call's seed
    injected (the JAX driver seeds every window alike)."""

    def __init__(self, port):
        self.port, self.config = port, port.config
        self.calls = 0

    def __call__(self, **kw):
        from test_torch_pipeline import JaxKeyNoise

        self.calls += 1
        return self.port(noise=JaxKeyNoise(kw["seed"]), **kw)

    def batch_reconstruct(self, videos, **kw):
        from test_torch_pipeline import JaxKeyNoise

        self.calls += 1
        return self.port.batch_reconstruct(videos, noise=JaxKeyNoise(kw["seed"]), **kw)


@pytest.fixture(scope="module")
def pipelines():
    from test_torch_batch_reconstruct import jax_pipeline, tiny_pipelines

    *trees, port = tiny_pipelines()
    return jax_pipeline(*trees), port


def test_windowed_reconstruction_matches_jax(pipelines):
    jax_pipe, port = pipelines
    video = np.random.default_rng(5).integers(0, 256, (25, 64, 96, 3), dtype=np.uint8)
    kw = dict(height=64, width=96, num_frames=17, stride=8, num_inference_steps=2,
              seed=77)
    ref, ref_starts, ref_n = jw.run_windowed_reconstruction(jax_pipe, video, **kw)
    seen = []
    injected = InjectedJaxNoise(port)
    for batch_windows in (1, 2):
        got, starts, n = tw.run_windowed_reconstruction(
            injected, video, batch_windows=batch_windows,
            progress=lambda done, total: seen.append((done, total)), **kw)
        assert (starts, n) == (ref_starts, ref_n) == ([0, 8], 17)
        assert len(got) == len(ref) == 2
        for i in range(2):
            for name in ("rgb", "disparity", "raymap"):
                np.testing.assert_allclose(
                    getattr(got[i], name), getattr(ref[i], name), atol=5e-3,
                    err_msg=f"batch_windows={batch_windows} window {i} {name}")
    assert injected.calls == 3  # two serial windows, then one batch of two
    assert seen == [(0, 2), (1, 2), (0, 2)]
    rgb, disparity, poses, pointmaps = tw.blend_and_merge_window_results(
        got, starts, 64, 96)
    assert rgb.shape == (25, 64, 96, 3) and disparity.shape == (25, 64, 96)
    assert poses.shape == (25, 4, 4) and pointmaps.shape == (25, 64, 96, 3)
    assert all(np.isfinite(a).all() for a in (rgb, disparity, poses, pointmaps))

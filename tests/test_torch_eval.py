"""The port's evaluation harness against ``aether_tpu.eval`` (CPU).

- Metrics: ``depth_evaluation`` in every alignment mode against the
  reference goldens (``tests/fixtures/depth_metric_goldens.json``, at
  ``tests/test_reference_metric_parity.py``'s tolerances) and against the
  JAX function on the same inputs; LAD2's ``torch.optim.Adam`` loop against
  the JAX ``_lad2_device`` (optax); the pose metrics against
  ``tests/fixtures/pose_metric_goldens.npz`` and the JAX module.
- Drivers: both drivers, JAX and port, over the same deterministic fake
  pipeline (each side's own raymap codec): tiling, feathering, scale
  alignment, blending, the TUM export and the batched route against the
  serial one.
- CLI: each ``main`` over a synthetic Sintel-layout dataset with
  ``--device cpu --random-init tiny``: the error log of a failing sequence,
  the scores, and ``--resume``.

The end-to-end runs over the real tiny pipelines are in
``tests/test_torch_eval_e2e.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from aether_tpu.eval import depth_metrics as jax_depth_metrics
from aether_tpu.eval import pose_metrics as jax_pose_metrics
from aether_tpu_torch.eval import depth_metrics, pose_metrics
from aether_tpu_torch.eval.depth_metrics import depth_evaluation

torch.set_num_threads(1)

CASES = ["align_median", "align_lstsq", "align_lad", "align_lad2", "align_scale",
         "align_metric", "median_custom_mask", "lstsq_clips", "median_no_max_depth",
         "scale_disp_input"]
# LAD2: Adam in f32 stops after a data-dependent number of steps, so the two
# f32 loops (torch, optax) and the reference's f64 one agree to the
# optimizer's noise, not to rounding (the goldens' own bar for it is 1e-3)
LAD2_TOL = 1e-3


@pytest.fixture(scope="module")
def metric_cases():
    from test_reference_metric_parity import FIXTURE, _make_cases

    return _make_cases(), json.loads(FIXTURE.read_text())


@pytest.mark.parametrize("name", CASES)
def test_depth_metrics_match_reference_goldens(metric_cases, name):
    cases, goldens = metric_cases
    pred, gt, align, kwargs = cases[name]
    golden = goldens["cases"][name]
    results, parity, aligned, gt_masked = depth_evaluation(pred.copy(), gt.copy(),
                                                           align=align, **kwargs)
    tol = {"lad2": LAD2_TOL, "scale": 1e-4}.get(align, 1e-5)
    for key, want in golden["metrics"].items():
        assert results[key] == pytest.approx(want, rel=tol, abs=tol), key
    assert float(parity.sum()) == pytest.approx(golden["parity_sum"], rel=tol, abs=tol)
    assert float(gt_masked.sum()) == pytest.approx(golden["gt_masked_sum"], rel=1e-6)
    assert float(aligned.mean()) == pytest.approx(golden["aligned_mean"], rel=tol, abs=tol)


@pytest.mark.parametrize("name", CASES)
def test_depth_metrics_match_jax(metric_cases, name):
    """The same numpy code but LAD2: every other mode agrees exactly."""
    pred, gt, align, kwargs = metric_cases[0][name]
    got = depth_evaluation(pred.copy(), gt.copy(), align=align, **kwargs)
    ref = jax_depth_metrics.depth_evaluation(pred.copy(), gt.copy(), align=align, **kwargs)
    if align == "lad2":
        for key, want in ref[0].items():
            assert got[0][key] == pytest.approx(want, rel=LAD2_TOL, abs=LAD2_TOL), key
        np.testing.assert_allclose(got[2], ref[2], rtol=LAD2_TOL, atol=LAD2_TOL)
        return
    assert got[0] == ref[0]
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("lr,max_iters", [(1e-4, 1000), (1e-2, 300), (5e-2, 50)])
def test_lad2_matches_jax_adam(lr, max_iters):
    """LAD2 from the same start with the same Adam constants and stopping
    rule: (s, t) within 1e-3 relative of the optax loop's."""
    import jax.numpy as jnp

    rng = np.random.default_rng(int(lr * 1e4))
    gt = rng.uniform(1.0, 20.0, 4000)
    pred = 0.6 * gt + 0.8 + rng.normal(0.0, 0.3, gt.size)
    s_init = float(np.median(gt) / np.median(pred))
    s, t = depth_metrics._lad2_device(torch.tensor(pred, dtype=torch.float32),
                                      torch.tensor(gt, dtype=torch.float32), s_init,
                                      lr=lr, max_iters=max_iters)
    s_ref, t_ref = jax_depth_metrics._lad2_device(
        jnp.asarray(pred, jnp.float32), jnp.asarray(gt, jnp.float32), s_init, lr=lr,
        max_iters=max_iters)
    assert s != s_init  # it moved
    assert s == pytest.approx(float(s_ref), rel=1e-3)
    assert t == pytest.approx(float(t_ref), rel=1e-3, abs=1e-3)


def test_lad2_runs_under_no_grad():
    gt = np.linspace(1.0, 5.0, 200)
    with torch.no_grad():
        metrics, *_ = depth_evaluation(0.5 * gt + 0.1, gt, align="lad2", max_iters=20,
                                       lr=1e-2, device="cpu")
    assert np.isfinite(metrics["Abs Rel"])


@pytest.mark.parametrize("name", ["similarity", "noisy", "scale_trap"])
def test_pose_metrics_match_goldens_and_jax(name, tmp_path):
    from test_reference_metric_parity import _pose_goldens

    g = _pose_goldens()
    est, ref = g[f"{name}_est"], g[f"{name}_ref"]
    got = pose_metrics.eval_metrics(pose_metrics.poses_to_traj(est),
                                    pose_metrics.poses_to_traj(ref), seq=name,
                                    filename=str(tmp_path / "port.txt"))
    np.testing.assert_allclose(got, g[f"{name}_metrics"], rtol=1e-8, atol=1e-10)
    want = jax_pose_metrics.eval_metrics(jax_pose_metrics.poses_to_traj(est),
                                         jax_pose_metrics.poses_to_traj(ref), seq=name,
                                         filename=str(tmp_path / "jax.txt"))
    assert tuple(got) == tuple(want)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


def test_dataset_readers_match_jax(tmp_path):
    from aether_tpu.eval import datasets as jax_datasets
    from aether_tpu_torch.eval import datasets

    assert set(datasets.VIDEO_DEPTH_DATASETS) == set(jax_datasets.VIDEO_DEPTH_DATASETS)
    assert set(datasets.REL_POSE_DATASETS) == set(jax_datasets.REL_POSE_DATASETS)
    cams = _write_sintel_cams(tmp_path / "cams", 5)
    for a, b in zip(datasets.load_traj(cams, "sintel"), jax_datasets.load_traj(cams, "sintel")):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the drivers over one deterministic fake pipeline
# ---------------------------------------------------------------------------


class FakePipeline:
    """``tests/test_eval.py::_FakePipeline`` for either package: rgb = the
    input, disparity = 0.5 plus a hundredth of each frame's mean red (so
    that the overlaps' scale alignment has something to fit), the raymap of a
    slightly translating identity camera through the package's own codec."""

    def __init__(self, port: bool):
        self.port, self.calls, self.batches = port, 0, 0

    def __call__(self, task, video, height, width, num_frames, **kwargs):
        if self.port:
            from aether_tpu_torch.geometry.raymap import camera_pose_to_raymap
            from aether_tpu_torch.pipeline.aether import AetherPipelineOutput
        else:
            from aether_tpu.geometry.raymap import camera_pose_to_raymap
            from aether_tpu.pipeline.aether import AetherPipelineOutput

        self.calls += 1
        video = np.asarray(video)
        t = video.shape[0]
        poses = np.broadcast_to(np.eye(4), (t, 4, 4)).copy()
        poses[:, 0, 3] = np.arange(t) * 0.1
        focal = 0.8 * width
        intrinsic = np.broadcast_to(np.array([[focal, 0, width / 2], [0, focal, height / 2],
                                              [0, 0, 1]]), (t, 3, 3)).copy()
        raymap = np.asarray(camera_pose_to_raymap(poses, intrinsic, height=height,
                                                  width=width))
        disparity = 0.5 + 0.01 * video[..., 0].mean(axis=(1, 2))[:, None, None] \
            + np.zeros((t, height, width))
        return AetherPipelineOutput(rgb=video.astype(np.float32),
                                    disparity=disparity.astype(np.float32),
                                    raymap=raymap.astype(np.float32))

    def batch_reconstruct(self, windows, height, width, num_frames, defer_host=False, **kw):
        self.batches += 1
        outs = [FakePipeline.__call__(self, task="reconstruction", video=w, height=height,
                                      width=width, num_frames=num_frames)
                for w in np.asarray(windows)]
        if defer_host:
            from types import SimpleNamespace

            return SimpleNamespace(resolve=lambda: outs)
        return outs


@pytest.fixture(scope="module")
def clip():
    return np.random.default_rng(8).uniform(0, 1, size=(30, 32, 48, 3))


@pytest.mark.parametrize("tile,overlap", [((32, 32), (8, 8)), ((24, 48), (6, 8))])
def test_video_depth_driver_matches_jax(clip, tile, overlap):
    """Two temporal windows x two horizontal (or vertical) tiles: the blend
    keeps the fake's rgb and its disparity, as the JAX driver's does."""
    from aether_tpu.eval.video_depth import process_with_sliding_window as jax_driver
    from aether_tpu_torch.eval.video_depth import process_with_sliding_window

    kw = dict(num_inference_steps=1, window_frames=17, temporal_stride=8, tile=tile,
              spatial_overlap=overlap)
    pipe = FakePipeline(port=True)
    rgb, disp = process_with_sliding_window(pipe, clip, **kw)
    rgb_ref, disp_ref = jax_driver(FakePipeline(port=False), clip, **kw)
    assert pipe.calls == 3 * 2  # starts 0, 8, 13; two tiles
    assert rgb.shape == clip.shape and disp.shape == clip.shape[:3]
    np.testing.assert_allclose(rgb, clip, atol=1e-5)
    np.testing.assert_allclose(rgb, rgb_ref, atol=1e-6)
    np.testing.assert_allclose(disp, disp_ref, atol=1e-6)


def test_video_depth_batched_matches_serial(clip):
    from aether_tpu_torch.eval.video_depth import process_with_sliding_window

    kw = dict(num_inference_steps=1, window_frames=17, temporal_stride=8, tile=(32, 32),
              spatial_overlap=(8, 8))
    serial = process_with_sliding_window(FakePipeline(port=True), clip, batch_calls=1, **kw)
    pipe = FakePipeline(port=True)
    batched = process_with_sliding_window(pipe, clip, batch_calls=4, **kw)
    assert pipe.batches == 2 and pipe.calls == 6  # chunks of 4 and 2
    for a, b in zip(batched, serial):
        np.testing.assert_array_equal(a, b)


def test_spatial_tiles_match_jax():
    from aether_tpu.eval.video_depth import _spatial_tiles as jax_tiles
    from aether_tpu_torch.eval.video_depth import _spatial_tiles

    for shape in ((480, 1000), (800, 720), (480, 720), (480, 960)):
        assert _spatial_tiles(*shape, (480, 720), (60, 90)) == jax_tiles(
            *shape, (480, 720), (60, 90))


def test_feather_axis_matches_jax():
    from aether_tpu.eval.video_depth import _feather_axis as jax_feather
    from aether_tpu_torch.eval.video_depth import _feather_axis

    rng = np.random.default_rng(1)
    prev, curr = rng.normal(size=(5, 40, 3)), rng.normal(size=(5, 30, 3))
    np.testing.assert_array_equal(_feather_axis(prev, curr, 40, (28, 58), 1),
                                  jax_feather(prev, curr, 40, (28, 58), 1))


def test_rel_pose_driver_matches_jax(clip, tmp_path):
    """Kalman-smoothed windows, SVD pose alignment, SLERP overlap and the
    final smoothing agree with the JAX driver's; the TUM export round-trips."""
    from aether_tpu.eval.rel_pose import process_video_with_sliding_window as jax_driver
    from aether_tpu_torch.eval.rel_pose import process_video_with_sliding_window

    kw = dict(num_inference_steps=1, window_frames=17, temporal_stride=8)
    pipe = FakePipeline(port=True)
    got = process_video_with_sliding_window(pipe, clip, **kw)
    ref = jax_driver(FakePipeline(port=False), clip, **kw)
    assert pipe.calls == 3 and pipe.batches == 0
    assert got["poses"].shape == (30, 4, 4) and got["focals"].shape == (30,)
    assert got["range"] == ref["range"] == (0, 30)
    for key, atol in (("rgb", 1e-6), ("disparity", 1e-6), ("poses", 1e-4), ("focals", 1e-3)):
        np.testing.assert_allclose(got[key], ref[key], atol=atol, err_msg=key)
    traj, stamps = pose_metrics.save_tum_poses(got["poses"], str(tmp_path / "traj.txt"))
    loaded, loaded_stamps = pose_metrics.load_tum_file(str(tmp_path / "traj.txt"))
    np.testing.assert_allclose(loaded, traj, atol=1e-7)
    assert loaded.shape == (30, 7) and np.array_equal(loaded_stamps, stamps)


# ---------------------------------------------------------------------------
# the command lines over a synthetic Sintel-layout dataset
# ---------------------------------------------------------------------------


def _write_sintel_cams(cam_dir, n):
    from aether_tpu_torch.eval.datasets import TAG_FLOAT

    os.makedirs(cam_dir, exist_ok=True)
    for i in range(n):
        w2c = np.eye(4)[:3]
        w2c[:3, 3] = [0.1 * i, 0.02 * i * i, 1.0]
        with open(os.path.join(cam_dir, f"frame_{i:04d}.cam"), "wb") as f:
            np.array([TAG_FLOAT], np.float32).tofile(f)
            np.eye(3).astype(np.float64).tofile(f)
            w2c.astype(np.float64).tofile(f)
    return str(cam_dir)


@pytest.fixture(scope="module")
def sintel_root(tmp_path_factory):
    """alley_2: 17 frames of 64x96 with depth and cameras; cave_2: a frame
    that is not an image, so its sequence fails."""
    from PIL import Image

    from aether_tpu_torch.eval.datasets import TAG_FLOAT

    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    frames = root / "sintel/training/final/alley_2"
    depth = root / "sintel/training/depth/alley_2"
    frames.mkdir(parents=True)
    depth.mkdir(parents=True)
    for i in range(17):
        Image.fromarray(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)).save(
            frames / f"frame_{i:04d}.png")
        with open(depth / f"frame_{i:04d}.dpt", "wb") as f:
            np.array([TAG_FLOAT], np.float32).tofile(f)
            np.array([96, 64], np.int32).tofile(f)
            rng.uniform(1.0, 10.0, (64, 96)).astype(np.float32).tofile(f)
    _write_sintel_cams(root / "sintel/training/camdata_left/alley_2", 17)
    broken = root / "sintel/training/final/cave_2"
    broken.mkdir(parents=True)
    (broken / "frame_0000.png").write_bytes(b"not an image")
    return str(root)


def _count_calls(monkeypatch, module, name):
    calls = []
    original = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return original(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_video_depth_main(sintel_root, tmp_path, monkeypatch, capsys):
    from aether_tpu_torch.eval import video_depth

    out = tmp_path / "out"
    argv = ["--eval_dataset", "sintel", "--data_root", sintel_root, "--output_dir", str(out),
            "--random-init", "tiny", "--device", "cpu", "--window_frames", "17",
            "--tile", "64", "96", "--spatial_overlap", "8", "12",
            "--num_inference_step", "1", "--seq_list", "alley_2", "cave_2"]
    video_depth.main(argv)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["valid_pixels"] == 17 * 64 * 96 and np.isfinite(summary["Abs Rel"])
    assert "cave_2" in (out / "_error_log_0.txt").read_text()
    assert len(list((out / "alley_2").glob("frame_*.npy"))) == 17
    result = json.loads((out / "result_scale.json").read_text())
    assert set(result["per_sequence"]) == {"alley_2"}

    calls = _count_calls(monkeypatch, video_depth, "process_with_sliding_window")
    video_depth.main(argv + ["--resume"])
    assert calls == []  # alley_2 skipped; cave_2 fails before the driver
    assert (out / "_error_log_0.txt").read_text().count("Exception in sequence cave_2") == 2
    video_depth.main(argv + ["--no_inference", "--align", "lad2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["valid_pixels"] > 0


def test_rel_pose_main(sintel_root, tmp_path, monkeypatch, capsys):
    from aether_tpu_torch.eval import rel_pose

    out = tmp_path / "out"
    argv = ["--eval_dataset", "sintel", "--data_root", sintel_root, "--output_dir", str(out),
            "--random-init", "tiny", "--device", "cpu", "--window_frames", "17",
            "--target", "64", "96", "--num_inference_step", "1",
            "--seq_list", "alley_2", "cave_2"]
    rel_pose.main(argv)
    average = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(average) >= {"ATE", "RPE trans", "RPE rot"}
    assert "cave_2" in (out / "_error_log_0.txt").read_text()
    assert np.loadtxt(out / "alley_2" / "pred_traj.txt").shape == (17, 8)
    assert np.loadtxt(out / "alley_2" / "pred_focal.txt").shape == (17,)
    assert (out / "alley_2" / "eval_metric.txt").exists()
    assert (out / "_average_metrics.json").exists()

    calls = _count_calls(monkeypatch, rel_pose, "process_video_with_sliding_window")
    rel_pose.main(argv + ["--resume"])
    assert calls == []  # alley_2 skipped; cave_2 fails before the driver


DRIVER_ARGS = {
    "video_depth": ["--window_frames", "17", "--tile", "64", "96",
                    "--spatial_overlap", "8", "12"],
    "rel_pose": ["--window_frames", "17", "--target", "64", "96"],
}


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--tp", "2"], ["--distributed"]])
@pytest.mark.parametrize("driver", ["video_depth", "rel_pose"])
def test_main_runs_on_two_ranks(driver, flag, sintel_root, tmp_path):
    """Each driver's ``main`` under a two-rank gloo world (the variables
    torchrun sets). ``--dp 2`` / ``--tp 2`` give the two ranks one mesh: one
    replica runs both sequences and its first rank writes; ``--distributed``
    alone makes each rank a replica of its own, the sequences sharded between
    them. Rank 0 alone scores, after the barrier."""
    from aether_tpu_torch.parallel.launch import spawn

    out = tmp_path / "out"
    argv = ["--eval_dataset", "sintel", "--data_root", sintel_root, "--output_dir", str(out),
            "--random-init", "tiny", "--device", "cpu", "--num_inference_step", "1",
            "--seq_list", "alley_2", "cave_2", *DRIVER_ARGS[driver], *flag]
    printed = spawn("aether_tpu_torch.parallel.launch:run_main", 2,
                    dict(module=f"aether_tpu_torch.eval.{driver}", argv=argv),
                    env={"OMP_NUM_THREADS": "1"})
    summary = json.loads(printed[0].strip().splitlines()[-1])
    assert printed[1] == ""
    # cave_2 fails where it runs: the one replica's, or the second replica's
    log = f"_error_log_{1 if flag == ['--distributed'] else 0}.txt"
    assert sorted(p.name for p in out.glob("_error_log_*")) == [log]
    assert "cave_2" in (out / log).read_text()
    if driver == "video_depth":
        assert summary["valid_pixels"] == 17 * 64 * 96 and np.isfinite(summary["Abs Rel"])
        assert len(list((out / "alley_2").glob("frame_*.npy"))) == 17
    else:
        assert set(summary) >= {"ATE", "RPE trans", "RPE rot"}
        assert np.loadtxt(out / "alley_2" / "pred_traj.txt").shape == (17, 8)


@pytest.mark.parametrize("driver", ["video_depth", "rel_pose"])
def test_main_defaults_to_cuda(driver, tmp_path):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would run")
    module = importlib.import_module(f"aether_tpu_torch.eval.{driver}")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        module.main(["--eval_dataset", "sintel", "--output_dir", str(tmp_path),
                     "--no_inference"])

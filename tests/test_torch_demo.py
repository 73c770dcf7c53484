"""The port's demo CLI (``python -m aether_tpu_torch.apps.demo``) on the CPU.

The tiny random-init pipeline reconstructs a short 64x96 GIF clip in two
sliding windows (serially and batched) and writes poses, a PLY cloud and GLB
scenes, which parse back; prediction runs with its post-reconstruction
refinement. Without ``--device cpu`` the CLI raises where there is no CUDA;
the ``--wire_*`` flags reach the pipeline (the JAX defaults when absent);
``--dp/--tp`` run over a mesh of two gloo ranks.
The quantized random inits and ``--checkpoint`` are in test_torch_io.py.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from aether_tpu_torch.apps import demo
from test_torch_viz import parse_glb, parse_ply

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--random-init", "tiny", "--height", "64", "--width", "96",
        "--num_inference_steps", "1", "--pointcloud_save_frame_interval", "8"]


def _gif(path, frames):
    rng = np.random.default_rng(0)
    images = [Image.fromarray((rng.uniform(0, 1, (64, 96, 3)) * 255).astype(np.uint8))
              for _ in range(frames)]
    images[0].save(path, save_all=True, append_images=images[1:], duration=80, loop=0)
    return str(path)


def _check_outputs(written, frames):
    poses = np.loadtxt(written["poses"])
    assert poses.shape == (frames, 16) and np.isfinite(poses).all()
    rot = poses.reshape(frames, 4, 4)[:, :3, :3]
    np.testing.assert_allclose(np.einsum("tij,tik->tjk", rot, rot),
                               np.tile(np.eye(3), (frames, 1, 1)), atol=1e-4)
    _, body = parse_ply(written["ply"])
    assert len(body) > 0 and np.isfinite(body["x"]).all()
    assert len(written["glb"]) == -(-frames // 8)
    for path in written["glb"]:
        with open(path, "rb") as f:
            gltf, _ = parse_glb(f.read())
        assert gltf["meshes"]


@pytest.mark.parametrize("batch_windows", ["1", "2"])
def test_reconstruction_cli_writes_poses_ply_glb(tmp_path, capsys, batch_windows):
    video = _gif(tmp_path / "clip.gif", 25)
    out = tmp_path / "out"
    demo.main(["--task", "reconstruction", "--video", video, "--num_frames", "17",
               "--sliding_window_stride", "8", "--batch_windows", batch_windows,
               "--output_dir", str(out), *TINY])
    printed = capsys.readouterr().out
    for stage in ("windows", "blend", "export"):
        assert f"stage {stage}:" in printed
    args = demo.parse_args(["--task", "reconstruction", "--video", video,
                            "--output_dir", str(out)])
    stem = out / "reconstruction_clip"
    written = {"poses": f"{stem}_poses.txt", "ply": f"{stem}_pointcloud.ply",
               "glb": [f"{stem}_pointcloud_frame_{i}.glb" for i in (0, 8, 16, 24)]}
    assert args.device == "cuda"
    _check_outputs(written, 25)
    assert any(p.name.startswith("reconstruction_clip_rgb") for p in out.iterdir())


def test_prediction_cli_runs_post_reconstruction(tmp_path):
    image = tmp_path / "obs.png"
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (64, 96, 3), dtype=np.uint8)).save(image)
    args = demo.parse_args(["--task", "prediction", "--image", str(image),
                            "--num_frames", "17", "--output_dir", str(tmp_path / "out"),
                            "--profile_dir", str(tmp_path / "prof"), *TINY])
    assert args.post_reconstruction
    written = demo.run(args)
    _check_outputs(written, 17)
    assert written["poses"].endswith("prediction_obs_poses.txt")


def test_default_device_is_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    video = _gif(tmp_path / "clip.gif", 17)
    base = ["--task", "reconstruction", "--video", video, "--random-init", "tiny"]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            demo.main(base + extra)


@pytest.mark.parametrize("flags,axes", [(["--dp", "2"], "dp=2, tp=1"),
                                        (["--tp", "2"], "dp=1, tp=2")])
def test_parallel_flags_build_a_mesh_and_run(tmp_path, flags, axes):
    """``--dp 2`` / ``--tp 2`` under a two-rank gloo world (the variables
    torchrun sets): the ranks build one mesh and reconstruct; rank 0 alone
    prints and writes, and its poses are the single-process run's."""
    from aether_tpu_torch.parallel.launch import spawn

    video = _gif(tmp_path / "clip.gif", 17)

    def argv(out):
        return ["--task", "reconstruction", "--video", video, "--num_frames", "17",
                "--output_dir", str(out), *TINY]

    printed = spawn("aether_tpu_torch.parallel.launch:run_main", 2,
                    dict(module="aether_tpu_torch.apps.demo",
                         argv=argv(tmp_path / "mesh") + flags),
                    env={"OMP_NUM_THREADS": "1"})
    assert f"mesh: {axes} over 2 ranks" in printed[0]
    assert "poses:" in printed[0] and printed[1] == ""
    stem = tmp_path / "mesh" / "reconstruction_clip"
    _check_outputs({"poses": f"{stem}_poses.txt", "ply": f"{stem}_pointcloud.ply",
                    "glb": [f"{stem}_pointcloud_frame_{i}.glb" for i in (0, 8, 16)]}, 17)
    demo.main(argv(tmp_path / "one"))
    np.testing.assert_allclose(np.loadtxt(f"{stem}_poses.txt"),
                               np.loadtxt(tmp_path / "one" / "reconstruction_clip_poses.txt"),
                               atol=1e-4)


# the ids the cases had while --dp/--tp were flags0 and flags1 here (those
# two cases are now test_parallel_flags_build_a_mesh_and_run)
@pytest.mark.parametrize("flags,item", [
    (["--wire_rgb", "u8"], "wire"),
    (["--wire_rgb", "yuv420"], "wire"),
    (["--wire_input", "yuv420"], "wire"),
    (["--wire_disparity", "fp16"], "wire"),
    (["--wire_disparity", "u8"], "wire"),
], ids=[f"flags{i}-wire" for i in range(2, 7)])
def test_unported_flags_raise(flags, item):
    """The wire flags, which raised while the wires were not ported (the
    name is the one the test had then), reach the pipeline as the JAX demo's
    do; the others keep the JAX defaults (u8 input, fp16 disparity, rgb
    automatic) and ``compact_transfer`` stays automatic (off on the CPU)."""
    argv = ["--task", "reconstruction", "--video", "clip.gif", "--device", "cpu",
            "--random-init", "tiny"]
    pipe, _ = demo.build_pipeline(demo.parse_args(argv + flags))
    want = {"wire_rgb": None, "wire_input": "u8", "wire_disparity": "fp16"}
    want[flags[0][2:]] = flags[1]
    assert {k: getattr(pipe, k) for k in want} == want
    assert pipe.compact_transfer is None and pipe._modes(64, 96) == ("f32", "f32")
    compact = pipe._wire_modes(True, 64, 96)
    assert compact == ("yuv420" if want["wire_rgb"] == "yuv420" else "u8",
                       want["wire_disparity"])

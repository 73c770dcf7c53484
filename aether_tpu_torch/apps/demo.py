"""CLI inference demo: reconstruction / prediction / planning, in PyTorch.

Port of ``aether_tpu/apps/demo.py`` (reference ``scripts/demo.py``): the same
three tasks and flag surface, the temporal sliding window and blending for
long reconstructions, the post-reconstruction refinement for prediction and
planning (``demo.py:588-606``), and the same artifacts (RGB and colorized
disparity videos, per-frame GLB scenes, a PLY cloud, camera poses), driven by
the port's :class:`~aether_tpu_torch.pipeline.AetherPipeline`.

It runs on the GPU: ``--device`` defaults to ``cuda`` and raises where there
is none, unless ``--device cpu`` is given. The weights come from a converted
checkpoint (``--checkpoint DIR`` from ``python -m aether_tpu_torch.io.convert``,
``--config`` naming its topology) or are seeded random (``--random-init``):
``tiny`` / ``aetherv1`` in the compute dtype, ``-fp8`` / ``-int8`` built
directly in the quantized layout (``init_quantized_dit``). int8 weights run
with int8 activations (w8a8, the JAX bench's deployment configuration),
from a checkpoint too. ``--wire_rgb/--wire_input/--wire_disparity`` pick the
pipeline's wires (compact, on a card by default: u8 RGB and fp16 disparity;
see ``pipeline/aether.py``).

``--dp/--tp`` run it on several cards, one process per card, under
``torchrun``: the ranks join one process group (NCCL on CUDA, gloo with
``--device cpu``) and, when the world has more than one rank, one
``parallel.make_mesh(dp, tp)`` mesh (an axis not given takes the rest of the
world). Every rank runs the same requests; rank 0 alone prints and writes.

Usage:
    python -m aether_tpu_torch.apps.demo --task reconstruction --video clip.mp4 \\
        --random-init aetherv1-int8
    python -m aether_tpu_torch.apps.demo --task reconstruction --video clip.mp4 \\
        --checkpoint converted
    python -m aether_tpu_torch.apps.demo --device cpu --random-init tiny-int8 \\
        --task reconstruction --video clip.gif --height 64 --width 96
    torchrun --nproc_per_node 4 -m aether_tpu_torch.apps.demo --dp 2 --tp 2 \\
        --task prediction --image obs.png --random-init aetherv1
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from aether_tpu_torch.geometry.raymap import raymap_to_poses
from aether_tpu_torch.pipeline.windowing import (
    blend_and_merge_window_results,
    run_windowed_reconstruction,
)


RANDOM_INITS = ["tiny", "aetherv1", "aetherv1-fp8", "aetherv1-int8", "tiny-fp8", "tiny-int8"]
WEIGHT_FORMATS = {"fp8": torch.float8_e4m3fn, "int8": torch.int8}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="AetherV1 inference demo (PyTorch)")
    p.add_argument("--task", type=str, required=True,
                   choices=["reconstruction", "prediction", "planning"])
    p.add_argument("--video", type=str, default=None,
                   help="Video path ('reconstruction' only).")
    p.add_argument("--image", type=str, default=None,
                   help="Image path ('prediction'/'planning').")
    p.add_argument("--goal", type=str, default=None,
                   help="Goal image path ('planning' only).")
    p.add_argument("--raymap_action", type=str, default=None,
                   help=".npy raymap of shape (F, 6, H/8, W/8).")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fps", type=int, default=12, choices=[8, 10, 12, 15, 24])
    p.add_argument("--num_inference_steps", type=int, default=None)
    p.add_argument("--guidance_scale", type=float, default=None)
    p.add_argument("--use_dynamic_cfg", dest="use_dynamic_cfg",
                   action="store_true", default=None,
                   help="Force dynamic CFG on (default: task-dependent).")
    p.add_argument("--no_dynamic_cfg", dest="use_dynamic_cfg", action="store_false",
                   help="Force dynamic CFG off.")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=720)
    p.add_argument("--num_frames", type=int, default=41)
    p.add_argument("--max_depth", type=float, default=100.0)
    p.add_argument("--rtol", type=float, default=0.2,
                   help="Relative tolerance for depth-edge masking in GLB export.")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Converted checkpoint directory (dit.pt / vae.pt / "
                        "text_embeds.npy, from aether_tpu_torch.io.convert).")
    p.add_argument("--random-init", dest="random_init", type=str, default=None,
                   choices=RANDOM_INITS,
                   help="Seeded random weights instead of a checkpoint; -fp8/-int8 "
                        "build the quantized layout directly, -int8 with int8 "
                        "activations (the bench deployment configuration).")
    p.add_argument("--config", type=str, default="aetherv1",
                   choices=["aetherv1", "tiny"],
                   help="Model topology of --checkpoint.")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to run on (default cuda; cpu only when asked).")
    p.add_argument("--smooth_camera", action="store_true", default=True)
    p.add_argument("--smooth_method", type=str, default="kalman",
                   choices=["kalman", "simple"])
    p.add_argument("--sliding_window_stride", type=int, default=24)
    p.add_argument("--batch_windows", type=int, default=None,
                   help="Reconstruct N sliding windows per batched denoise "
                        "(default 1).")
    p.add_argument("--post_reconstruction", action="store_true", default=True)
    p.add_argument("--no_post_reconstruction", dest="post_reconstruction",
                   action="store_false")
    p.add_argument("--pointcloud_save_frame_interval", type=int, default=10)
    p.add_argument("--align_pointmaps", action="store_true", default=False)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="If set, write a torch.profiler trace here.")
    p.add_argument("--wire_rgb", type=str, default=None, choices=["u8", "yuv420"],
                   help="compact D2H rgb wire format (default: u8 on a card)")
    p.add_argument("--wire_input", type=str, default="u8", choices=["u8", "yuv420"],
                   help="H2D pixel wire; yuv420 is 2x smaller and lossless up to a "
                        "resample roundtrip for mp4-decoded input")
    p.add_argument("--wire_disparity", type=str, default="fp16", choices=["fp16", "u8"],
                   help="compact D2H disparity wire (u8 = sqrt-domain 8-bit)")
    p.add_argument("--dp", type=int, default=None,
                   help="Data-parallel mesh axis (the CFG pair, windows, the decode's "
                        "streams); one process per card under torchrun.")
    p.add_argument("--tp", type=int, default=None,
                   help="Tensor-parallel mesh axis (Megatron DiT split); one process "
                        "per card under torchrun.")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; raises for CUDA where there is none (the entry
    points never carry on on the CPU unless asked). A CUDA device without an
    index gets the current one's, so that a thread other than this one (the
    server's worker) can make it current."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass --device cpu "
                           "to run on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def build_mesh(args: argparse.Namespace, replicas: bool = False):
    """The mesh ``--dp/--tp`` ask for, or None when neither is given.

    Joins the process group ``torchrun``'s variables describe
    (:func:`~aether_tpu_torch.parallel.initialize`; NCCL for a CUDA
    ``--device``, gloo for the CPU). Without ``replicas`` the whole world
    holds one mesh, with the JAX factorization (an axis not given takes the
    rest), and a world of one rank holds none, as the JAX demo builds a mesh
    only over more than one device. With ``replicas`` (the eval drivers) an
    axis not given is 1 and each group of ``dp * tp`` consecutive ranks holds
    one mesh."""
    import torch.distributed as dist

    from aether_tpu_torch.parallel import initialize, make_mesh

    dp, tp = getattr(args, "dp", None), getattr(args, "tp", None)
    if not (dp or tp):
        return None
    initialize(device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not replicas:
        return make_mesh(dp=dp, tp=tp) if world > 1 else None
    dp, tp = dp or 1, tp or 1
    if dp * tp == 1:
        return None
    if world % (dp * tp):
        raise ValueError(f"dp({dp}) * tp({tp}) does not divide the world ({world})")
    return make_mesh(dp=dp, tp=tp, replicas=world // (dp * tp))


def build_pipeline(args: argparse.Namespace, mesh=None):
    """An ``AetherPipeline`` in the compute dtype (bf16 on CUDA, f32 on the
    CPU) from ``--checkpoint`` (its tensors in their saved dtypes) or from
    seeded random weights (DiT seed 0, VAE seed 1, a zero prompt embedding).
    A DiT with int8 codes runs with int8 activations. ``mesh`` (from
    :func:`build_mesh`) splits it over the process group. The wire flags
    (a command line without them gets the JAX defaults) reach the pipeline,
    whose ``compact_transfer`` stays automatic: on for a card."""
    from aether_tpu_torch.config import PipelineConfig
    from aether_tpu_torch.io.weights import load_checkpoint
    from aether_tpu_torch.models import init_dit, init_quantized_dit, init_vae
    from aether_tpu_torch.models.dit import QuantLinear
    from aether_tpu_torch.pipeline import AetherPipeline

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.random_init is not None:
        topology, _, fmt = args.random_init.partition("-")
        cfg = getattr(PipelineConfig, topology)()
        if fmt:
            dit = init_quantized_dit(cfg.dit, WEIGHT_FORMATS[fmt], device=device, seed=0)
        else:
            dit = init_dit(cfg.dit, device=device, dtype=dtype, seed=0)
        vae = init_vae(cfg.vae, device=device, dtype=dtype, seed=1)
        text = np.zeros((1, cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim), np.float32)
    elif args.checkpoint is not None:
        cfg = getattr(PipelineConfig, args.config)()
        dit, vae, text = load_checkpoint(args.checkpoint, cfg, device)
    else:
        raise SystemExit("one of --checkpoint or --random-init is required (no "
                         "checkpoint is in the repository)")
    act_quant = any(isinstance(m, QuantLinear) and m.q.dtype == torch.int8
                    for m in dit.modules())
    return AetherPipeline(cfg, dit, vae, text, device=device, compute_dtype=dtype,
                          act_quant=act_quant, mesh=mesh,
                          wire_rgb=getattr(args, "wire_rgb", None),
                          wire_input=getattr(args, "wire_input", "u8"),
                          wire_disparity=getattr(args, "wire_disparity", "fp16")), cfg


def _load_video(path: str) -> np.ndarray:
    import imageio.v3 as iio

    return np.asarray(iio.imread(path)).astype(np.float32) / 255.0


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def _flip_xy_pointmap(pointmap: np.ndarray) -> np.ndarray:
    """Viewer-convention fix: negate world X and Y (reference demo.py:455-460)."""
    out = pointmap.copy()
    out[..., 0] = -out[..., 0]
    out[..., 1] = -out[..., 1]
    return out


def _flip_xy_poses(poses: np.ndarray) -> np.ndarray:
    """Matching pose flip: negate X/Y rows and columns of R, X/Y of t
    (reference demo.py:462-478)."""
    out = poses.copy()
    out[..., 0, :3] = -out[..., 0, :3]
    out[..., 1, :3] = -out[..., 1, :3]
    out[..., :3, 0] = -out[..., :3, 0]
    out[..., :3, 1] = -out[..., :3, 1]
    out[..., 0, 3] = -out[..., 0, 3]
    out[..., 1, 3] = -out[..., 1, 3]
    return out


@contextlib.contextmanager
def _timed(name: str):
    """Print a stage's host seconds (rank 0 only), inside a profiler range
    ``demo.<name>``."""
    from aether_tpu_torch.parallel import is_main

    t0 = time.perf_counter()
    with torch.profiler.record_function(f"demo.{name}"):
        yield
    if is_main():
        print(f"stage {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def save_geometry(stem: str, rgb: np.ndarray, disparity: np.ndarray, poses: np.ndarray,
                  pointmap: np.ndarray, max_depth: float = 100.0, rtol: float = 0.2,
                  frame_interval: int = 10) -> dict:
    """Write the camera poses (``<stem>_poses.txt``), a PLY cloud and one GLB
    scene every ``frame_interval`` frames, in the viewer's axis convention
    (reference ``demo.py:455-478``). Returns the written paths."""
    from aether_tpu_torch.viz import predictions_to_glb, save_ply

    pointmap = _flip_xy_pointmap(np.asarray(pointmap))
    poses = _flip_xy_poses(np.asarray(poses))
    written = {}
    np.savetxt(f"{stem}_poses.txt", poses.reshape(len(poses), -1), fmt="%.9g")
    written["poses"] = f"{stem}_poses.txt"

    depth = 1.0 / np.clip(disparity, 1e-8, 1e8)
    save_ply(pointmap, np.clip(rgb, 0, 1) * 255, f"{stem}_pointcloud.ply",
             mask=depth < max_depth)
    written["ply"] = f"{stem}_pointcloud.ply"

    glbs = []
    for frame_idx in range(pointmap.shape[0])[::frame_interval]:
        predictions = {
            "world_points": pointmap[frame_idx:frame_idx + 1],
            "images": rgb[frame_idx:frame_idx + 1],
            "depths": depth[frame_idx:frame_idx + 1],
            "camera_poses": poses[frame_idx:frame_idx + 1],
        }
        path = f"{stem}_pointcloud_frame_{frame_idx}.glb"
        predictions_to_glb(predictions, filter_by_frames="all", show_cam=True,
                           max_depth=max_depth, rtol=rtol,
                           frame_rel_idx=float(frame_idx) / pointmap.shape[0]).write(path)
        glbs.append(path)
    written["glb"] = glbs
    return written


def save_output(rgb: np.ndarray, disparity: np.ndarray, args: argparse.Namespace,
                poses: Optional[np.ndarray] = None, raymap: Optional[np.ndarray] = None,
                pointmap: Optional[np.ndarray] = None, device=None) -> dict:
    """Write rgb/disparity videos and :func:`save_geometry`'s poses, PLY and
    GLB scenes. Returns a dict of written paths (reference
    ``demo.py:425-521``)."""
    from aether_tpu_torch.pipeline.aether import AetherPipelineOutput
    from aether_tpu_torch.viz import colorize_depth, save_video

    os.makedirs(args.output_dir, exist_ok=True)
    if pointmap is None:
        if raymap is None:
            raise ValueError("a raymap is needed to derive the pointmap")
        window = AetherPipelineOutput(rgb=rgb, disparity=disparity, raymap=raymap)
        _, _, poses_from_blend, pointmap = blend_and_merge_window_results(
            [window], [0], args.height, args.width, smooth_camera=args.smooth_camera,
            smooth_method=args.smooth_method, align_pointmaps=args.align_pointmaps,
            device=device)
        if poses is None:
            poses = poses_from_blend
    if poses is None:
        if raymap is None:
            raise ValueError("a raymap is needed to derive the poses")
        poses = raymap_to_poses(raymap, ray_o_scale_inv=0.1)[0].cpu().numpy()

    if args.task == "reconstruction":
        stem = f"reconstruction_{os.path.splitext(os.path.basename(args.video))[0]}"
    elif args.task == "prediction":
        stem = f"prediction_{os.path.splitext(os.path.basename(args.image))[0]}"
    else:
        stem = (f"planning_{os.path.splitext(os.path.basename(args.image))[0]}"
                f"_{os.path.splitext(os.path.basename(args.goal))[0]}")
    stem = os.path.join(args.output_dir, stem)

    written = {}
    written["rgb_video"] = save_video(f"{stem}_rgb.mp4", np.clip(rgb, 0, 1), fps=12)
    written["disparity_video"] = save_video(f"{stem}_disparity.mp4",
                                            colorize_depth(disparity), fps=12)
    written.update(save_geometry(stem, rgb, disparity, poses, pointmap,
                                 max_depth=args.max_depth, rtol=args.rtol,
                                 frame_interval=args.pointcloud_save_frame_interval))
    return written


def run(args: argparse.Namespace) -> dict:
    """Run the demo's task on a parsed command line; returns the written paths
    (none on a rank other than 0, which computes alongside and writes
    nothing)."""
    from aether_tpu_torch.parallel import is_main

    mesh = build_mesh(args)
    if mesh is not None and is_main():
        axes = ", ".join(f"{n}={s}" for n, s in zip(mesh.mesh_dim_names, mesh.shape))
        print(f"mesh: {axes} over {mesh.size()} ranks", flush=True)
    pipeline, _cfg = build_pipeline(args, mesh)
    if args.batch_windows is None:
        args.batch_windows = 1
    raymap = np.load(args.raymap_action) if args.raymap_action else None
    dev = pipeline.device

    if args.task == "reconstruction":
        if args.video is None:
            raise SystemExit("--video is required for reconstruction")
        video = _load_video(args.video)
        with _timed("windows"):
            window_results, window_indices, args.num_frames = run_windowed_reconstruction(
                pipeline, video, raymap=raymap, height=args.height, width=args.width,
                num_frames=args.num_frames, fps=args.fps,
                num_inference_steps=args.num_inference_steps,
                stride=args.sliding_window_stride, seed=args.seed,
                batch_windows=args.batch_windows)
        if not is_main():
            return {}
        with _timed("blend"):
            rgb, disparity, poses, pointmaps = blend_and_merge_window_results(
                window_results, window_indices, args.height, args.width,
                smooth_camera=args.smooth_camera, smooth_method=args.smooth_method,
                align_pointmaps=args.align_pointmaps, device=dev)
        with _timed("export"):
            return save_output(rgb, disparity, args, poses=poses, pointmap=pointmaps,
                               device=dev)

    if args.image is None:
        raise SystemExit(f"--image is required for {args.task}")
    if args.task == "planning" and args.goal is None:
        raise SystemExit("--goal is required for planning")
    image = _load_image(args.image)
    goal = _load_image(args.goal) if args.goal else None
    with _timed(args.task):
        out = pipeline(task=args.task, image=image, goal=goal, raymap=raymap,
                       height=args.height, width=args.width, num_frames=args.num_frames,
                       fps=args.fps, num_inference_steps=args.num_inference_steps,
                       guidance_scale=args.guidance_scale,
                       use_dynamic_cfg=args.use_dynamic_cfg, seed=args.seed)
    if args.post_reconstruction:
        # re-run a 4-step reconstruction on the generated RGB for cleaner
        # depth and poses (reference demo.py:588-606)
        with _timed("post_reconstruction"):
            recon = pipeline(task="reconstruction", video=out.rgb, height=args.height,
                             width=args.width, num_frames=args.num_frames, fps=args.fps,
                             num_inference_steps=4, guidance_scale=1.0,
                             use_dynamic_cfg=False, seed=args.seed)
        disparity, raymap_out = recon.disparity, recon.raymap
    else:
        disparity, raymap_out = out.disparity, out.raymap
    if not is_main():
        return {}
    with _timed("export"):
        return save_output(out.rgb, disparity, args, raymap=raymap_out, device=dev)


def main(argv=None) -> None:
    args = parse_args(argv)
    profiler = None
    if args.profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
    try:
        written = run(args)
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
            os.makedirs(args.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    for kind, path in written.items():
        print(f"{kind}: {path}")


if __name__ == "__main__":
    main()

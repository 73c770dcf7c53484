"""Relative-pose benchmark driver: stride-32 windows, pose stitching, ATE/RPE.

Capability parity with reference ``evaluation/rel_pose/launch_aether.py``:
temporal-only sliding windows (stride 32, ``:124-137``), per-window pointmap
post-processing with Kalman smoothing (``:151-158``), cross-window blending
(disparity scale-align, SVD pose alignment, SLERP overlap interpolation, final
Kalman trajectory smoothing, ``:172-250``), TUM trajectory + focal export
(``:294-299``), ATE/RPE metrics + trajectory plots (via
:mod:`aether_tpu_torch.eval.pose_metrics` instead of the ``evo`` package), and
cross-process aggregation (``:348-355``).

Port of ``aether_tpu/eval/rel_pose.py`` over the port's pipeline. The
windows run through ``iter_resolved`` with ``defer_host`` (window i's host
transfer and pointmap post-processing overlap window i+1's device work),
serially, or, under a pipeline mesh with dp > 1, in dp-sized chunks through
``batch_reconstruct``, as the JAX driver runs them. ``main`` runs on the card by default (``--device``).
Under ``torchrun``, ``--distributed`` joins the process group and
``--dp/--tp`` give each replica of ``dp * tp`` ranks one mesh; sequences
shard by replica, the first rank of a replica writes its files, and rank 0
aggregates after a barrier (``eval.sharding.join_replicas``).
"""

from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import List, Optional, Sequence, Tuple

import numpy as np

from aether_tpu_torch.eval.datasets import REL_POSE_DATASETS, list_sequences, load_traj
from aether_tpu_torch.eval.pose_metrics import (
    calculate_averages,
    eval_metrics,
    plot_trajectory,
    process_directory,
    save_focals,
    save_tum_poses,
)
from aether_tpu_torch.eval.sharding import join_replicas, shard_sequences
from aether_tpu_torch.geometry.alignment import (
    align_camera_extrinsics,
    apply_transformation,
    poses_to_extrinsics,
)
from aether_tpu_torch.geometry.raymap import postprocess_pointmap
from aether_tpu_torch.geometry.smoothing import smooth_trajectory
from aether_tpu_torch.geometry.transforms import compute_scale
from aether_tpu_torch.pipeline.windowing import stitch_overlap, stitch_poses
from aether_tpu_torch.utils.profiling import stage_timer


def prepare_input(
    img_paths: Sequence[str], target: Tuple[int, int] = (480, 720)
) -> np.ndarray:
    """Load frames: aspect resize (rounded to /16), center-crop to target
    (reference ``rel_pose/launch_aether.py:99-121``)."""
    import cv2
    import imageio.v3 as iio

    th, tw = target
    images = []
    for path in img_paths:
        img = np.asarray(iio.imread(path))
        h, w = img.shape[:2]
        aspect = w / h
        if aspect > tw / th:
            new_h, new_w = th, int(round(th * aspect))
        else:
            new_h, new_w = int(round(tw / aspect)), tw
        new_w = int(round(new_w / 16) * 16)
        new_h = int(round(new_h / 16) * 16)
        img = cv2.resize(img, (new_w, new_h)).astype(np.float64) / 255.0
        start_h, start_w = (new_h - th) // 2, (new_w - tw) // 2
        images.append(img[start_h : start_h + th, start_w : start_w + tw])
    return np.stack(images)


def process_video_with_sliding_window(
    pipeline,
    video: np.ndarray,  # (T, H, W, 3) in [0, 1]
    num_inference_steps: int = 4,
    seed: int = 42,
    window_frames: int = 41,
    temporal_stride: int = 32,
    fps: int = 12,
    ray_o_scale_inv: float = 1.0,
) -> dict:
    """Per-window inference + Kalman-smoothed pose extraction + blending.

    Returns {"rgb", "disparity", "poses" (T,4,4), "focals" (T,)}.
    """
    t = video.shape[0]
    while window_frames > t:
        window_frames -= 8
    assert window_frames > 0, f"video too short: {t} frames"

    t_starts = list(range(0, t - window_frames, temporal_stride))
    if not t_starts or t_starts[-1] != t - window_frames:
        t_starts.append(t - window_frames)

    def _window(out, t_start) -> dict:
        pcd = postprocess_pointmap(
            np.asarray(out.disparity), np.asarray(out.raymap),
            vae_downsample_scale=video.shape[1] // out.raymap.shape[-2],
            ray_o_scale_inv=ray_o_scale_inv,
            smooth_camera=True, smooth_method="kalman",
        )
        focals = (pcd["intrinsics"][:, 0, 0] + pcd["intrinsics"][:, 1, 1]) / 2
        return {
            "rgb": np.asarray(out.rgb),
            "disparity": np.asarray(out.disparity),
            "poses": np.asarray(pcd["camera_pose"]),
            "focals": np.asarray(focals),
            "range": (t_start, t_start + window_frames),
        }

    # defer_host chaining: window i's host transfer and host post-processing
    # overlap window i+1's device work
    from aether_tpu_torch.parallel.mesh import axis_size
    from aether_tpu_torch.pipeline.aether import iter_resolved

    dp = axis_size(getattr(pipeline, "mesh", None), "dp")
    if dp > 1:
        # chunks of dp windows share one denoise over the mesh; every window
        # gets a serial call's noise, and a short tail chunk pads internally
        chunks = [t_starts[i:i + dp] for i in range(0, len(t_starts), dp)]
        dispatches = (
            (lambda ch=chunk: pipeline.batch_reconstruct(
                np.stack([video[s:s + window_frames] for s in ch]),
                height=video.shape[1], width=video.shape[2], num_frames=window_frames,
                fps=fps, num_inference_steps=num_inference_steps, seed=seed,
                defer_host=True))
            for chunk in chunks
        )
        outs: List = []
        for res in iter_resolved(dispatches):
            outs.extend(res)
    else:
        dispatches = (
            (lambda s=t_start: pipeline(
                task="reconstruction", video=video[s:s + window_frames],
                height=video.shape[1], width=video.shape[2],
                num_frames=window_frames, fps=fps,
                num_inference_steps=num_inference_steps,
                guidance_scale=1.0, use_dynamic_cfg=False, seed=seed,
                defer_host=True))
            for t_start in t_starts
        )
        outs = list(iter_resolved(dispatches))
    windows = [
        _window(out, t_start) for t_start, out in zip(t_starts, outs)
    ]
    return blend_window_outputs(windows)


def blend_window_outputs(windows: List[dict]) -> dict:
    """Stitch sliding-window outputs (reference ``launch_aether.py:172-250``
    semantics) on the shared vectorized primitives
    (:func:`~aether_tpu_torch.pipeline.windowing.stitch_overlap` /
    :func:`~aether_tpu_torch.pipeline.windowing.stitch_poses`)."""
    final = dict(windows[0])
    for curr in windows[1:]:
        t_start_curr, t_end_curr = curr["range"]
        overlap_t = final["range"][1] - t_start_curr

        scale = compute_scale(
            curr["disparity"][:overlap_t].reshape(1, 1, -1),
            final["disparity"][-overlap_t:].reshape(1, 1, -1),
            np.ones((1, 1, curr["disparity"][:overlap_t].size)),
        )
        curr = dict(curr, disparity=scale * curr["disparity"])

        rel_r, rel_t, rel_s = align_camera_extrinsics(
            curr["poses"][:overlap_t], final["poses"][-overlap_t:]
        )
        aligned = poses_to_extrinsics(
            apply_transformation(curr["poses"], rel_r, rel_t, rel_s)
        )
        final["poses"] = stitch_poses(final["poses"], aligned, overlap_t)
        for key in ("rgb", "disparity", "focals"):
            final[key] = stitch_overlap(final[key], curr[key], overlap_t)
        final["range"] = (final["range"][0], t_end_curr)

    final["poses"] = smooth_trajectory(np.asarray(final["poses"]), window_size=5)
    return final


def run_sequences(
    pipeline,
    dataset: str,
    data_root: str,
    output_dir: str,
    sequences: Sequence[str],
    pose_eval_stride: int = 1,
    num_inference_steps: int = 4,
    seed: int = 42,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    resume: bool = False,
    write: bool = True,
    **window_kwargs,
) -> List[str]:
    """Run this host's shard; writes per-seq pred_traj.txt / pred_focal.txt /
    eval_metric.txt (+ trajectory plot when GT is available). With ``resume``,
    sequences with an existing pred_traj.txt are skipped. ``write=False``
    runs the inference and writes nothing (a rank of a mesh other than its
    first)."""
    from aether_tpu_torch.eval.datasets import sequence_frames

    meta = REL_POSE_DATASETS[dataset]
    img_path = os.path.join(data_root, meta["img_path"])
    anno_path = os.path.join(data_root, meta.get("anno_path", ""))

    os.makedirs(output_dir, exist_ok=True)
    mine = shard_sequences(list(sequences), process_index, process_count)
    rank = process_index if process_index is not None else 0
    error_log = os.path.join(output_dir, f"_error_log_{rank}.txt")
    done = []
    for seq in mine:
        if resume and os.path.isfile(
            os.path.join(output_dir, seq, "pred_traj.txt")
        ):
            done.append(seq)
            continue
        try:
            frames = sequence_frames(meta, img_path, seq, pose_eval_stride)
            with stage_timer(f"rel_pose/{seq}"):
                video = prepare_input(
                    frames, target=window_kwargs.get("target", (480, 720))
                )
                results = process_video_with_sliding_window(
                    pipeline, video,
                    num_inference_steps=num_inference_steps, seed=seed,
                    **{k: v for k, v in window_kwargs.items() if k != "target"},
                )
            if not write:
                done.append(seq)
                continue
            seq_dir = os.path.join(output_dir, seq)
            os.makedirs(seq_dir, exist_ok=True)
            pred_traj = save_tum_poses(
                results["poses"], os.path.join(seq_dir, "pred_traj.txt")
            )
            save_focals(results["focals"],
                        os.path.join(seq_dir, "pred_focal.txt"))

            gt_file = meta["gt_traj"](img_path, anno_path, seq)
            if gt_file and os.path.exists(gt_file):
                gt_traj = load_traj(gt_file, meta["traj_format"],
                                    stride=pose_eval_stride)
                ate, rpe_t, rpe_r = eval_metrics(
                    pred_traj, gt_traj, seq=seq,
                    filename=os.path.join(seq_dir, "eval_metric.txt"),
                )
                plot_trajectory(pred_traj, gt_traj, title=seq,
                                filename=os.path.join(seq_dir, "traj_plot.png"))
            done.append(seq)
        except Exception as exc:  # log-and-skip per reference error policy
            if not write:
                continue
            with open(error_log, "a") as f:
                f.write(f"Exception in sequence {seq}: {exc}\n")
                f.write(traceback.format_exc() + "\n")
    return done


def aggregate(output_dir: str) -> dict:
    """Average per-sequence eval_metric.txt files across all ranks' outputs
    (reference ``launch_aether.py:348-355`` + ``evo_utils.py:376-427``)."""
    results = process_directory(output_dir)
    averages = calculate_averages(results)
    out = {"per_sequence": results, "average": averages}
    with open(os.path.join(output_dir, "_average_metrics.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


def main(argv=None) -> None:
    from aether_tpu_torch.apps.demo import RANDOM_INITS, build_pipeline
    from aether_tpu_torch.parallel import barrier, is_main

    p = argparse.ArgumentParser(description="relative-pose benchmark (PyTorch)")
    p.add_argument("--eval_dataset", required=True,
                   choices=sorted(REL_POSE_DATASETS))
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--config", type=str, default="aetherv1", choices=["aetherv1", "tiny"],
                   help="Model topology of --checkpoint.")
    p.add_argument("--random-init", dest="random_init", type=str, default=None,
                   choices=RANDOM_INITS)
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to run on (default cuda; cpu only when asked).")
    p.add_argument("--num_inference_step", type=int, default=4)
    p.add_argument("--pose_eval_stride", type=int, default=1)
    p.add_argument("--seq_list", nargs="*", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_inference", action="store_true")
    p.add_argument("--window_frames", type=int, default=41)
    p.add_argument("--temporal_stride", type=int, default=32)
    p.add_argument("--target", type=int, nargs=2, default=(480, 720),
                   metavar=("H", "W"))
    p.add_argument("--dp", type=int, default=None,
                   help="Data-parallel mesh axis of each replica: windows batch "
                        "dp-at-a-time through one denoise.")
    p.add_argument("--tp", type=int, default=None,
                   help="Tensor-parallel mesh axis of each replica.")
    p.add_argument("--resume", action="store_true",
                   help="Skip sequences whose pred_traj.txt already exists.")
    p.add_argument("--distributed", action="store_true",
                   help="Join the process group torchrun describes: sequences "
                        "shard by replica, aggregation runs on rank 0 after a barrier.")
    args = p.parse_args(argv)
    _, mesh, shard = join_replicas(args)

    meta = REL_POSE_DATASETS[args.eval_dataset]
    img_path = os.path.join(args.data_root, meta["img_path"])

    if not args.no_inference:
        sequences = list_sequences(meta, img_path, args.seq_list)
        pipeline, _ = build_pipeline(args, mesh)
        run_sequences(pipeline, args.eval_dataset, args.data_root,
                      args.output_dir, sequences,
                      pose_eval_stride=args.pose_eval_stride,
                      num_inference_steps=args.num_inference_step,
                      seed=args.seed, window_frames=args.window_frames,
                      temporal_stride=args.temporal_stride,
                      target=tuple(args.target), resume=args.resume, **shard)

    barrier()  # every replica's files on disk (nothing in one process)
    if is_main():
        out = aggregate(args.output_dir)
        print(json.dumps(out["average"], ensure_ascii=False))


if __name__ == "__main__":
    main()

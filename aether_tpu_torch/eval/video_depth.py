"""Video-depth benchmark driver: 2-D sliding-window inference + metrics.

Capability parity with reference ``evaluation/video_depth/launch_aether.py``
(temporal windows of <=41 frames stride 8 x spatial 480x720 tiles with 60/90-px
overlap, scale-aligned + linearly feathered, ``:81-287``) and
``evaluation/video_depth/eval_depth.py`` (per-sequence grouping, cubic resize
of predictions to GT resolution, aligned depth metrics, valid-pixel-weighted
averaging). Sequences shard across hosts with :func:`shard_sequences`
(replacing Accelerate's ``split_between_processes``); per-sequence failures
are logged and skipped (reference error policy ``:367-384``).

Improvement over the reference: spatial RGB tiles are feather-blended too (the
reference leaves ``final_spatial_rgb`` as the first tile — a latent bug noted
at ``launch_aether.py:252``).

Port of ``aether_tpu/eval/video_depth.py`` over the port's pipeline. The
(window x tile) grid runs in the JAX order through ``iter_resolved`` with
``defer_host`` (call i+1's device work overlaps call i's host transfer),
serially or, with ``batch_calls > 1`` (by default the pipeline mesh's dp),
in chunks through ``batch_reconstruct``. ``main`` runs on the card by
default (``--device``). Under ``torchrun``, ``--distributed`` joins the
process group and ``--dp/--tp`` give each replica of ``dp * tp`` ranks one
mesh (``apps.demo.build_mesh``); sequences shard by replica (``rank // (dp *
tp)``), the first rank of a replica writes its files, and rank 0 scores after
a barrier (JAX ``main``). Frames are read with ``imageio`` and resized with
``cv2``, both imported where they are used.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback
from typing import List, Optional, Sequence, Tuple

import numpy as np

from aether_tpu_torch.eval.datasets import VIDEO_DEPTH_DATASETS, list_sequences
from aether_tpu_torch.eval.depth_metrics import (
    depth_evaluation,
    group_by_directory,
    weighted_average_metrics,
)
from aether_tpu_torch.eval.sharding import join_replicas, shard_sequences
from aether_tpu_torch.geometry.transforms import compute_scale
from aether_tpu_torch.utils.profiling import stage_timer


def prepare_input(img_paths: Sequence[str],
                  target: Tuple[int, int] = (480, 720)) -> np.ndarray:
    """Load frames, resize so the short side matches the 480/720 target
    (reference ``launch_aether.py:388-403``); returns (T, H, W, 3) in [0, 1]."""
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
        images.append(cv2.resize(img, (new_w, new_h)).astype(np.float64) / 255.0)
    return np.stack(images)


def _spatial_tiles(h: int, w: int, tile: Tuple[int, int],
                   overlap: Tuple[int, int]) -> Tuple[List[Tuple[int, int]], bool]:
    """Tile one axis only (reference asserts h-or-w tiling, ``:96-109``).
    Returns ([(start, end), ...] along the tiled axis, is_horizontal)."""
    th, tw = tile
    ov_h, ov_w = overlap
    h_windows = 1 if h <= th else math.ceil((h - th) / (th - ov_h)) + 1
    w_windows = 1 if w <= tw else math.ceil((w - tw) / (tw - ov_w)) + 1
    assert h_windows == 1 or w_windows == 1, (
        f"only one spatial axis may exceed the tile: {h}x{w} vs {th}x{tw}"
    )
    if w_windows > 1:
        stride = (w - tw) // (w_windows - 1)
        spans = []
        for i in range(w_windows):
            start = min(int(i * stride), w - tw)
            spans.append((start, start + tw))
        return spans, True
    stride = (h - th) // (h_windows - 1) if h_windows > 1 else 0
    spans = []
    for i in range(h_windows):
        start = min(int(i * stride), h - th)
        spans.append((start, start + th))
    return spans, False


def _feather_axis(prev: np.ndarray, curr: np.ndarray, prev_end: int,
                  curr_span: Tuple[int, int], axis: int) -> np.ndarray:
    """Stitch ``curr`` (covering curr_span) onto ``prev`` (covering
    [0, prev_end)) along ``axis`` with a linear cross-fade on the overlap."""
    start, end = curr_span
    overlap = prev_end - start
    total = end
    out_shape = list(prev.shape)
    out_shape[axis] = total
    out = np.empty(out_shape, prev.dtype)

    def sl(a, b):
        idx = [slice(None)] * prev.ndim
        idx[axis] = slice(a, b)
        return tuple(idx)

    out[sl(0, start)] = prev[sl(0, start)]
    out[sl(prev_end, total)] = curr[sl(prev_end - start, end - start)]
    w_shape = [1] * prev.ndim
    w_shape[axis] = overlap
    weight = np.linspace(1, 0, overlap).reshape(w_shape)
    out[sl(start, prev_end)] = (
        prev[sl(start, prev_end)] * weight
        + curr[sl(0, overlap)] * (1 - weight)
    )
    return out


def _run_window_tile_grid(
    pipeline,
    video: np.ndarray,
    t_starts,
    spans,
    is_horizontal: bool,
    window_frames: int,
    tile: Tuple[int, int],
    num_inference_steps: int,
    seed: int,
    fps: int,
    batch_calls: Optional[int],
) -> dict:
    """Run the (temporal window x spatial tile) grid of pipeline calls, in
    the JAX order (window-major).

    Every clip has the identical (window_frames, tile_h, tile_w) shape, so the
    grid flattens into uniform batches: with ``batch_calls > 1`` N
    clips share one batched denoise via ``batch_reconstruct``, whose windows
    get the noise of serial calls. The host transfers are deferred, so call
    (or batch) j+1's work is queued before call j's outputs are resolved.
    Returns {(ti, si): (rgb, disparity)}.
    """
    jobs, clips = [], []
    for ti, t_start in enumerate(t_starts):
        t_end = t_start + window_frames
        for si, (start, end) in enumerate(spans):
            if is_horizontal:
                clip = video[t_start:t_end, : tile[0], start:end]
            else:
                clip = video[t_start:t_end, start:end, : tile[1]]
            jobs.append((ti, si))
            clips.append(clip)

    if batch_calls is None:
        from aether_tpu_torch.parallel.mesh import axis_size

        batch_calls = axis_size(getattr(pipeline, "mesh", None), "dp")
    batch_calls = max(1, min(batch_calls, len(clips)))

    from aether_tpu_torch.pipeline.aether import iter_resolved

    results: dict = {}
    height, width = clips[0].shape[1:3]
    if batch_calls > 1 and hasattr(pipeline, "batch_reconstruct"):
        chunks = [(jobs[i : i + batch_calls], clips[i : i + batch_calls])
                  for i in range(0, len(clips), batch_calls)]
        dispatches = (
            (lambda cl=chunk_clips: pipeline.batch_reconstruct(
                np.stack(cl), height=height, width=width, num_frames=window_frames,
                num_inference_steps=num_inference_steps, fps=fps, seed=seed,
                defer_host=True))
            for _, chunk_clips in chunks
        )
        for (chunk_jobs, _), outs in zip(chunks, iter_resolved(dispatches)):
            for job, o in zip(chunk_jobs, outs):
                results[job] = (np.asarray(o.rgb), np.asarray(o.disparity))
    else:
        dispatches = (
            (lambda c=clip: pipeline(
                task="reconstruction", video=c, height=height, width=width,
                num_frames=window_frames, fps=fps,
                num_inference_steps=num_inference_steps,
                guidance_scale=1.0, use_dynamic_cfg=False, seed=seed,
                defer_host=True))
            for clip in clips
        )
        for job, o in zip(jobs, iter_resolved(dispatches)):
            results[job] = (np.asarray(o.rgb), np.asarray(o.disparity))
    return results


def process_with_sliding_window(
    pipeline,
    video: np.ndarray,  # (T, H, W, 3) in [0, 1]
    num_inference_steps: int = 4,
    seed: int = 3407,
    window_frames: int = 41,
    temporal_stride: int = 8,
    tile: Tuple[int, int] = (480, 720),
    spatial_overlap: Tuple[int, int] = (60, 90),
    fps: int = 12,
    batch_calls: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """2-D sliding-window inference; returns blended (rgb, disparity).
    ``batch_calls`` clips share one ``batch_reconstruct``; None takes the
    pipeline mesh's dp (1 without a mesh)."""
    t, h, w = video.shape[:3]
    while window_frames > t:
        window_frames -= 8
    assert window_frames > 0, f"video too short: {t} frames"

    t_starts = list(range(0, t - window_frames, temporal_stride))
    t_starts.append(t - window_frames)

    spans, is_horizontal = _spatial_tiles(h, w, tile, spatial_overlap)
    axis_sp = 2 if is_horizontal else 1  # (T, H, W) axis being tiled

    results = _run_window_tile_grid(
        pipeline, video, t_starts, spans, is_horizontal, window_frames, tile,
        num_inference_steps, seed, fps, batch_calls,
    )

    temporal_rgb, temporal_disp, temporal_ranges = [], [], []
    for ti, t_start in enumerate(t_starts):
        t_end = t_start + window_frames
        tile_rgb, tile_disp = None, None
        prev_end = 0
        for si, (start, end) in enumerate(spans):
            rgb, disp = results[(ti, si)]
            if tile_rgb is None:
                tile_rgb, tile_disp = rgb, disp
            else:
                overlap = prev_end - start
                take = (lambda a, s: a.take(range(*s), axis=axis_sp))
                scale = compute_scale(
                    take(disp, (0, overlap)).reshape(1, 1, -1),
                    take(tile_disp, (prev_end - overlap, prev_end)).reshape(1, 1, -1),
                    np.ones((1, 1, take(disp, (0, overlap)).size)),
                )
                tile_disp = _feather_axis(tile_disp, scale * disp, prev_end,
                                          (start, end), axis_sp)
                tile_rgb = _feather_axis(tile_rgb, rgb, prev_end,
                                         (start, end), axis_sp)
            prev_end = end
        temporal_rgb.append(tile_rgb)
        temporal_disp.append(tile_disp)
        temporal_ranges.append((t_start, t_end))

    final_rgb, final_disp = temporal_rgb[0], temporal_disp[0]
    prev_end = temporal_ranges[0][1]
    for rgb, disp, (t_start, t_end) in zip(
        temporal_rgb[1:], temporal_disp[1:], temporal_ranges[1:]
    ):
        overlap_t = prev_end - t_start
        scale = compute_scale(
            disp[:overlap_t].reshape(1, 1, -1),
            final_disp[-overlap_t:].reshape(1, 1, -1),
            np.ones((1, 1, disp[:overlap_t].size)),
        )
        final_disp = _feather_axis(final_disp, scale * disp, prev_end,
                                   (t_start, t_end), 0)
        final_rgb = _feather_axis(final_rgb, rgb, prev_end, (t_start, t_end), 0)
        prev_end = t_end
    return final_rgb, final_disp


# ---------------------------------------------------------------------------
# per-sequence driver
# ---------------------------------------------------------------------------


def run_sequences(
    pipeline,
    sequences: Sequence[str],
    frame_lists: dict,
    output_dir: str,
    num_inference_steps: int = 4,
    seed: int = 3407,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    resume: bool = False,
    write: bool = True,
    **window_kwargs,
) -> List[str]:
    """Run sliding-window depth inference for this host's shard of sequences.

    Writes ``<output_dir>/<seq>/frame_%04d.npy`` depth maps + preview videos;
    failures are appended to a per-rank error log and skipped. With ``resume``,
    sequences whose outputs already exist are skipped (the reference's
    ``skip_condition`` resumable-eval hook, ``video_depth/metadata.py:18``).
    ``write=False`` runs the inference and writes nothing (a rank of a mesh
    other than its first).
    """
    from aether_tpu_torch.viz import depth_video_frames, save_video

    os.makedirs(output_dir, exist_ok=True)
    mine = shard_sequences(list(sequences), process_index, process_count)
    rank = process_index if process_index is not None else 0
    error_log = os.path.join(output_dir, f"_error_log_{rank}.txt")
    done = []
    for seq in mine:
        if resume:
            existing = len(
                [f for f in os.listdir(os.path.join(output_dir, seq))
                 if f.startswith("frame_")]
                if os.path.isdir(os.path.join(output_dir, seq)) else []
            )
            if existing >= len(frame_lists[seq]):
                done.append(seq)
                continue
        try:
            with stage_timer(f"video_depth/{seq}"):
                video = prepare_input(
                    frame_lists[seq],
                    target=window_kwargs.get("tile", (480, 720)),
                )
                rgb, disparity = process_with_sliding_window(
                    pipeline, video, num_inference_steps=num_inference_steps,
                    seed=seed, **window_kwargs,
                )
            if not write:
                done.append(seq)
                continue
            depth = np.clip(
                1.0 / np.clip(disparity, 1e-8, None), 0, 1e2
            )
            seq_dir = os.path.join(output_dir, seq)
            os.makedirs(seq_dir, exist_ok=True)
            save_video(os.path.join(seq_dir, "pred_disparity.mp4"),
                       depth_video_frames(disparity), fps=24)
            save_video(os.path.join(seq_dir, "pred_rgb.mp4"),
                       np.clip(rgb, 0, 1), fps=24)
            for i, frame in enumerate(depth):
                np.save(os.path.join(seq_dir, f"frame_{i:04d}.npy"), frame)
            done.append(seq)
        except Exception as exc:  # log-and-skip per reference error policy
            if write:
                with open(error_log, "a") as f:
                    f.write(f"Exception in sequence {seq}: {exc}\n")
                    f.write(traceback.format_exc() + "\n")
    return done


# ---------------------------------------------------------------------------
# metric aggregation over saved predictions
# ---------------------------------------------------------------------------


def evaluate_depth_predictions(
    pred_dir: str,
    dataset: str,
    data_root: str,
    align: str = "scale",
    max_depth: Optional[float] = None,
    device=None,
) -> dict:
    """Score saved ``frame_*.npy`` predictions against dataset GT
    (reference ``eval_depth.py``: group by sequence dir, cubic-resize pred to
    GT, per-sequence ``depth_evaluation``, valid-pixel-weighted average).
    ``device`` runs the LAD2 alignment (the CPU when None)."""
    import cv2
    import glob as globlib

    meta = VIDEO_DEPTH_DATASETS[dataset]
    if max_depth is None:
        max_depth = meta.get("max_depth", 80.0)
    depth_read = meta["depth_read"]
    depth_root = os.path.join(data_root, meta["depth_path"])

    pred_paths = sorted(globlib.glob(f"{pred_dir}/*/frame_*.npy"))
    grouped_pred = group_by_directory(pred_paths)

    per_seq = {}
    gathered = []
    for seq, pd_paths in sorted(grouped_pred.items()):
        depth_dir = meta.get(
            "depth_dir_path", lambda root, s: os.path.join(root, s)
        )(depth_root, seq)
        gt_paths = sorted(
            globlib.glob(os.path.join(depth_dir, f"*{meta['depth_ext']}"))
        )
        if not gt_paths:
            continue
        n = min(len(gt_paths), len(pd_paths))
        gt = np.stack([depth_read(p) for p in gt_paths[:n]])
        pred = np.stack(
            [
                cv2.resize(np.load(p), (gt.shape[2], gt.shape[1]),
                           interpolation=cv2.INTER_CUBIC)
                for p in pd_paths[:n]
            ]
        )
        metrics, *_ = depth_evaluation(pred, gt, max_depth=max_depth,
                                       align=align, device=device)
        per_seq[seq] = metrics
        gathered.append(metrics)

    summary = weighted_average_metrics(gathered)
    result = {"dataset": dataset, "align": align, "summary": summary,
              "per_sequence": per_seq}
    with open(os.path.join(pred_dir, f"result_{align}.json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> None:
    from aether_tpu_torch.apps.demo import RANDOM_INITS, build_pipeline
    from aether_tpu_torch.eval.datasets import sequence_frames
    from aether_tpu_torch.parallel import barrier, is_main

    p = argparse.ArgumentParser(description="video-depth benchmark (PyTorch)")
    p.add_argument("--eval_dataset", required=True,
                   choices=sorted(VIDEO_DEPTH_DATASETS))
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
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--align", type=str, default="scale",
                   choices=["median", "lstsq", "lad", "lad2", "scale", "metric"])
    p.add_argument("--no_inference", action="store_true",
                   help="Skip inference; only score existing predictions.")
    p.add_argument("--window_frames", type=int, default=41)
    p.add_argument("--temporal_stride", type=int, default=8)
    p.add_argument("--tile", type=int, nargs=2, default=(480, 720),
                   metavar=("H", "W"))
    p.add_argument("--spatial_overlap", type=int, nargs=2, default=(60, 90),
                   metavar=("H", "W"))
    p.add_argument("--dp", type=int, default=None,
                   help="Data-parallel mesh axis of each replica: clips batch "
                        "dp-at-a-time through one denoise (batch_calls follows it).")
    p.add_argument("--tp", type=int, default=None,
                   help="Tensor-parallel mesh axis of each replica.")
    p.add_argument("--resume", action="store_true",
                   help="Skip sequences whose outputs already exist.")
    p.add_argument("--distributed", action="store_true",
                   help="Join the process group torchrun describes: sequences "
                        "shard by replica, scoring runs on rank 0 after a barrier.")
    args = p.parse_args(argv)
    device, mesh, shard = join_replicas(args)

    meta = VIDEO_DEPTH_DATASETS[args.eval_dataset]
    img_path = os.path.join(args.data_root, meta["img_path"])

    if not args.no_inference:
        sequences = list_sequences(meta, img_path, args.seq_list)
        frame_lists = {
            seq: sequence_frames(meta, img_path, seq, args.pose_eval_stride)
            for seq in sequences
        }
        pipeline, _ = build_pipeline(args, mesh)
        run_sequences(pipeline, sequences, frame_lists, args.output_dir,
                      num_inference_steps=args.num_inference_step,
                      seed=args.seed, window_frames=args.window_frames,
                      temporal_stride=args.temporal_stride,
                      tile=tuple(args.tile),
                      spatial_overlap=tuple(args.spatial_overlap),
                      resume=args.resume, **shard)

    barrier()  # every replica's frames on disk (nothing in one process)
    if is_main():
        result = evaluate_depth_predictions(
            args.output_dir, args.eval_dataset, args.data_root, align=args.align,
            device=device)
        print(json.dumps(result["summary"], ensure_ascii=False))


if __name__ == "__main__":
    main()

"""Temporal sliding-window scheduling and cross-window blending.

Port of ``aether_tpu/pipeline/windowing.py``. Long videos exceed the model's
41-frame context, so reconstruction runs per window and stitches (reference
``scripts/demo.py:235-422``): disparity is scale-aligned on the overlap
(masked least squares) and cross-faded; RGB is cross-faded; poses are
similarity-aligned (SVD) and SLERP-blended; focals are ratio-aligned and
lerped; finally the whole clip is unprojected to pointmaps in one batched
``project`` on the pipeline's device. The host blending is float64 numpy, as
in the JAX package.

The windows run with ``defer_host`` pipelining, as in the JAX driver: window
i+1's work is queued before window i's outputs are resolved, so window i's
copies to the host and its host work ride beside window i+1's device work.
Each dispatch runs inside a ``torch.profiler`` range ``aether.window@<start>``
(``aether.windows@<start>x<n>`` for a chunk) and the JAX driver's
``dispatch@`` / ``resolve@`` stage timers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from aether_tpu_torch.geometry.alignment import (
    align_camera_extrinsics,
    apply_transformation,
    poses_to_extrinsics,
)
from aether_tpu_torch.geometry.raymap import postprocess_pointmap, raymap_to_poses
from aether_tpu_torch.geometry.rays import get_intrinsics, project
from aether_tpu_torch.geometry.smoothing import interpolate_poses_batch
from aether_tpu_torch.geometry.transforms import compute_scale
from aether_tpu_torch.utils.profiling import stage_timer


def stitch_overlap(prev: np.ndarray, curr: np.ndarray, overlap: int) -> np.ndarray:
    """Concatenate ``prev`` (frames [0, p)) and ``curr`` (frames [p - overlap,
    ...)) with a linear cross-fade over the ``overlap`` frames (weight 1 -> 0
    on ``prev``), for any trailing shape."""
    w = np.linspace(1.0, 0.0, overlap).reshape((overlap,) + (1,) * (prev.ndim - 1))
    blended = prev[-overlap:] * w + curr[:overlap] * (1.0 - w)
    return np.concatenate([prev[:-overlap], blended, curr[overlap:]])


def stitch_poses(prev: np.ndarray, curr: np.ndarray, overlap: int) -> np.ndarray:
    """Pose variant of :func:`stitch_overlap`: batched SLERP + translation lerp
    on the overlap."""
    weights = np.linspace(1.0, 0.0, overlap)
    blended = interpolate_poses_batch(prev[-overlap:], curr[:overlap], weights)
    return np.concatenate([prev[:-overlap], blended, curr[overlap:]])


def get_window_starts(total_frames: int, sliding_window_size: int,
                      temporal_stride: int) -> List[int]:
    """Window start indices covering [0, total_frames) with a tail window; a
    video no longer than one window gets [0]."""
    if total_frames <= sliding_window_size:
        return [0]
    starts = list(range(0, total_frames - sliding_window_size + 1, temporal_stride))
    if (total_frames - sliding_window_size) % temporal_stride != 0:
        starts.append(total_frames - sliding_window_size)
    return starts


def fit_num_frames(total_frames: int, requested: int, allowed=(17, 25, 33, 41)) -> int:
    """Largest allowed window <= min(requested, video length)."""
    usable = [n for n in allowed if n <= min(requested, total_frames)]
    if not usable:
        raise ValueError(
            f"video too short: {total_frames} frames < the smallest "
            f"supported window ({min(allowed)})")
    return max(usable)


def run_windowed_reconstruction(
    pipeline,
    video: np.ndarray,
    raymap: Optional[np.ndarray] = None,
    height: int = 480,
    width: int = 720,
    num_frames: int = 41,
    fps: int = 12,
    num_inference_steps: Optional[int] = None,
    stride: int = 24,
    seed: int = 42,
    batch_windows: int = 1,
    progress=None,
) -> Tuple[list, List[int], int]:
    """Sliding-window reconstruction driver (the demo's and the server's).

    Runs every window with ``defer_host`` pipelining: window i+1's work is
    queued before window i's device->host transfer is resolved. With
    ``batch_windows > 1`` and no raymap, ``batch_windows`` windows at a time
    go through :meth:`AetherPipeline.batch_reconstruct` (one batched denoise
    a chunk). Every window uses the same seed, as the reference does. The
    stages are named ``dispatch@<start>`` (``dispatch@<start>x<n>`` for a
    chunk) and ``resolve@<start>``, because under deferral neither alone is
    a window's latency. ``progress(done, total)`` is called as windows are
    dispatched. Returns ``(window_results, window_indices, num_frames)`` with
    ``num_frames`` shrunk to the largest allowed window that fits the clip
    (JAX ``run_windowed_reconstruction``)."""
    num_frames = fit_num_frames(len(video), num_frames, pipeline.config.allowed_num_frames)
    window_indices = get_window_starts(len(video), num_frames, stride)
    n = len(window_indices)
    results: list = []
    deferred = prev = None

    def resolve(batched: bool):
        with stage_timer(f"resolve@{prev}", log=False):
            out = deferred.resolve()
        results.extend(out if batched else [out])

    if batch_windows > 1 and raymap is None:
        for i in range(0, n, batch_windows):
            chunk = window_indices[i:i + batch_windows]
            if progress is not None:
                progress(i, n)
            stacked = np.stack([video[s:s + num_frames] for s in chunk])
            with torch.profiler.record_function(f"aether.windows@{chunk[0]}x{len(chunk)}"), \
                    stage_timer(f"dispatch@{chunk[0]}x{len(chunk)}", log=False):
                out = pipeline.batch_reconstruct(
                    stacked, height=height, width=width, num_frames=num_frames,
                    num_inference_steps=num_inference_steps or 4, fps=fps, seed=seed,
                    defer_host=True)
            if deferred is not None:
                resolve(True)
            deferred, prev = out, chunk[0]
        if deferred is not None:
            resolve(True)
    else:
        for j, start in enumerate(window_indices):
            if progress is not None:
                progress(j, n)
            with torch.profiler.record_function(f"aether.window@{start}"), \
                    stage_timer(f"dispatch@{start}", log=False):
                out = pipeline(
                    task="reconstruction", video=video[start:start + num_frames],
                    raymap=(raymap[start:start + num_frames]
                            if raymap is not None else None),
                    height=height, width=width, num_frames=num_frames, fps=fps,
                    num_inference_steps=num_inference_steps, guidance_scale=1.0,
                    use_dynamic_cfg=False, seed=seed, defer_host=True)
            if deferred is not None:
                resolve(False)
            deferred, prev = out, start
        if deferred is not None:
            resolve(False)
    return results, window_indices, num_frames


def blend_and_merge_window_results(
    window_results: Sequence,
    window_indices: Sequence[int],
    height: int,
    width: int,
    smooth_camera: bool = True,
    smooth_method: str = "kalman",
    align_pointmaps: bool = False,
    ray_o_scale_inv: float = 0.1,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Merge per-window (rgb, disparity, raymap) outputs into full-video
    results: (rgb (T,H,W,3), disparity (T,H,W), poses (T,4,4), pointmaps
    (T,H,W,3)). ``device`` runs the whole-clip unprojection (the CPU when
    None); the blending itself is host float64."""
    first = window_results[0]
    merged_rgb = np.asarray(first.rgb, dtype=np.float64)
    merged_disparity = np.asarray(first.disparity, dtype=np.float64)
    pd = postprocess_pointmap(
        np.asarray(first.disparity), np.asarray(first.raymap), vae_downsample_scale=8,
        ray_o_scale_inv=ray_o_scale_inv, smooth_camera=smooth_camera,
        smooth_method=smooth_method if smooth_camera else "none")
    merged_poses = np.asarray(pd["camera_pose"], dtype=np.float64)
    merged_focals = np.asarray(
        (pd["intrinsics"][:, 0, 0] + pd["intrinsics"][:, 1, 1]) / 2, dtype=np.float64)
    merged_pointmaps = (np.asarray(pd["pointmap"], dtype=np.float64)
                        if align_pointmaps else None)

    for idx in range(1, len(window_results)):
        result, t_start = window_results[idx], window_indices[idx]
        rgb = np.asarray(result.rgb)
        disparity = np.asarray(result.disparity)
        raymap = np.asarray(result.raymap)
        h, w = disparity.shape[1:]
        overlap_t = window_indices[idx - 1] + rgb.shape[0] - t_start

        # disparity: least-squares scale on the overlap, then cross-fade
        disp_mask = disparity[:overlap_t].reshape(1, -1, w) > 0.1
        scale = compute_scale(disparity[:overlap_t].reshape(1, -1, w),
                              merged_disparity[-overlap_t:].reshape(1, -1, w), disp_mask)
        merged_disparity = stitch_overlap(merged_disparity, scale * disparity, overlap_t)

        merged_rgb = stitch_overlap(merged_rgb, rgb, overlap_t)

        # poses: similarity-align on the overlap, SLERP in the overlap
        window_poses, window_fov_x, window_fov_y = raymap_to_poses(
            raymap, ray_o_scale_inv=ray_o_scale_inv)
        window_poses = window_poses.numpy()
        rel_r, rel_t, rel_s = align_camera_extrinsics(window_poses[:overlap_t],
                                                      merged_poses[-overlap_t:])
        aligned_window_poses = poses_to_extrinsics(
            apply_transformation(window_poses, rel_r, rel_t, rel_s))
        merged_poses = stitch_poses(merged_poses, aligned_window_poses, overlap_t)

        # focals: ratio-align then lerp
        window_intrinsics, _ = get_intrinsics(batch_size=window_poses.shape[0], h=h, w=w,
                                              fovx=window_fov_x, fovy=window_fov_y)
        window_intrinsics = window_intrinsics.numpy()
        window_focals = (window_intrinsics[:, 0, 0] + window_intrinsics[:, 1, 1]) / 2
        fscale = (merged_focals[-overlap_t:] / window_focals[:overlap_t]).mean()
        window_focals = fscale * window_focals
        merged_focals = stitch_overlap(merged_focals, window_focals, overlap_t)

        if align_pointmaps:
            window_pm = postprocess_pointmap(
                merged_disparity[t_start:], raymap, vae_downsample_scale=8,
                camera_pose=aligned_window_poses, focal=window_focals,
                ray_o_scale_inv=ray_o_scale_inv, smooth_camera=smooth_camera,
                smooth_method=smooth_method if smooth_camera else "none")
            merged_pointmaps = stitch_overlap(merged_pointmaps, window_pm["pointmap"],
                                              overlap_t)

    if align_pointmaps:
        pointmaps = merged_pointmaps
    else:
        # one batched unprojection of the whole clip
        n = merged_poses.shape[0]
        ks = np.zeros((n, 3, 3), np.float32)
        ks[:, 0, 0] = merged_focals
        ks[:, 1, 1] = merged_focals
        ks[:, 0, 2] = 0.5 * width
        ks[:, 1, 2] = 0.5 * height
        ks[:, 2, 2] = 1.0
        depth = (1.0 / np.clip(merged_disparity, 1e-8, 1e8)).astype(np.float32)
        dev = torch.device(device) if device is not None else torch.device("cpu")
        pointmaps = project(torch.from_numpy(depth).to(dev), torch.from_numpy(ks).to(dev),
                            torch.from_numpy(merged_poses.astype(np.float32)).to(dev)
                            ).cpu().numpy()
    return merged_rgb, merged_disparity, merged_poses, pointmaps

"""Video-depth metric core: alignment modes + AbsRel/RMSE/delta metrics.

Capability parity with reference ``evaluation/video_depth/tools.py:179-464``
(``depth_evaluation``). Alignment modes (mutually exclusive, selected by the
``align`` argument — the reference uses boolean flags):

- ``"median"``  (default): scale = median(gt) / median(pred)   (``tools.py:335-338``)
- ``"lstsq"``:   closed-form scale+shift least squares          (``tools.py:265-282``)
- ``"lad"``:     L1 scale+shift via scipy minimize              (``tools.py:53-66``)
- ``"lad2"``:    L1 scale+shift via Adam — the reference runs torch Adam on GPU
                 (``tools.py:69-120``); here a ``torch.optim.Adam`` loop on
                 the ``device`` argument, with the JAX ``_lad2_device``'s
                 start, constants and stopping rule
- ``"scale"``:   scale-only Weiszfeld iteration (10 steps)      (``tools.py:302-333``)
- ``"metric"``:  no alignment                                   (``tools.py:264``)

Metrics: AbsRel, SqRel, RMSE, LogRMSE, delta < 1.25^{0,1,2,3} over the masked
pixels (gt > 0, gt < max_depth, optional edge mask / custom mask), plus the
per-pixel relative-error parity map on the full frame.

Port of ``aether_tpu/eval/depth_metrics.py``: everything but LAD2 is a copy
(numpy and scipy).
"""

from __future__ import annotations

import math
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def group_by_directory(paths, idx: int = -1) -> Dict[str, List[str]]:
    """Group file paths by a directory component (reference ``tools.py:11-29``)."""
    grouped = defaultdict(list)
    for path in paths:
        dir_name = os.path.dirname(path).split("/")[idx]
        grouped[dir_name].append(path)
    return dict(grouped)


def depth2disparity(depth: np.ndarray, return_mask: bool = False):
    disparity = np.zeros_like(depth)
    valid = depth > 0
    disparity[valid] = 1.0 / depth[valid]
    return (disparity, valid) if return_mask else disparity


# ---------------------------------------------------------------------------
# alignment solvers
# ---------------------------------------------------------------------------


def _align_lstsq(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    a = np.stack([pred, np.ones_like(pred)], axis=1)
    (s, t), *_ = np.linalg.lstsq(a, gt, rcond=None)
    return float(s), float(t)


def _align_lad(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    from scipy.optimize import minimize

    s0 = float(np.median(gt) / np.median(pred))

    def loss(params):
        s, t = params
        return np.abs(s * pred + t - gt).sum()

    res = minimize(loss, [s0, 0.0])
    return float(res.x[0]), float(res.x[1])


def _lad2_device(pred: torch.Tensor, gt: torch.Tensor, s_init: float, lr: float = 1e-4,
                 max_iters: int = 1000, tol: float = 1e-6):
    """Adam-optimized L1 scale/shift on ``pred``'s device (reference
    ``tools.py:69-120``; JAX ``_lad2_device``): from s = ``s_init``, t = 0,
    Adam at ``lr`` (betas 0.9 / 0.999, eps 1e-8, optax's defaults) on
    sum |s * pred + t - gt|, until ``max_iters`` steps or two successive
    losses within ``tol``. The first check compares +inf with -inf, so at
    least one step is taken. Returns (s, t) as floats."""
    s = torch.full((1,), s_init, dtype=torch.float32, device=pred.device, requires_grad=True)
    t = torch.zeros((1,), dtype=torch.float32, device=pred.device, requires_grad=True)
    opt = torch.optim.Adam([s, t], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    prev, loss, it = math.inf, -math.inf, 0
    with torch.enable_grad():  # also under a caller's no_grad
        while it < max_iters and abs(prev - loss) >= tol:
            opt.zero_grad()
            new_loss = (s * pred + t - gt).abs().sum()
            new_loss.backward()
            opt.step()
            prev, loss, it = loss, new_loss.item(), it + 1
    return s.item(), t.item()


def _align_lad2(pred: np.ndarray, gt: np.ndarray, lr: float, max_iters: int,
                device=None) -> Tuple[float, float]:
    s_init = float(np.median(gt) / np.median(pred))
    dev = torch.device(device) if device is not None else torch.device("cpu")
    return _lad2_device(torch.as_tensor(pred, dtype=torch.float32, device=dev),
                        torch.as_tensor(gt, dtype=torch.float32, device=dev), s_init,
                        lr=lr, max_iters=max_iters)


def _align_weiszfeld(pred: np.ndarray, gt: np.ndarray) -> float:
    s = float(np.nanmean(gt) / np.nanmean(pred))
    for _ in range(10):
        residual = np.abs(s * pred - gt) + 1e-8
        weights = 1.0 / residual
        s = float((weights * pred * gt).sum() / (weights * pred * pred).sum())
    return max(s, 1e-3)


# ---------------------------------------------------------------------------
# metric core
# ---------------------------------------------------------------------------


def depth_evaluation(
    predicted_depth: np.ndarray,
    ground_truth_depth: np.ndarray,
    max_depth: Optional[float] = 80.0,
    custom_mask: Optional[np.ndarray] = None,
    post_clip_min: Optional[float] = None,
    post_clip_max: Optional[float] = None,
    pre_clip_min: Optional[float] = None,
    pre_clip_max: Optional[float] = None,
    align: str = "median",
    lr: float = 1e-4,
    max_iters: int = 1000,
    disp_input: bool = False,
    mask_edge: bool = False,
    device=None,
) -> Tuple[Dict[str, float], np.ndarray, np.ndarray, np.ndarray]:
    """Evaluate a predicted depth (or disparity) video against GT.

    Returns (metrics dict incl. valid_pixels, error-parity map, aligned pred
    map, masked gt map) — same contract as reference ``depth_evaluation``.
    ``device`` runs LAD2's Adam loop (the CPU when None).
    """
    if align not in ("median", "lstsq", "lad", "lad2", "scale", "metric"):
        raise ValueError(f"unknown alignment mode: {align!r}")

    pred_full = np.asarray(predicted_depth, np.float64).copy()
    gt_full = np.asarray(ground_truth_depth, np.float64)
    if custom_mask is not None:
        custom_mask = np.asarray(custom_mask).astype(bool)

    if pred_full.ndim == 3:  # flatten video along the frame axis like the ref
        _, h, w = pred_full.shape
        pred_full = pred_full.reshape(-1, w)
        gt_full = gt_full.reshape(-1, w)
        if custom_mask is not None:
            custom_mask = custom_mask.reshape(-1, w)

    mask = gt_full > 0
    if max_depth is not None:
        mask &= gt_full < max_depth
    if mask_edge:
        from aether_tpu_torch.geometry.edges import depth_edge

        mask &= ~np.asarray(depth_edge(gt_full[None], rtol=0.03))[0]

    pred = pred_full[mask]
    gt = gt_full[mask]

    if pred.size == 0:
        zeros = {k: 0.0 for k in ("Abs Rel", "Sq Rel", "RMSE", "Log RMSE",
                                  "δ < 1.", "δ < 1.25", "δ < 1.25^2",
                                  "δ < 1.25^3")}
        zeros["valid_pixels"] = 0
        return zeros, np.zeros_like(gt_full), pred_full, np.zeros_like(gt_full)

    if pre_clip_min is not None:
        pred = np.clip(pred, a_min=pre_clip_min, a_max=None)
    if pre_clip_max is not None:
        pred = np.clip(pred, a_min=None, a_max=pre_clip_max)

    if disp_input:  # align pred to gt in disparity space
        real_gt = gt.copy()
        gt = 1.0 / (gt + 1e-8)

    s, t = 1.0, 0.0
    if align == "metric":
        pass
    elif align == "lstsq":
        s, t = _align_lstsq(pred, gt)
    elif align == "lad":
        s, t = _align_lad(pred, gt)
    elif align == "lad2":
        s, t = _align_lad2(pred, gt, lr=lr, max_iters=max_iters, device=device)
    elif align == "scale":
        s = _align_weiszfeld(pred, gt)
    else:  # median
        s = float(np.median(gt) / np.median(pred))
    pred = s * pred + t

    if disp_input:
        gt = real_gt
        pred = depth2disparity(pred)

    if post_clip_min is not None:
        pred = np.clip(pred, a_min=post_clip_min, a_max=None)
    if post_clip_max is not None:
        pred = np.clip(pred, a_min=None, a_max=post_clip_max)

    if custom_mask is not None:
        assert custom_mask.shape == gt_full.shape
        inner = custom_mask[mask]
        pred = pred[inner]
        gt = gt[inner]

    num_valid = int(pred.size)
    if num_valid == 0:
        zeros = {k: 0.0 for k in ("Abs Rel", "Sq Rel", "RMSE", "Log RMSE",
                                  "δ < 1.", "δ < 1.25", "δ < 1.25^2",
                                  "δ < 1.25^3")}
        zeros["valid_pixels"] = 0
        return zeros, np.zeros_like(gt_full), pred_full, np.zeros_like(gt_full)

    abs_rel = float(np.mean(np.abs(pred - gt) / gt))
    sq_rel = float(np.mean((pred - gt) ** 2 / gt))
    rmse = float(np.sqrt(np.mean((pred - gt) ** 2)))
    pred_log = np.clip(pred, 1e-5, None)
    log_rmse = float(np.sqrt(np.mean((np.log(pred_log) - np.log(gt)) ** 2)))
    max_ratio = np.maximum(pred_log / gt, gt / pred_log)
    deltas = [float(np.mean(max_ratio < 1.25**k)) for k in (0, 1, 2, 3)]

    aligned_full = pred_full * s + t
    if disp_input:
        aligned_full = depth2disparity(aligned_full)
    parity = np.where(
        mask, np.abs(aligned_full - gt_full) / np.where(mask, gt_full, 1.0), 0.0
    )
    gt_masked = np.where(mask, gt_full, 0.0)

    results = {
        "Abs Rel": abs_rel,
        "Sq Rel": sq_rel,
        "RMSE": rmse,
        "Log RMSE": log_rmse,
        "δ < 1.": deltas[0],
        "δ < 1.25": deltas[1],
        "δ < 1.25^2": deltas[2],
        "δ < 1.25^3": deltas[3],
        "valid_pixels": num_valid,
    }
    return results, parity, aligned_full, gt_masked


def weighted_average_metrics(
    per_seq_metrics: List[Dict[str, float]]
) -> Dict[str, float]:
    """Aggregate per-sequence metric dicts weighted by valid_pixels
    (reference ``eval_depth.py:228-237``)."""
    if not per_seq_metrics:
        return {}
    weights = np.array([m["valid_pixels"] for m in per_seq_metrics], np.float64)
    total = weights.sum()
    if total <= 0:
        weights = np.ones_like(weights)
        total = weights.sum()
    keys = [k for k in per_seq_metrics[0] if k != "valid_pixels"]
    out = {
        k: float(sum(m[k] * w for m, w in zip(per_seq_metrics, weights)) / total)
        for k in keys
    }
    out["valid_pixels"] = float(total)
    return out

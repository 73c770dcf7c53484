"""Evaluation harness: video-depth and relative-pose benchmarks (reference L5).

Port of ``aether_tpu/eval``, exporting the same names: the 2-D sliding-window
inference drivers over the port's pipeline (``video_depth``, ``rel_pose``),
the GT readers (``datasets``), the depth alignment modes and metrics
(``depth_metrics``; LAD2 as a ``torch.optim.Adam`` loop on a device), the
ATE / RPE pose metrics (``pose_metrics``) and the host-side work sharding
(``sharding``).
"""

from aether_tpu_torch.eval.depth_metrics import depth_evaluation, group_by_directory
from aether_tpu_torch.eval.pose_metrics import (
    ate_rmse,
    eval_metrics,
    load_tum_file,
    rpe,
    save_tum_poses,
)
from aether_tpu_torch.eval.sharding import shard_sequences

__all__ = [
    "depth_evaluation",
    "group_by_directory",
    "ate_rmse",
    "rpe",
    "eval_metrics",
    "load_tum_file",
    "save_tum_poses",
    "shard_sequences",
]

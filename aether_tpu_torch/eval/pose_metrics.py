"""Camera-trajectory metrics: ATE and RPE, plus TUM-format IO.

Capability parity with reference ``evaluation/rel_pose/evo_utils.py:162-246``
and ``evaluation/rel_pose/utils.py:50-90`` — the reference delegates to the
``evo`` package (not available here); the same statistics are computed
directly:

- **ATE**: RMSE of translation errors after Umeyama similarity alignment
  (rotation + translation + scale), matching evo ``main_ape.ape(...,
  translation_part, align=True, correct_scale=True)``.
- **RPE (rot / trans)**: relative-pose error at frame delta 1 over all
  consecutive pairs of the aligned trajectories, rotation part reported as
  angle in degrees, translation part as the error-norm; RMSE over pairs —
  matching evo ``main_rpe.rpe(..., delta=1, delta_unit=frames, all_pairs)``.

Trajectories are (poses_tum (N, 7) [x y z qx qy qz qw], timestamps (N,))
tuples — the TUM-RGBD convention the reference uses throughout.

Copy of ``aether_tpu/eval/pose_metrics.py`` (numpy and scipy; matplotlib is
imported only to plot).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

Trajectory = Tuple[np.ndarray, np.ndarray]  # ((N, 7) xyz+quat_xyzw, (N,) stamps)


# ---------------------------------------------------------------------------
# conversions / IO
# ---------------------------------------------------------------------------


def c2w_to_tumpose(c2w: np.ndarray) -> np.ndarray:
    """4x4 camera-to-world -> TUM row [x y z qx qy qz qw]
    (reference ``rel_pose/utils.py:50-63``)."""
    xyz = c2w[:3, 3]
    quat = Rotation.from_matrix(c2w[:3, :3]).as_quat()  # scalar-last
    return np.concatenate([xyz, quat])


def tumpose_to_c2w(row: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = Rotation.from_quat(row[3:7]).as_matrix()
    out[:3, 3] = row[:3]
    return out


def poses_to_traj(poses: np.ndarray,
                  timestamps: Optional[np.ndarray] = None) -> Trajectory:
    """(N, 4, 4) c2w poses -> trajectory tuple."""
    tum = np.stack([c2w_to_tumpose(p) for p in np.asarray(poses)])
    if timestamps is None:
        timestamps = np.arange(len(tum), dtype=np.float64)
    return tum, np.asarray(timestamps, np.float64)


def save_tum_poses(poses: np.ndarray, path: str,
                   timestamps: Optional[np.ndarray] = None) -> Trajectory:
    """Write (N, 4, 4) poses as a TUM trajectory file
    (reference ``rel_pose/utils.py:66-80``)."""
    traj, stamps = poses_to_traj(poses, timestamps)
    with open(path, "w") as f:
        for t, row in zip(stamps, traj):
            f.write(" ".join(f"{v:.9g}" for v in (t, *row)) + "\n")
    return traj, stamps


def load_tum_file(path: str) -> Trajectory:
    """Read a TUM trajectory file: `stamp x y z qx qy qz qw` per line."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            rows.append(vals[:8])
    arr = np.asarray(rows, np.float64)
    return arr[:, 1:8], arr[:, 0]


def save_focals(focals: np.ndarray, path: str) -> None:
    np.savetxt(path, np.asarray(focals).reshape(-1), fmt="%.9g")


def associate_trajectories(
    ref: Trajectory, est: Trajectory, max_diff: float = 0.01
) -> Tuple[Trajectory, Trajectory]:
    """Match est poses to ref poses by nearest timestamp (evo ``sync``)."""
    ref_traj, ref_t = ref
    est_traj, est_t = est
    if len(ref_t) == len(est_t):
        return ref, est
    ref_idx, est_idx = [], []
    used = set()
    for i, t in enumerate(ref_t):
        j = int(np.argmin(np.abs(est_t - t)))
        if j in used:
            continue
        if np.abs(est_t[j] - t) <= max_diff * max(1.0, np.abs(t)):
            ref_idx.append(i)
            est_idx.append(j)
            used.add(j)
    ref_idx, est_idx = np.asarray(ref_idx, int), np.asarray(est_idx, int)
    return ((ref_traj[ref_idx], ref_t[ref_idx]),
            (est_traj[est_idx], est_t[est_idx]))


# ---------------------------------------------------------------------------
# alignment + metrics
# ---------------------------------------------------------------------------


def umeyama(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Similarity transform (R, t, s) minimizing ||s R src + t - dst||^2."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_src = src.mean(axis=0)
    mu_dst = dst.mean(axis=0)
    x = src - mu_src
    y = dst - mu_dst
    cov = y.T @ x / len(src)
    u, d, vt = np.linalg.svd(cov)
    sgn = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        sgn[2, 2] = -1.0
    rot = u @ sgn @ vt
    if with_scale:
        var_src = (x**2).sum() / len(src)
        scale = float(np.trace(np.diag(d) @ sgn) / max(var_src, 1e-16))
    else:
        scale = 1.0
    trans = mu_dst - scale * rot @ mu_src
    return rot, trans, scale


def _aligned_se3(est: Trajectory, ref: Trajectory,
                 correct_scale: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Umeyama-align est to ref; return (est_se3 (N,4,4), ref_se3 (N,4,4))."""
    est_traj, _ = est
    ref_traj, _ = ref
    n = min(len(est_traj), len(ref_traj))
    est_traj, ref_traj = est_traj[:n], ref_traj[:n]
    rot, trans, scale = umeyama(est_traj[:, :3], ref_traj[:, :3],
                                with_scale=correct_scale)
    est_se3 = np.stack([tumpose_to_c2w(r) for r in est_traj])
    ref_se3 = np.stack([tumpose_to_c2w(r) for r in ref_traj])
    aligned = est_se3.copy()
    aligned[:, :3, 3] = (scale * (rot @ est_se3[:, :3, 3].T)).T + trans
    aligned[:, :3, :3] = rot @ est_se3[:, :3, :3]
    return aligned, ref_se3


def ate_rmse(est: Trajectory, ref: Trajectory,
             correct_scale: bool = True) -> float:
    """Absolute trajectory error: translation RMSE after similarity alignment."""
    aligned, ref_se3 = _aligned_se3(est, ref, correct_scale)
    err = aligned[:, :3, 3] - ref_se3[:, :3, 3]
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe(
    est: Trajectory,
    ref: Trajectory,
    delta: int = 1,
    rotation: bool = False,
    correct_scale: bool = True,
) -> float:
    """Relative-pose error RMSE at frame delta (all pairs).

    E_i = (Q_i^-1 Q_{i+d})^-1 (P_i^-1 P_{i+d}); rotation errors in degrees.
    """
    aligned, ref_se3 = _aligned_se3(est, ref, correct_scale)
    n = len(aligned)
    if n <= delta:
        return 0.0
    errs = []
    for i in range(n - delta):
        rel_est = np.linalg.inv(aligned[i]) @ aligned[i + delta]
        rel_ref = np.linalg.inv(ref_se3[i]) @ ref_se3[i + delta]
        e = np.linalg.inv(rel_ref) @ rel_est
        if rotation:
            angle = Rotation.from_matrix(e[:3, :3]).magnitude()
            errs.append(np.degrees(angle))
        else:
            errs.append(np.linalg.norm(e[:3, 3]))
    errs = np.asarray(errs)
    return float(np.sqrt((errs**2).mean()))


def eval_metrics(
    pred_traj: Trajectory,
    gt_traj: Optional[Trajectory] = None,
    seq: str = "",
    filename: str = "",
    sample_stride: int = 1,
) -> Tuple[float, float, float]:
    """ATE + RPE-trans + RPE-rot, written to a per-sequence metric file.

    Same contract as reference ``evo_utils.py:162-246`` (delta=1 frame).
    """
    pred_traj = (np.asarray(pred_traj[0]), np.asarray(pred_traj[1]).reshape(-1))
    if sample_stride > 1:
        pred_traj = (pred_traj[0][::sample_stride], pred_traj[1][::sample_stride])
        if gt_traj is not None:
            gt_traj = (gt_traj[0][::sample_stride], gt_traj[1][::sample_stride])

    if gt_traj is None:
        return 0.0, 0.0, 0.0
    gt_traj = (np.asarray(gt_traj[0]), np.asarray(gt_traj[1]).reshape(-1))

    if len(pred_traj[1]) == len(gt_traj[1]):
        pred_traj = (pred_traj[0], gt_traj[1])
    else:
        gt_traj, pred_traj = associate_trajectories(gt_traj, pred_traj)

    ate = ate_rmse(pred_traj, gt_traj)
    rpe_trans = rpe(pred_traj, gt_traj, delta=1, rotation=False)
    rpe_rot = rpe(pred_traj, gt_traj, delta=1, rotation=True)

    if filename:
        with open(filename, "w") as f:
            f.write(f"Seq: {seq} \n\n")
            f.write(f"ATE rmse: {ate:.8f}\n")
            f.write(f"RPE trans rmse: {rpe_trans:.8f}\n")
            f.write(f"RPE rot rmse: {rpe_rot:.8f} deg\n")
    return ate, rpe_trans, rpe_rot


# ---------------------------------------------------------------------------
# aggregation over per-sequence metric files (reference evo_utils.py:376-427)
# ---------------------------------------------------------------------------

_METRIC_RE = {
    "ATE": re.compile(r"ATE rmse:\s*([0-9.eE+-]+)"),
    "RPE trans": re.compile(r"RPE trans rmse:\s*([0-9.eE+-]+)"),
    "RPE rot": re.compile(r"RPE rot rmse:\s*([0-9.eE+-]+)"),
}


def extract_metrics(path: str) -> Dict[str, float]:
    with open(path) as f:
        text = f.read()
    out = {}
    for key, pattern in _METRIC_RE.items():
        m = pattern.search(text)
        if m:
            out[key] = float(m.group(1))
    return out


def process_directory(directory: str,
                      pattern: str = "eval_metric.txt") -> List[Dict[str, float]]:
    results = []
    for root, _dirs, files in sorted(os.walk(directory)):
        for name in sorted(files):
            if name.endswith(pattern):
                metrics = extract_metrics(os.path.join(root, name))
                if metrics:
                    metrics["seq"] = os.path.basename(root)
                    results.append(metrics)
    return results


def calculate_averages(results: List[Dict[str, float]]) -> Dict[str, float]:
    if not results:
        return {}
    keys = [k for k in results[0] if k != "seq"]
    return {k: float(np.mean([r[k] for r in results if k in r])) for k in keys}


# ---------------------------------------------------------------------------
# plotting (optional; matplotlib Agg)
# ---------------------------------------------------------------------------


def plot_trajectory(
    pred_traj: Trajectory,
    gt_traj: Optional[Trajectory] = None,
    title: str = "",
    filename: str = "trajectory.png",
    align: bool = True,
    correct_scale: bool = True,
) -> None:
    """Top-down (x, y) trajectory plot (reference ``evo_utils.py:331-359``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    if gt_traj is not None:
        ax.plot(gt_traj[0][:, 0], gt_traj[0][:, 1], "k-", label="Ground Truth")
        if align:
            aligned, _ = _aligned_se3(pred_traj, gt_traj, correct_scale)
            ax.plot(aligned[:, 0, 3], aligned[:, 1, 3], "b-", label="Predicted")
        else:
            ax.plot(pred_traj[0][:, 0], pred_traj[0][:, 1], "b-",
                    label="Predicted")
    else:
        ax.plot(pred_traj[0][:, 0], pred_traj[0][:, 1], "b-", label="Predicted")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_title(title)
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    fig.savefig(filename, dpi=90, bbox_inches="tight")
    plt.close(fig)

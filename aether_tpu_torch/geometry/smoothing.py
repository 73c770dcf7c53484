"""Temporal pose smoothing (host-side, cold path).

Semantics match reference ``aether/utils/postprocess_utils.py``:
- ``slerp`` / ``interpolate_poses``   (:610-683)
- ``smooth_poses``                    (:686-748) gaussian / savgol / moving-average
- ``smooth_trajectory``               (:751-844) const-velocity Kalman filter on
  translations + gaussian-weighted quaternion window on rotations. The reference
  depends on ``filterpy``; the filter here is a self-contained numpy implementation
  of the same predict/update equations with filterpy's default initialization
  (R = 0.1*I3, Q = 0.1*I6, P = I6).
- ``detect_static_sequence`` / ``adaptive_pose_smoothing`` (:354-378)

Copy of ``aether_tpu/geometry/smoothing.py`` (numpy/scipy, float64).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.ndimage import gaussian_filter1d
from scipy.signal import savgol_filter
from scipy.spatial.transform import Rotation as R


def slerp(q1: np.ndarray, q2: np.ndarray, t: float) -> np.ndarray:
    """Spherical linear interpolation between two quaternions (4,)."""
    dot = float(np.sum(q1 * q2))
    if dot < 0.0:
        q2 = -q2
        dot = -dot

    if dot > 0.9995:
        result = q1 + t * (q2 - q1)
        return result / np.linalg.norm(result)

    theta_0 = np.arccos(dot)
    sin_theta_0 = np.sin(theta_0)
    theta = theta_0 * t
    sin_theta = np.sin(theta)
    s0 = np.cos(theta) - dot * sin_theta / sin_theta_0
    s1 = sin_theta / sin_theta_0
    return s0 * q1 + s1 * q2


def interpolate_poses(pose1: np.ndarray, pose2: np.ndarray, weight: float) -> np.ndarray:
    """SLERP rotations + lerp translations; ``weight`` is the weight of pose1."""
    from aether_tpu_torch.geometry.alignment import project_to_so3

    q1 = R.from_matrix(project_to_so3(pose1[:3, :3])).as_quat()
    q2 = R.from_matrix(project_to_so3(pose2[:3, :3])).as_quat()
    q_interp = slerp(q1, q2, 1.0 - weight)
    t_interp = weight * pose1[:3, 3] + (1.0 - weight) * pose2[:3, 3]

    out = np.eye(4)
    out[:3, :3] = R.from_quat(q_interp).as_matrix()
    out[:3, 3] = t_interp
    return out


def interpolate_poses_batch(
    poses1: np.ndarray, poses2: np.ndarray, weights: np.ndarray
) -> np.ndarray:
    """Vectorized :func:`interpolate_poses` over T pose pairs.

    (T, 4, 4) x (T, 4, 4) x (T,) -> (T, 4, 4); ``weights[t]`` is the weight
    of ``poses1[t]``. Elementwise-identical math to the scalar function
    (batched SVD projection to SO(3), hemisphere-fixed quaternion SLERP with
    the same 0.9995 lerp fallback, translation lerp) — one LAPACK/vector
    call per stage instead of a Python loop per frame, which is what makes
    window blending O(1) dispatches per overlap (VERDICT r2 item 5).
    """
    poses1 = np.asarray(poses1, np.float64)
    poses2 = np.asarray(poses2, np.float64)
    w = np.asarray(weights, np.float64)

    def so3_batch(rs):
        bad = ~np.isfinite(rs).all(axis=(1, 2))
        safe = np.where(bad[:, None, None], np.eye(3), rs)
        u, _, vt = np.linalg.svd(safe)
        d = np.sign(np.linalg.det(u @ vt))
        d = np.where(d == 0, 1.0, d)
        diag = np.zeros_like(safe)
        diag[:, 0, 0] = 1.0
        diag[:, 1, 1] = 1.0
        diag[:, 2, 2] = d
        out = u @ diag @ vt
        out[bad] = np.eye(3)
        return out

    q1 = R.from_matrix(so3_batch(poses1[:, :3, :3])).as_quat().reshape(-1, 4)
    q2 = R.from_matrix(so3_batch(poses2[:, :3, :3])).as_quat().reshape(-1, 4)
    t = 1.0 - w
    dot = np.sum(q1 * q2, axis=-1)
    q2 = np.where(dot[:, None] < 0.0, -q2, q2)
    dot = np.abs(np.where(dot < 0.0, -dot, dot))

    lerped = q1 + t[:, None] * (q2 - q1)
    lerped = lerped / np.linalg.norm(lerped, axis=-1, keepdims=True)

    use_lerp = dot > 0.9995
    theta0 = np.arccos(np.where(use_lerp, 0.0, dot))  # arccos sees dot<=0.9995
    sin_theta0 = np.where(use_lerp, 1.0, np.sin(theta0))
    theta = theta0 * t
    s0 = np.cos(theta) - dot * np.sin(theta) / sin_theta0
    s1 = np.sin(theta) / sin_theta0
    slerped = s0[:, None] * q1 + s1[:, None] * q2

    q = np.where(use_lerp[:, None], lerped, slerped)
    out = np.broadcast_to(np.eye(4), poses1.shape).copy()
    out[:, :3, :3] = R.from_quat(q).as_matrix()
    out[:, :3, 3] = w[:, None] * poses1[:, :3, 3] + t[:, None] * poses2[:, :3, 3]
    return out


def _extract_quats(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    translations = poses[:, :3, 3].copy()
    quats = R.from_matrix(poses[:, :3, :3]).as_quat()
    for i in range(1, len(quats)):  # hemisphere-consistent signs
        if np.dot(quats[i], quats[i - 1]) < 0:
            quats[i] = -quats[i]
    return translations, quats


def smooth_poses(
    poses: np.ndarray, window_size: int = 5, method: str = "gaussian"
) -> np.ndarray:
    """Smooth (N, 4, 4) poses temporally on quaternions + translations."""
    assert window_size % 2 == 1, "window_size must be odd"
    n = poses.shape[0]
    translations, quats = _extract_quats(poses)

    if method == "gaussian":
        sigma = window_size / 6.0
        smoothed_trans = gaussian_filter1d(translations, sigma, axis=0, mode="nearest")
        smoothed_quats = gaussian_filter1d(quats, sigma, axis=0, mode="nearest")
    elif method == "savgol":
        poly_order = min(window_size - 1, 3)
        smoothed_trans = savgol_filter(
            translations, window_size, poly_order, axis=0, mode="nearest"
        )
        smoothed_quats = savgol_filter(
            quats, window_size, poly_order, axis=0, mode="nearest"
        )
    elif method == "ma":
        kernel = np.ones(window_size) / window_size
        smoothed_trans = np.stack(
            [np.convolve(translations[:, i], kernel, mode="same") for i in range(3)],
            axis=1,
        )
        smoothed_quats = np.stack(
            [np.convolve(quats[:, i], kernel, mode="same") for i in range(4)], axis=1
        )
    else:
        raise ValueError(f"Unknown smoothing method: {method}")

    smoothed_quats = smoothed_quats / np.linalg.norm(
        smoothed_quats, axis=1, keepdims=True
    )
    rots = R.from_quat(smoothed_quats).as_matrix()

    smoothed = np.tile(np.eye(4), (n, 1, 1))
    smoothed[:, :3, :3] = rots
    smoothed[:, :3, 3] = smoothed_trans
    return smoothed


class _KalmanCV:
    """Constant-velocity Kalman filter, dim_x=6 (pos+vel), dim_z=3 (pos)."""

    def __init__(self, dt: float = 1.0):
        self.f = np.eye(6)
        self.f[0, 3] = self.f[1, 4] = self.f[2, 5] = dt
        self.h = np.zeros((3, 6))
        self.h[0, 0] = self.h[1, 1] = self.h[2, 2] = 1.0
        self.r = np.eye(3) * 0.1
        self.q = np.eye(6) * 0.1
        self.p = np.eye(6)
        self.x = np.zeros(6)

    def predict(self) -> None:
        self.x = self.f @ self.x
        self.p = self.f @ self.p @ self.f.T + self.q

    def update(self, z: np.ndarray) -> None:
        y = z - self.h @ self.x
        s = self.h @ self.p @ self.h.T + self.r
        k = self.p @ self.h.T @ np.linalg.inv(s)
        self.x = self.x + k @ y
        self.p = (np.eye(6) - k @ self.h) @ self.p


def smooth_trajectory(poses: np.ndarray, window_size: int = 5) -> np.ndarray:
    """Kalman-filter translations + gaussian-window quaternion averaging."""
    n = poses.shape[0]
    _, quats = _extract_quats(poses)

    smoothed = smooth_poses(poses, window_size, method="gaussian")
    smooth_trans = smoothed[:, :3, 3]

    kf = _KalmanCV()
    kf.x[:3] = smooth_trans[0]
    filtered_trans = np.zeros_like(smooth_trans)
    filtered_trans[0] = smooth_trans[0]
    for i in range(1, n):
        kf.predict()
        kf.update(smooth_trans[i])
        filtered_trans[i] = kf.x[:3]

    window_half = window_size // 2
    smoothed_quats = np.zeros_like(quats)
    for i in range(n):
        start = max(0, i - window_half)
        end = min(n, i + window_half + 1)
        idx = np.arange(start, end)
        weights = np.exp(-0.5 * ((idx - i) / (window_half / 2)) ** 2)
        weights = weights / weights.sum()
        avg = np.zeros(4)
        for j, w in zip(idx, weights):
            avg += w * (-quats[j] if np.dot(quats[j], quats[i]) < 0 else quats[j])
        smoothed_quats[i] = avg / np.linalg.norm(avg)

    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3] = R.from_quat(smoothed_quats).as_matrix()
    out[:, :3, 3] = filtered_trans
    return out


def detect_static_sequence(
    poses: np.ndarray, threshold: float = 0.01
) -> Tuple[bool, float, float]:
    """Flag near-static camera paths by mean frame-to-frame pose deltas."""
    translations = poses[:, :3, 3]
    rotations = poses[:, :3, :3]
    trans_diff = float(
        np.linalg.norm(translations[1:] - translations[:-1], axis=1).mean()
    )
    rot_diff = float(
        np.linalg.norm(rotations[1:] - rotations[:-1], axis=(1, 2)).mean()
    )
    return trans_diff < threshold and rot_diff < threshold, trans_diff, rot_diff


def adaptive_pose_smoothing(
    poses: np.ndarray, trans_diff: float, rot_diff: float, base_window: int = 5
) -> np.ndarray:
    """Grow the smoothing window as motion magnitude shrinks."""
    motion_magnitude = trans_diff + rot_diff
    adaptive_window = min(
        41,
        max(base_window, int(base_window * (0.1 / max(motion_magnitude, 1e-6)))),
    )
    if adaptive_window % 2 == 0:
        adaptive_window += 1
    return smooth_poses(poses, window_size=adaptive_window, method="gaussian")

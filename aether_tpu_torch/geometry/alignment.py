"""Rigid / similarity alignment on small pose batches (host-side numpy).

These run on tiny (T, 3/4, 4) matrices during window stitching — jitting buys nothing
(SURVEY.md section 7 "hard parts"), so like the reference they live on host, but in
float64 numpy for better-conditioned SVDs.

Semantics match reference ``aether/utils/postprocess_utils.py``:
- ``align_rigid``             (:464-513)  weighted Umeyama (SVD rotation + scale + t)
- ``align_camera_extrinsics`` (:516-568)  mean-rotation SVD + covariance scale
- ``apply_transformation``    (:571-607)

Copy of ``aether_tpu/geometry/alignment.py`` (numpy, float64).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def align_rigid(
    p: np.ndarray, q: np.ndarray, weights: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Weighted least-squares similarity transform mapping p -> q.

    Args:
        p, q: (B, N, 3) point sets.
        weights: (B, N) non-negative weights.
    Returns:
        (rotation (B,3,3), translation (B,3), scale (B,))
    """
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    batch = p.shape[0]

    w_norm = weights / (weights.sum(axis=-1, keepdims=True) + 1e-8)
    p_centroid = (w_norm[..., None] * p).sum(axis=-2)  # (B, 3)
    q_centroid = (w_norm[..., None] * q).sum(axis=-2)

    p_c = p - p_centroid[..., None, :]
    q_c = q - q_centroid[..., None, :]

    cov = np.einsum("bnc,bnd->bcd", q_c * weights[..., None], p_c)  # (B, 3, 3)
    u, _, vt = np.linalg.svd(cov)
    s = np.tile(np.eye(3), (batch, 1, 1))
    s[:, 2, 2] = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    rotation = u @ s @ vt

    rotated_p = np.einsum("bij,bkj->bki", rotation, p_c)
    scale = ((rotated_p * q_c).sum(-1) * weights).sum(-1) / (
        ((p_c**2).sum(-1) * weights).sum(-1)
    )
    translation = q_centroid - np.einsum(
        "bij,bj->bi", rotation, p_centroid * scale[:, None]
    )
    return rotation, translation, scale


def align_camera_extrinsics(
    cameras_src: np.ndarray,
    cameras_tgt: np.ndarray,
    estimate_scale: bool = True,
    eps: float = 1e-9,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Similarity transform aligning source [R|t] extrinsics to targets.

    Args are (B, 3, 4) (extra rows are ignored). Returns (R (1,3,3), T (1,3), s).
    """
    cameras_src = np.asarray(cameras_src, dtype=np.float64)[:, :3, :4]
    cameras_tgt = np.asarray(cameras_tgt, dtype=np.float64)[:, :3, :4]

    r_src = cameras_src[:, :, :3]
    r_tgt = cameras_tgt[:, :, :3]

    rr_cov = np.einsum("bji,bjk->bik", r_tgt, r_src).mean(axis=0)
    # torch.svd returns V (not V^T); align_t_R = V @ U^T. The determinant
    # sign fix keeps the mean rotation in SO(3) when the covariance is
    # degenerate (reflections otherwise propagate into every blended pose);
    # for well-posed inputs det is already +1 and this is a no-op.
    u, _, vt = np.linalg.svd(rr_cov)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    align_t_r = vt.T @ np.diag([1.0, 1.0, d if d != 0 else 1.0]) @ u.T

    t_src = cameras_src[:, :, 3]
    t_tgt = cameras_tgt[:, :, 3]
    a = np.einsum("bj,bjk->bk", t_src, r_src)
    b = np.einsum("bj,bjk->bk", t_tgt, r_src)

    a_mu = a.mean(axis=0, keepdims=True)
    b_mu = b.mean(axis=0, keepdims=True)

    if estimate_scale and a.shape[0] > 1:
        a_c = a - a_mu
        b_c = b - b_mu
        align_t_s = float((a_c * b_c).mean() / max((a_c**2).mean(), eps))
    else:
        align_t_s = 1.0

    align_t_t = b_mu - align_t_s * a_mu
    return align_t_r[None], align_t_t, align_t_s


def apply_transformation(
    cameras_src: np.ndarray,
    align_t_r: np.ndarray,
    align_t_t: np.ndarray,
    align_t_s: float,
    return_extri: bool = True,
):
    """Apply an ``align_camera_extrinsics`` result to (B, 3, 4) extrinsics."""
    cameras_src = np.asarray(cameras_src, dtype=np.float64)[:, :3, :4]
    r_src = cameras_src[:, :, :3]
    t_src = cameras_src[:, :, 3]

    aligned_r = np.einsum("bij,jk->bik", r_src, align_t_r[0])
    transformed_t = np.einsum("bij,j->bi", r_src, align_t_t[0])
    aligned_t = transformed_t + t_src * align_t_s

    if return_extri:
        return np.concatenate([aligned_r, aligned_t[..., None]], axis=-1)
    return aligned_r, aligned_t


def poses_to_extrinsics(poses: np.ndarray) -> np.ndarray:
    """Promote (T, 3, 4) extrinsics back to (T, 4, 4) homogeneous poses."""
    poses = np.asarray(poses)
    out = np.tile(np.eye(4, dtype=poses.dtype), (poses.shape[0], 1, 1))
    out[:, :3, :4] = poses[:, :3, :4]
    return out


def project_to_so3(r: "np.ndarray") -> "np.ndarray":
    """Closest proper rotation (orthogonal Procrustes with det sign fix).

    Defensive repair for near-degenerate 3x3 "rotations" (e.g. recovered from
    noisy raymaps); non-finite input maps to the identity.
    """
    r = np.asarray(r, dtype=np.float64)
    if not np.all(np.isfinite(r)):
        return np.eye(3)
    u, _, vt = np.linalg.svd(r)
    d = np.sign(np.linalg.det(u @ vt))
    return u @ np.diag([1.0, 1.0, d if d != 0 else 1.0]) @ vt

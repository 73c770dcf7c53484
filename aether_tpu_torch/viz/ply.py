"""PLY point-cloud export with zero dependencies (numpy structured arrays).

Capability parity with reference ``aether/utils/postprocess_utils.py:59-94``
(``save_ply``: downsampled xyz+rgb vertex cloud) and ``:164-216``
(``save_pointmap``: lift disparity+raymap to a pointmap, then export) — the
reference goes through the ``plyfile`` package; here the header + payload are
emitted directly, and binary-little-endian is the default (5x smaller and
faster to parse than the reference's ascii output).

Copy of ``aether_tpu/viz/ply.py``; ``save_pointmap`` lifts through the
port's ``geometry/raymap.py::postprocess_pointmap``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_VERTEX_DTYPE = np.dtype(
    [
        ("x", "<f4"),
        ("y", "<f4"),
        ("z", "<f4"),
        ("red", "u1"),
        ("green", "u1"),
        ("blue", "u1"),
    ]
)

_HEADER_PROPS = (
    "property float x\n"
    "property float y\n"
    "property float z\n"
    "property uchar red\n"
    "property uchar green\n"
    "property uchar blue\n"
)


def write_ply(
    path: str,
    points: np.ndarray,
    colors: np.ndarray,
    binary: bool = True,
) -> None:
    """Write an (N, 3) float point cloud with (N, 3) uint8 colors to ``path``."""
    points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    colors = np.ascontiguousarray(colors).reshape(-1, 3)
    if colors.dtype != np.uint8:
        colors = np.clip(colors, 0, 255).astype(np.uint8)
    n = points.shape[0]
    vertices = np.empty(n, dtype=_VERTEX_DTYPE)
    vertices["x"], vertices["y"], vertices["z"] = points.T
    vertices["red"], vertices["green"], vertices["blue"] = colors.T

    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        f"ply\nformat {fmt} 1.0\nelement vertex {n}\n{_HEADER_PROPS}end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(vertices.tobytes())
        else:
            for v in vertices:
                f.write(
                    f"{v['x']:.6g} {v['y']:.6g} {v['z']:.6g} "
                    f"{v['red']} {v['green']} {v['blue']}\n".encode("ascii")
                )


def save_ply(
    pointmap: np.ndarray,
    image: np.ndarray,
    output_file: str,
    downsample: int = 20,
    mask: Optional[np.ndarray] = None,
    seed: int = 0,
    binary: bool = True,
) -> None:
    """Export a (T, H, W, 3) pointmap + (T, H, W, 3) [0,255] image as a PLY cloud.

    Random 1/``downsample`` subsampling mirrors the reference's
    ``np.random.choice`` thinning (``postprocess_utils.py:71-74``), but with a
    seeded generator for reproducibility.
    """
    pointmap = np.asarray(pointmap)
    image = np.asarray(image)
    _, h, w, _ = pointmap.shape
    image = image[:, :h, :w]

    points = pointmap.reshape(-1, 3)
    colors = image.reshape(-1, 3)
    if mask is not None:
        keep = np.asarray(mask).reshape(-1)
        points = points[keep]
        colors = colors[keep]
    if downsample > 1 and points.shape[0] > 0:
        rng = np.random.default_rng(seed)
        idx = rng.choice(
            points.shape[0], max(int(points.shape[0] / downsample), 1), replace=False
        )
        points = points[idx]
        colors = colors[idx]
    write_ply(output_file, points, colors, binary=binary)


def save_pointmap(
    rgb: np.ndarray,
    disparity: np.ndarray,
    raymap: np.ndarray,
    save_file: str,
    vae_downsample_scale: int = 8,
    camera_pose: Optional[np.ndarray] = None,
    ray_o_scale_inv: float = 1.0,
    max_depth: float = 1e2,
    save_full_pcd_videos: bool = False,
    smooth_camera: bool = False,
    smooth_method: str = "kalman",
    **kwargs,
) -> Dict[str, np.ndarray]:
    """Lift (disparity, raymap) to a pointmap and export it as PLY.

    Same contract as reference ``postprocess_utils.py:164-216``: rgb in [0, 1]
    (T, H, W, 3), disparity in [0, 1] (T, H, W), raymap (T, 6, H/8, W/8).
    Returns the pointmap dict from :func:`postprocess_pointmap`.
    """
    from aether_tpu_torch.geometry.raymap import postprocess_pointmap

    rgb255 = np.clip(np.asarray(rgb), 0, 1) * 255

    pointmap_dict = postprocess_pointmap(
        np.asarray(disparity),
        np.asarray(raymap),
        vae_downsample_scale,
        camera_pose=camera_pose,
        ray_o_scale_inv=ray_o_scale_inv,
        smooth_camera=smooth_camera,
        smooth_method=smooth_method,
        **kwargs,
    )
    pointmap_dict = {k: np.asarray(v) for k, v in pointmap_dict.items()}

    save_ply(
        pointmap_dict["pointmap"],
        rgb255,
        save_file,
        mask=pointmap_dict["depth"] < max_depth,
    )

    if save_full_pcd_videos:
        pcd = {
            "points": pointmap_dict["pointmap"],
            "colors": rgb255,
            "intrinsics": pointmap_dict["intrinsics"],
            "poses": pointmap_dict["camera_pose"],
            "depths": pointmap_dict["depth"],
        }
        np.save(str(save_file).replace(".ply", "_pcd.npy"), pcd)

    return pointmap_dict

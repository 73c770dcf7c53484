"""Raymap codec: camera poses <-> 6-channel raymaps, and pointmap lifting, in
torch.

Port of ``aether_tpu/geometry/raymap.py`` (reference
``aether/utils/postprocess_utils.py:219-351, 867-961``). A raymap is a
(T, 6, H/8, W/8) tensor, channels [ray_d (3), ray_o (3)], ray origins
compressed by ``signed_log1p(t * 10 / dmax)``. ``camera_pose_to_raymap``
evaluates the ray field analytically at the downsampled pixel positions (the
camera-space field is linear in (u, v), so this equals the reference's
bilinear downsample). f32 throughout, on the raymap's device; the pose
smoothing in ``postprocess_pointmap`` runs on the host in float64 numpy, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from aether_tpu_torch.geometry.rays import fov_to_focal, get_rays
from aether_tpu_torch.geometry.transforms import (
    Array,
    as_f32,
    disparity_to_depth,
    signed_log1p,
    signed_log1p_inverse,
)


def raymap_to_poses(raymap: Array, camera_pose: Optional[Array] = None,
                    ray_o_scale_inv: float = 1.0, return_intrinsics: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
    """Per-frame c2w poses (T, 4, 4) and half-angle FoVs from a (T, 6, h, w)
    raymap: origin = mean ray_o; focal direction from mean(ray_o + ray_d) -
    origin; FoVs from the left/right and top/bottom ray bundles; R
    re-orthonormalized from the X/Y/Z direction estimates."""
    raymap = as_f32(raymap)
    ts, _, h, w = raymap.shape
    if not return_intrinsics and camera_pose is not None:
        return as_f32(camera_pose, raymap.device), None, None

    ray_o = signed_log1p_inverse(raymap[:, 3:]).permute(0, 2, 3, 1) * ray_o_scale_inv
    ray_d = raymap[:, :3].permute(0, 2, 3, 1)

    orient = ray_o.reshape(ts, -1, 3).mean(dim=1)
    image_orient = (ray_o + ray_d).reshape(ts, -1, 3).mean(dim=1)
    focal = torch.linalg.norm(image_orient - orient, dim=-1)
    z_dir = image_orient - orient

    w_left = ray_d[:, :, :1, :].reshape(ts, -1, 3).mean(dim=1)
    w_right = ray_d[:, :, -1:, :].reshape(ts, -1, 3).mean(dim=1)
    w_span = w_right - w_left
    w_real = torch.linalg.norm(torch.linalg.cross(w_span, z_dir), dim=-1) / (w - 1) * w
    fov_x = torch.arctan(w_real / (2.0 * focal))

    h_up = ray_d[:, :1, :, :].reshape(ts, -1, 3).mean(dim=1)
    h_down = ray_d[:, -1:, :, :].reshape(ts, -1, 3).mean(dim=1)
    h_span = h_up - h_down
    h_real = torch.linalg.norm(torch.linalg.cross(h_span, z_dir), dim=-1) / (h - 1) * h
    fov_y = torch.arctan(h_real / (2.0 * focal))

    if camera_pose is None:
        x_dir = w_right - w_left
        y_dir = torch.linalg.cross(z_dir, x_dir)
        x_dir = torch.linalg.cross(y_dir, z_dir)
        x_dir = x_dir / torch.linalg.norm(x_dir, dim=-1, keepdim=True)
        y_dir = y_dir / torch.linalg.norm(y_dir, dim=-1, keepdim=True)
        z_dir = z_dir / torch.linalg.norm(z_dir, dim=-1, keepdim=True)
        camera_pose = torch.zeros((ts, 4, 4), dtype=torch.float32, device=raymap.device)
        camera_pose[:, :3, 0] = x_dir
        camera_pose[:, :3, 1] = y_dir
        camera_pose[:, :3, 2] = z_dir
        camera_pose[:, :3, 3] = orient
        camera_pose[:, 3, 3] = 1.0
    else:
        camera_pose = as_f32(camera_pose, raymap.device)
    return camera_pose, fov_x, fov_y


def _downsample_coords(n_out: int, scale: int, align_corners: bool,
                       device=None) -> torch.Tensor:
    """Source-pixel coordinates sampled by F.interpolate(scale_factor=1/scale)."""
    j = torch.arange(n_out, dtype=torch.float32, device=device)
    if align_corners:
        if n_out == 1:
            return torch.zeros((1,), dtype=torch.float32, device=device)
        return j * (n_out * scale - 1) / (n_out - 1)
    return (j + 0.5) * scale - 0.5


def camera_pose_to_raymap(camera_pose: Array, intrinsic: Array,
                          ray_o_scale_factor: float = 10.0, dmax: float = 1.0,
                          height: int = 480, width: int = 720, vae_downsample: int = 8,
                          align_corners: bool = False) -> torch.Tensor:
    """(N, 4, 4) c2w poses + (N, 3, 3) intrinsics -> (N, 6, H/8, W/8) raymap:
    camera-space dirs (u - cu)/fu, (v - cv)/fv, 1 on the pixel grid, rotated to
    world, sampled at the bilinear-downsample positions; ray_o =
    signed_log1p(t * ray_o_scale_factor * dmax) broadcast over the grid."""
    camera_pose = as_f32(camera_pose)
    dev = camera_pose.device
    intrinsic = as_f32(intrinsic, dev)
    h_lat = height // vae_downsample if vae_downsample != 1 else height
    w_lat = width // vae_downsample if vae_downsample != 1 else width
    u = _downsample_coords(w_lat, vae_downsample, align_corners, dev)
    v = _downsample_coords(h_lat, vae_downsample, align_corners, dev)
    fu = intrinsic[:, 0, 0][:, None, None]
    fv = intrinsic[:, 1, 1][:, None, None]
    cu = intrinsic[:, 0, 2][:, None, None]
    cv = intrinsic[:, 1, 2][:, None, None]
    x_cam, y_cam = torch.broadcast_tensors((u[None, None, :] - cu) / fu,
                                           (v[None, :, None] - cv) / fv)
    dirs_cam = torch.stack([x_cam, y_cam, torch.ones_like(x_cam)], dim=-1)
    ray_d = torch.einsum("nij,nhwj->nihw", camera_pose[:, :3, :3], dirs_cam)
    trans = camera_pose[:, :3, 3] * (dmax * ray_o_scale_factor)
    ray_o = signed_log1p(trans)[:, :, None, None].broadcast_to(ray_d.shape)
    return torch.cat([ray_d, ray_o], dim=1)


def postprocess_pointmap(disparity: Array, raymap: Array, vae_downsample_scale: int = 8,
                         camera_pose: Optional[Array] = None,
                         focal: Optional[Array] = None, ray_o_scale_inv: float = 1.0,
                         smooth_camera: bool = False, smooth_method: str = "simple",
                         **kwargs) -> Dict[str, np.ndarray]:
    """Lift (T, h, w) disparity + (T, 6, h/8, w/8) raymap to world pointmaps
    (reference ``postprocess_utils.py:283-351``). The lifting runs in torch on
    the raymap's device, the optional pose smoothing on the host. Returns
    numpy arrays."""
    from aether_tpu_torch.geometry import smoothing as smoothing_lib

    raymap = as_f32(raymap)
    dev = raymap.device
    depth = disparity_to_depth(as_f32(disparity, dev))
    camera_pose, fov_x, fov_y = raymap_to_poses(
        raymap, camera_pose=camera_pose, ray_o_scale_inv=ray_o_scale_inv,
        return_intrinsics=focal is not None)
    h = int(raymap.shape[2] * vae_downsample_scale)
    w = int(raymap.shape[3] * vae_downsample_scale)
    if focal is None:
        focal = fov_to_focal(fov_x, fov_y, h, w)

    camera_pose = camera_pose.cpu().numpy()
    if smooth_camera:
        is_static, trans_diff, rot_diff = smoothing_lib.detect_static_sequence(camera_pose)
        if is_static:
            camera_pose = smoothing_lib.adaptive_pose_smoothing(camera_pose, trans_diff,
                                                                rot_diff)
        elif smooth_method == "simple":
            camera_pose = smoothing_lib.smooth_poses(camera_pose, window_size=5,
                                                     method="gaussian")
        elif smooth_method == "kalman":
            camera_pose = smoothing_lib.smooth_trajectory(camera_pose, window_size=5)

    ray_o, ray_d, intrinsics = get_rays(as_f32(camera_pose, dev), h, w,
                                        as_f32(focal, dev))
    pointmap = depth[..., None] * ray_d + ray_o
    out = {"pointmap": pointmap, "camera_pose": camera_pose, "intrinsics": intrinsics,
           "ray_o": ray_o, "ray_d": ray_d, "depth": depth}
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}

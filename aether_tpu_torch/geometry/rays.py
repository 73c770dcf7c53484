"""Pinhole camera ray casting and (un)projection, in torch.

Port of ``aether_tpu/geometry/rays.py`` (reference
``aether/utils/postprocess_utils.py``: ``get_rays`` :104-144,
``get_intrinsics`` :147-161, ``fov_to_focal`` :97-101, ``get_pixel`` /
``project`` :381-403). f32 throughout, on the device of the first tensor
argument (the CPU for numpy inputs). ``project`` also takes a leading batch
axis, so a whole clip unprojects in one call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from aether_tpu_torch.geometry.transforms import Array, as_f32


def fov_to_focal(fovx: Array, fovy: Array, h: int, w: int) -> torch.Tensor:
    """Average focal from half-angle FoVs (radians)."""
    fovx = as_f32(fovx)
    focal_x = w * 0.5 / torch.tan(fovx)
    focal_y = h * 0.5 / torch.tan(as_f32(fovy, fovx.device))
    return (focal_x + focal_y) / 2.0


def get_intrinsics(batch_size: int, h: int, w: int, fovx: Optional[Array] = None,
                   fovy: Optional[Array] = None, focal: Optional[Array] = None,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, 3) shared-focal intrinsics; returns (K, focal)."""
    if focal is None:
        focal = fov_to_focal(fovx, fovy, h, w)
    focal = as_f32(focal, device).broadcast_to((batch_size,))
    k = torch.zeros((batch_size, 3, 3), dtype=torch.float32, device=focal.device)
    k[:, 0, 0] = focal
    k[:, 1, 1] = focal
    k[:, 0, 2] = w * 0.5
    k[:, 1, 2] = h * 0.5
    k[:, 2, 2] = 1.0
    return k, focal


def get_rays(pose: Array, h: int, w: int, focal: Optional[Array] = None,
             fovx: Optional[Array] = None, fovy: Optional[Array] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pixel-center rays for a batch of c2w poses: camera dirs
    ((x - cx + 0.5)/f, (y - cy + 0.5)/f, 1) rotated by R.
    Returns (rays_o [T,h,w,3], rays_d [T,h,w,3], intrinsics [T,3,3])."""
    pose = as_f32(pose)
    dev = pose.device
    t = pose.shape[0]
    intrinsics, focal = get_intrinsics(t, h, w, fovx, fovy, focal, device=dev)
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cx, cy = w * 0.5, h * 0.5
    f = focal[:, None, None]
    dirs_x = ((x - cx + 0.5)[None] / f).broadcast_to((t, h, w))
    dirs_y = ((y - cy + 0.5)[None] / f).broadcast_to((t, h, w))
    dirs_z = torch.ones((t, h, w), dtype=torch.float32, device=dev)
    camera_dirs = torch.stack([dirs_x, dirs_y, dirs_z], dim=-1)
    rays_d = torch.einsum("tij,thwj->thwi", pose[:, :3, :3], camera_dirs)
    rays_o = pose[:, None, None, :3, 3].broadcast_to(rays_d.shape)
    return rays_o, rays_d, intrinsics


def get_pixel(h: int, w: int, device=None) -> torch.Tensor:
    """(3, h*w) homogeneous pixel centers (u+0.5, v+0.5, 1), row-major over v
    then u."""
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([u.reshape(-1) + 0.5, v.reshape(-1) + 0.5,
                        torch.ones(h * w, dtype=torch.float32, device=device)], dim=0)


def project(depth: Array, intrinsic: Array, pose: Array) -> torch.Tensor:
    """Unproject depth maps to world points with K^-1 and c2w poses.

    depth (..., h, w), intrinsic (..., 3, 3), pose (..., 4, 4) with the same
    leading axes; returns (..., h, w, 3)."""
    depth = as_f32(depth)
    dev = depth.device
    intrinsic, pose = as_f32(intrinsic, dev), as_f32(pose, dev)
    h, w = depth.shape[-2:]
    lead = depth.shape[:-2]
    pixel = get_pixel(h, w, dev)  # (3, hw)
    cam_pts = (torch.linalg.inv(intrinsic) @ pixel) * depth.reshape(*lead, 1, h * w)
    cam_h = torch.cat([cam_pts, torch.ones((*lead, 1, h * w), device=dev)], dim=-2)
    world = pose[..., :3, :4] @ cam_h  # (..., 3, hw)
    return world.transpose(-1, -2).reshape(*lead, h, w, 3)

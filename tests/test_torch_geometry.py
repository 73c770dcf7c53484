"""The port's geometry (``aether_tpu_torch.geometry``) against the JAX package's.

Every ported function runs on the same seeded numpy inputs on both sides; the
f32 functions agree within 1e-5 (absolute, on O(1) values; 1e-4 where a
value reaches ~1e2), the float64 numpy copies bit for bit. The roundtrips of
``tests/test_geometry.py`` run again on the port.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import aether_tpu.geometry as jg
import aether_tpu_torch.geometry as tg

torch.set_num_threads(1)


def random_poses(rng, n=5, max_angle=0.3, max_trans=2.0):
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        poses[i, :3, :3] = R.from_rotvec(rng.normal(size=3) * max_angle).as_matrix()
        poses[i, :3, 3] = rng.normal(size=3) * max_trans
    return poses


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_exports_match_jax_package():
    names = {n for n in dir(jg) if not n.startswith("_")}
    assert names - {"alignment", "edges", "rays", "raymap", "smoothing",
                    "transforms"} <= set(dir(tg))


def test_transforms_match_jax(rng):
    x = rng.normal(size=(4, 7)).astype(np.float32) * 100
    for name in ("signed_log1p", "signed_log1p_inverse"):
        a = getattr(tg, name)(x if name == "signed_log1p" else x / 50)
        b = getattr(jg, name)(x if name == "signed_log1p" else x / 50)
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-5)
    depth = rng.uniform(0.5, 50.0, size=(3, 16, 16)).astype(np.float32)
    depth[0, 0, 0] = 0.0  # invalid pixel
    for sq in (True, False):
        (da, ma), (db, mb) = tg.depth_to_disparity(depth, sq), jg.depth_to_disparity(depth, sq)
        np.testing.assert_allclose(_np(da), np.asarray(db), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(ma), float(mb), rtol=1e-6)
    disp = rng.uniform(-0.1, 1.2, size=(2, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(_np(tg.disparity_to_depth(disp)),
                               np.asarray(jg.disparity_to_depth(disp)), rtol=1e-6)
    pred = rng.uniform(0.1, 1.0, size=(2, 16, 16)).astype(np.float32)
    target = pred * 2.5 + rng.normal(size=pred.shape).astype(np.float32) * 0.01
    mask = pred > 0.3
    np.testing.assert_allclose(_np(tg.compute_scale(pred, target, mask)),
                               np.asarray(jg.compute_scale(pred, target, mask)), rtol=1e-5)
    one = tg.compute_scale(pred[:1], target[:1], mask[:1])
    assert isinstance(one, float)
    assert one == pytest.approx(jg.compute_scale(pred[:1], target[:1], mask[:1]), rel=1e-6)


def test_rays_match_jax(rng):
    h, w = 24, 40
    poses = random_poses(rng, 3)
    fovx, fovy = rng.uniform(0.3, 0.8, 3), rng.uniform(0.2, 0.6, 3)
    np.testing.assert_allclose(_np(tg.fov_to_focal(fovx, fovy, h, w)),
                               np.asarray(jg.fov_to_focal(fovx, fovy, h, w)), rtol=1e-6)
    for kw in (dict(fovx=fovx, fovy=fovy), dict(focal=37.5)):
        (ka, fa), (kb, fb) = tg.get_intrinsics(3, h, w, **kw), jg.get_intrinsics(3, h, w, **kw)
        np.testing.assert_allclose(_np(ka), np.asarray(kb), rtol=1e-6)
        np.testing.assert_allclose(_np(fa), np.asarray(fb), rtol=1e-6)
    for got, ref in zip(tg.get_rays(poses, h, w, focal=30.0),
                        jg.get_rays(poses, h, w, focal=30.0)):
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5)
    np.testing.assert_array_equal(_np(tg.get_pixel(h, w)), np.asarray(jg.get_pixel(h, w)))
    depth = rng.uniform(1.0, 10.0, size=(3, h, w)).astype(np.float32)
    k, _ = jg.get_intrinsics(3, h, w, focal=30.0)
    batched = _np(tg.project(depth, np.asarray(k), poses))
    for i in range(3):
        ref = np.asarray(jg.project(depth[i], np.asarray(k)[i], poses[i]))
        np.testing.assert_allclose(_np(tg.project(depth[i], np.asarray(k)[i], poses[i])),
                                   ref, atol=1e-4)
        np.testing.assert_allclose(batched[i], ref, atol=1e-4)


@pytest.mark.parametrize("align_corners", [False, True])
def test_raymap_codec_matches_jax(rng, align_corners):
    n, h, w = 4, 96, 160
    poses = random_poses(rng, n)
    k, _ = jg.get_intrinsics(n, h, w, focal=120.0)
    kw = dict(ray_o_scale_factor=10.0, dmax=0.7, height=h, width=w,
              align_corners=align_corners)
    rm_t = _np(tg.camera_pose_to_raymap(poses, np.asarray(k), **kw))
    rm_j = np.asarray(jg.camera_pose_to_raymap(poses, np.asarray(k), **kw))
    np.testing.assert_allclose(rm_t, rm_j, atol=1e-5)
    for got, ref in zip(tg.raymap_to_poses(rm_j, ray_o_scale_inv=0.1),
                        jg.raymap_to_poses(rm_j, ray_o_scale_inv=0.1)):
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5)
    pose_t, fx, fy = tg.raymap_to_poses(rm_j, camera_pose=poses, return_intrinsics=False)
    assert fx is None and fy is None
    np.testing.assert_allclose(_np(pose_t), poses.astype(np.float32))


@pytest.mark.parametrize("smooth,method,focal", [
    (False, "simple", None), (True, "kalman", None), (True, "simple", 111.0)])
def test_postprocess_pointmap_matches_jax(rng, smooth, method, focal):
    n, h_lat, w_lat = 6, 6, 10
    poses = random_poses(rng, n, max_angle=0.05, max_trans=0.5)
    k, _ = jg.get_intrinsics(n, h_lat * 8, w_lat * 8, focal=100.0)
    raymap = np.asarray(jg.camera_pose_to_raymap(poses, np.asarray(k), height=h_lat * 8,
                                                 width=w_lat * 8))
    disparity = rng.uniform(0.05, 1.0, size=(n, h_lat * 8, w_lat * 8)).astype(np.float32)
    kw = dict(ray_o_scale_inv=0.1, smooth_camera=smooth, smooth_method=method, focal=focal)
    got = tg.postprocess_pointmap(disparity, raymap, **kw)
    ref = jg.postprocess_pointmap(disparity, raymap, **kw)
    assert set(got) == set(ref)
    for key in ref:
        assert isinstance(got[key], np.ndarray), key
        np.testing.assert_allclose(got[key], np.asarray(ref[key]), rtol=1e-5, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("atol,rtol,masked,kernel", [
    (1.0, None, False, 3), (None, 0.2, False, 3), (0.2, 0.05, True, 5), (None, 0.1, True, 3)])
def test_depth_edge_matches_jax(rng, atol, rtol, masked, kernel):
    depth = rng.uniform(1.0, 3.0, size=(2, 3, 12, 16)).astype(np.float32)
    depth[:, :, :, 9:] += 5.0
    depth[0, 0, 2, 2] = 0.0  # a zero depth: rel = inf / nan
    mask = rng.uniform(size=depth.shape) > 0.3 if masked else None
    got = tg.depth_edge(depth, atol=atol, rtol=rtol, kernel_size=kernel, mask=mask)
    ref = jg.depth_edge(depth, atol=atol, rtol=rtol, kernel_size=kernel, mask=mask)
    assert isinstance(got, np.ndarray) and got.dtype == bool
    np.testing.assert_array_equal(got, np.asarray(ref))
    as_tensor = tg.depth_edge(torch.from_numpy(depth), atol=atol, rtol=rtol,
                              kernel_size=kernel, mask=mask)
    assert isinstance(as_tensor, torch.Tensor)
    np.testing.assert_array_equal(as_tensor.numpy(), got)


def test_numpy_modules_are_copies(rng):
    poses = random_poses(rng, 9, max_angle=0.05, max_trans=0.1)
    other = random_poses(rng, 9)
    np.testing.assert_array_equal(
        np.asarray(tg.align_camera_extrinsics(poses, other)[0]),
        np.asarray(jg.align_camera_extrinsics(poses, other)[0]))
    for method in ("gaussian", "savgol", "ma"):
        np.testing.assert_array_equal(tg.smooth_poses(poses, 5, method),
                                      jg.smooth_poses(poses, 5, method))
    np.testing.assert_array_equal(tg.smooth_trajectory(poses, 5),
                                  jg.smooth_trajectory(poses, 5))
    np.testing.assert_array_equal(tg.interpolate_poses(poses[0], other[0], 0.3),
                                  jg.interpolate_poses(poses[0], other[0], 0.3))


# ---- the roundtrips of tests/test_geometry.py, on the port ----

def test_signed_log1p_roundtrip(rng):
    x = rng.normal(size=(4, 7)) * 100
    x2 = _np(tg.signed_log1p_inverse(tg.signed_log1p(x)))
    np.testing.assert_allclose(x, x2, rtol=1e-4, atol=1e-4)


def test_depth_disparity_roundtrip(rng):
    depth = rng.uniform(0.5, 50.0, size=(3, 16, 16)).astype(np.float32)
    disparity, dmax = tg.depth_to_disparity(depth, sqrt_disparity=True)
    disparity = _np(disparity)
    assert disparity.min() >= 0.0 and disparity.max() <= 1.0
    recon = _np(tg.disparity_to_depth(disparity**2)) / float(dmax)
    np.testing.assert_allclose(recon, depth, rtol=1e-3)


def test_pose_raymap_roundtrip(rng):
    n, h, w = 6, 480, 720
    poses = random_poses(rng, n)
    k, _ = tg.get_intrinsics(n, h, w, focal=400.0)
    raymap = tg.camera_pose_to_raymap(poses, k, ray_o_scale_factor=10.0, height=h, width=w)
    assert tuple(raymap.shape) == (n, 6, h // 8, w // 8)
    rec, fov_x, fov_y = tg.raymap_to_poses(raymap, ray_o_scale_inv=0.1)
    rec = _np(rec)
    np.testing.assert_allclose(rec[:, :3, 3], poses[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(rec[:, :3, :3], poses[:, :3, :3], atol=5e-3)
    rec_focal = _np(tg.fov_to_focal(fov_x, fov_y, h // 8, w // 8)) * 8
    np.testing.assert_allclose(rec_focal, 400.0, rtol=0.02)
    rtr = np.einsum("tij,tik->tjk", rec[:, :3, :3], rec[:, :3, :3])
    np.testing.assert_allclose(rtr, np.tile(np.eye(3), (n, 1, 1)), atol=1e-4)


def test_get_rays_matches_project(rng):
    h, w = 48, 64
    poses = random_poses(rng, 2)
    rays_o, rays_d, intrinsics = tg.get_rays(poses, h, w, focal=80.0)
    depth = rng.uniform(1.0, 10.0, size=(2, h, w)).astype(np.float32)
    pointmap = depth[..., None] * _np(rays_d) + _np(rays_o)
    direct = _np(tg.project(depth, intrinsics, poses))
    np.testing.assert_allclose(pointmap, direct, atol=5e-2)


def test_postprocess_pointmap_shapes(rng):
    n, h_lat, w_lat = 3, 30, 45
    poses = random_poses(rng, n)
    k, _ = tg.get_intrinsics(n, h_lat * 8, w_lat * 8, focal=400.0)
    raymap = tg.camera_pose_to_raymap(poses, k, height=h_lat * 8, width=w_lat * 8)
    disparity = rng.uniform(0.05, 1.0, size=(n, h_lat * 8, w_lat * 8)).astype(np.float32)
    out = tg.postprocess_pointmap(disparity, raymap, ray_o_scale_inv=0.1)
    assert out["pointmap"].shape == (n, h_lat * 8, w_lat * 8, 3)
    assert out["camera_pose"].shape == (n, 4, 4)
    assert out["depth"].min() >= 1.0


def test_depth_edge_detects_discontinuity():
    depth = np.ones((16, 16), dtype=np.float32)
    depth[:, 8:] = 10.0
    edge = tg.depth_edge(depth, atol=1.0, kernel_size=3)
    assert edge[:, 7].all() and edge[:, 8].all()
    assert not edge[:, :6].any() and not edge[:, 10:].any()

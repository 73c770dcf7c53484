"""The port's export layer (``aether_tpu_torch.viz``): PLY and GLB parse-back as
``tests/test_viz.py`` does, and the same bytes as the JAX package's writers on
the same inputs (the viz modules are copies; the GLB's depth-edge filter and
``save_pointmap``'s lifting are the port's torch geometry).
"""

import json
import struct

import numpy as np
import torch

import aether_tpu.viz as jviz
import aether_tpu_torch.viz as tviz

torch.set_num_threads(1)


def parse_ply(path):
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii")
    n = int([ln for ln in header.splitlines() if ln.startswith("element vertex")][0]
            .split()[-1])
    dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                      ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    return header, np.frombuffer(data[header_end:], dtype=dtype, count=n)


def parse_glb(data: bytes):
    magic, version, total = struct.unpack_from("<III", data, 0)
    assert magic == 0x46546C67 and version == 2 and total == len(data)
    json_len, json_type = struct.unpack_from("<II", data, 12)
    assert json_type == 0x4E4F534A and json_len % 4 == 0
    gltf = json.loads(data[20:20 + json_len])
    bin_off = 20 + json_len
    bin_len, bin_type = struct.unpack_from("<II", data, bin_off)
    assert bin_type == 0x004E4942 and bin_len % 4 == 0
    blob = data[bin_off + 8:bin_off + 8 + bin_len]
    assert gltf["buffers"][0]["byteLength"] == len(blob)
    for acc in gltf["accessors"]:
        view = gltf["bufferViews"][acc["bufferView"]]
        size = {5126: 4, 5121: 1, 5125: 4}[acc["componentType"]]
        width = {"VEC3": 3, "SCALAR": 1}[acc["type"]]
        assert acc["count"] * size * width <= view["byteLength"]
    return gltf, blob


def glb_points(gltf, blob):
    prim = next(pr for mesh in gltf["meshes"] for pr in mesh["primitives"]
                if pr.get("mode") == 0)
    acc = gltf["accessors"][prim["attributes"]["POSITION"]]
    view = gltf["bufferViews"][acc["bufferView"]]
    return np.frombuffer(blob, np.float32, count=acc["count"] * 3,
                         offset=view.get("byteOffset", 0)).reshape(-1, 3)


def test_ply_roundtrip(tmp_path):
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    cols = np.arange(30, dtype=np.uint8).reshape(10, 3)
    path = str(tmp_path / "cloud.ply")
    tviz.write_ply(path, pts, cols)
    header, body = parse_ply(path)
    assert "format binary_little_endian" in header
    np.testing.assert_allclose(np.stack([body["x"], body["y"], body["z"]], -1), pts)
    np.testing.assert_array_equal(np.stack([body["red"], body["green"], body["blue"]], -1),
                                  cols)


def test_glb_scene_matches_jax_writer(rng):
    t, h, w = 2, 12, 16
    depths = rng.uniform(1.0, 3.0, size=(t, h, w))
    depths[:, :, 10:] += 4.0  # an edge the rtol filter drops
    depths[:, 0, :3] = 500.0  # beyond max_depth
    preds = {
        "world_points": rng.normal(size=(t, h, w, 3)).astype(np.float32),
        "images": rng.uniform(0, 1, size=(t, h, w, 3)),
        "depths": depths,
        "camera_poses": np.broadcast_to(np.eye(4), (t, 4, 4)).copy(),
    }
    kw = dict(show_cam=True, max_depth=100.0, rtol=0.2, frame_rel_idx=0.25)
    data = tviz.predictions_to_glb(preds, **kw).to_bytes()
    assert data == jviz.predictions_to_glb(preds, **kw).to_bytes()
    gltf, blob = parse_glb(data)
    assert len(gltf["meshes"]) == 1 + t
    pts = glb_points(gltf, blob)
    assert 0 < pts.shape[0] < t * h * w


def test_save_pointmap_matches_jax_writer(tmp_path, rng):
    from aether_tpu.geometry import camera_pose_to_raymap, get_intrinsics

    n, h_lat, w_lat = 3, 4, 6
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(n, 3)) * 0.3
    k, _ = get_intrinsics(n, h_lat * 8, w_lat * 8, focal=40.0)
    raymap = np.asarray(camera_pose_to_raymap(poses, np.asarray(k), height=h_lat * 8,
                                              width=w_lat * 8))
    disparity = rng.uniform(0.05, 1.0, size=(n, h_lat * 8, w_lat * 8)).astype(np.float32)
    rgb = rng.uniform(0, 1, size=(n, h_lat * 8, w_lat * 8, 3))
    got = tviz.save_pointmap(rgb, disparity, raymap, str(tmp_path / "t.ply"),
                             ray_o_scale_inv=0.1)
    ref = jviz.save_pointmap(rgb, disparity, raymap, str(tmp_path / "j.ply"),
                             ray_o_scale_inv=0.1)
    np.testing.assert_allclose(got["pointmap"], np.asarray(ref["pointmap"]), atol=1e-4)
    (_, a), (_, b) = parse_ply(tmp_path / "t.ply"), parse_ply(tmp_path / "j.ply")
    assert len(a) == len(b) > 0
    for field in ("x", "y", "z"):
        np.testing.assert_allclose(a[field], b[field], atol=1e-4)
    for field in ("red", "green", "blue"):
        np.testing.assert_array_equal(a[field], b[field])


def test_colorize_and_video_writers(tmp_path):
    depth = np.array([[0.5, 1.0], [2.0, 0.0]])
    np.testing.assert_array_equal(tviz.colorize_depth(depth), jviz.colorize_depth(depth))
    frames = np.zeros((3, 16, 16, 3), np.uint8)
    out = tviz.save_video(tmp_path / "clip.mp4", frames, fps=12)
    with open(out, "rb") as f:
        head = f.read(12)
    assert head[4:8] == b"ftyp" or head[:4] in (b"RIFF", b"GIF8")

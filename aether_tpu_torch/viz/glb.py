"""Minimal GLB (binary glTF 2.0) scene writer — no trimesh dependency.

Capability parity with reference ``aether/utils/visualize_utils.py:18-123``
(``predictions_to_glb``: masked world-point cloud + per-frame camera glyphs,
5-95 percentile scene scaling, OpenGL axis convention) — but the container is
emitted directly: a JSON chunk describing meshes/accessors and a binary chunk
holding vertex payloads, per the public glTF 2.0 spec. Point clouds use
primitive mode 0 (POINTS) with normalized ubyte COLOR_0; camera glyphs are
double-sided pyramid frusta with a flat baseColor material.

Copy of ``aether_tpu/viz/glb.py``; the depth-edge filter is the port's
``geometry/edges.py``.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_GLB_MAGIC = 0x46546C67
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942
_F32 = 5126  # glTF componentType FLOAT
_U8 = 5121  # UNSIGNED_BYTE
_U32 = 5125  # UNSIGNED_INT
_ARRAY_BUFFER = 34962
_ELEMENT_ARRAY_BUFFER = 34963
_MODE_POINTS = 0
_MODE_TRIANGLES = 4


class _GlbBuilder:
    """Accumulates buffer views / accessors / meshes, then serializes one GLB."""

    def __init__(self) -> None:
        self._bin = bytearray()
        self.buffer_views: List[dict] = []
        self.accessors: List[dict] = []
        self.meshes: List[dict] = []
        self.nodes: List[dict] = []
        self.materials: List[dict] = []

    # -- low-level --------------------------------------------------------
    def _push_blob(self, data: bytes, target: Optional[int]) -> int:
        while len(self._bin) % 4:
            self._bin.append(0)
        view = {"buffer": 0, "byteOffset": len(self._bin), "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        self._bin.extend(data)
        self.buffer_views.append(view)
        return len(self.buffer_views) - 1

    def _push_accessor(
        self,
        array: np.ndarray,
        component_type: int,
        type_str: str,
        target: Optional[int],
        normalized: bool = False,
        with_minmax: bool = False,
    ) -> int:
        view = self._push_blob(np.ascontiguousarray(array).tobytes(), target)
        acc = {
            "bufferView": view,
            "componentType": component_type,
            "count": int(array.shape[0]),
            "type": type_str,
        }
        if normalized:
            acc["normalized"] = True
        if with_minmax:
            acc["min"] = [float(v) for v in array.min(axis=0)]
            acc["max"] = [float(v) for v in array.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def _push_material(self, rgba: Tuple[float, float, float, float]) -> int:
        self.materials.append(
            {
                "pbrMetallicRoughness": {
                    "baseColorFactor": [float(c) for c in rgba],
                    "metallicFactor": 0.0,
                    "roughnessFactor": 1.0,
                },
                "doubleSided": True,
            }
        )
        return len(self.materials) - 1

    # -- geometry ---------------------------------------------------------
    def add_point_cloud(self, points: np.ndarray, colors: np.ndarray) -> None:
        """(N, 3) float positions + (N, 3) uint8 colors as a POINTS primitive."""
        points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        colors = np.ascontiguousarray(colors).reshape(-1, 3)
        if colors.dtype != np.uint8:
            colors = np.clip(colors, 0, 255).astype(np.uint8)
        pos = self._push_accessor(points, _F32, "VEC3", _ARRAY_BUFFER,
                                  with_minmax=True)
        col = self._push_accessor(colors, _U8, "VEC3", _ARRAY_BUFFER,
                                  normalized=True)
        material = self._push_material((1.0, 1.0, 1.0, 1.0))
        self.meshes.append(
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": pos, "COLOR_0": col},
                        "mode": _MODE_POINTS,
                        "material": material,
                    }
                ]
            }
        )
        self.nodes.append({"mesh": len(self.meshes) - 1})

    def add_triangle_mesh(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        rgba: Tuple[float, float, float, float],
    ) -> None:
        vertices = np.ascontiguousarray(vertices, np.float32).reshape(-1, 3)
        faces = np.ascontiguousarray(faces, np.uint32).reshape(-1)
        pos = self._push_accessor(vertices, _F32, "VEC3", _ARRAY_BUFFER,
                                  with_minmax=True)
        idx = self._push_accessor(faces[:, None], _U32, "SCALAR",
                                  _ELEMENT_ARRAY_BUFFER)
        material = self._push_material(rgba)
        self.meshes.append(
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": pos},
                        "indices": idx,
                        "mode": _MODE_TRIANGLES,
                        "material": material,
                    }
                ]
            }
        )
        self.nodes.append({"mesh": len(self.meshes) - 1})

    # -- serialization ----------------------------------------------------
    def to_bytes(self) -> bytes:
        while len(self._bin) % 4:
            self._bin.append(0)
        gltf = {
            "asset": {"version": "2.0", "generator": "aether_tpu"},
            "scene": 0,
            "scenes": [{"nodes": list(range(len(self.nodes)))}],
            "nodes": self.nodes,
            "meshes": self.meshes,
            "materials": self.materials,
            "accessors": self.accessors,
            "bufferViews": self.buffer_views,
            "buffers": [{"byteLength": len(self._bin)}],
        }
        payload = json.dumps(gltf, separators=(",", ":")).encode("utf-8")
        while len(payload) % 4:
            payload += b" "
        total = 12 + 8 + len(payload) + 8 + len(self._bin)
        out = struct.pack("<III", _GLB_MAGIC, 2, total)
        out += struct.pack("<II", len(payload), _CHUNK_JSON) + payload
        out += struct.pack("<II", len(self._bin), _CHUNK_BIN) + bytes(self._bin)
        return out

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes())


# ---------------------------------------------------------------------------
# camera glyphs + scene assembly
# ---------------------------------------------------------------------------

_OPENGL_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def _camera_frustum_vertices(scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """A square-pyramid camera glyph in camera space (apex at origin, base
    behind along -z per the OpenGL convention), sized relative to the scene."""
    w = 0.025 * scale
    h = 0.05 * scale
    verts = np.array(
        [
            [0.0, 0.0, 0.0],  # apex (camera center)
            [-w, -w, -h],
            [w, -w, -h],
            [w, w, -h],
            [-w, w, -h],
        ],
        np.float32,
    )
    faces = np.array(
        [
            [0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1],  # sides
            [1, 2, 3], [1, 3, 4],  # base
        ],
        np.uint32,
    )
    return verts, faces


def _transform_points(matrix: np.ndarray, points: np.ndarray) -> np.ndarray:
    return points @ matrix[:3, :3].T + matrix[:3, 3]


def _frame_color(rel_idx: float) -> Tuple[float, float, float, float]:
    """gist_rainbow-like hue ramp over [0, 1] without requiring matplotlib."""
    try:
        import matplotlib

        r, g, b, a = matplotlib.colormaps["gist_rainbow"](float(rel_idx))
        return (float(r), float(g), float(b), 1.0)
    except Exception:
        import colorsys

        r, g, b = colorsys.hsv_to_rgb(0.9 * float(rel_idx), 1.0, 1.0)
        return (r, g, b, 1.0)


def predictions_to_glb(
    predictions: Dict[str, np.ndarray],
    filter_by_frames: str = "all",
    show_cam: bool = True,
    max_depth: float = 100.0,
    rtol: float = 0.03,
    frame_rel_idx: float = 0.0,
) -> _GlbBuilder:
    """Build a GLB scene from model predictions.

    ``predictions`` needs: ``world_points`` (S, H, W, 3), ``images`` (S, H, W, 3)
    in [0, 1] (or NCHW), ``depths`` (S, H, W), ``camera_poses`` (S, 4, 4).
    Points beyond ``max_depth`` or on depth discontinuities (``depth_edge`` with
    relative tolerance ``rtol``) are dropped, matching the reference's flying-
    pixel filter (``visualize_utils.py:78-81``). Call ``.write(path)`` on the
    result.
    """
    from aether_tpu_torch.geometry.edges import depth_edge

    if not isinstance(predictions, dict):
        raise ValueError("predictions must be a dictionary")

    selected = None
    if filter_by_frames not in ("all", "All"):
        try:
            selected = int(str(filter_by_frames).split(":")[0])
        except (ValueError, IndexError):
            pass

    world_points = np.asarray(predictions["world_points"])
    images = np.asarray(predictions["images"])
    camera_poses = np.asarray(predictions["camera_poses"])
    depths = np.asarray(predictions["depths"])

    if selected is not None:
        world_points = world_points[selected][None]
        images = images[selected][None]
        camera_poses = camera_poses[selected][None]
        depths = depths[selected][None]

    if images.ndim == 4 and images.shape[1] == 3:  # NCHW -> NHWC
        images = np.transpose(images, (0, 2, 3, 1))
    colors = (np.clip(images, 0, 1).reshape(-1, 3) * 255).astype(np.uint8)
    vertices = world_points.reshape(-1, 3)

    masks = depths < max_depth
    edge = ~np.asarray(depth_edge(depths, rtol=rtol, mask=masks))
    keep = (masks & edge).reshape(-1)
    vertices = vertices[keep]
    colors = colors[keep]

    if vertices.size == 0:
        vertices = np.array([[1.0, 0.0, 0.0]], np.float32)
        colors = np.array([[255, 255, 255]], np.uint8)
        scene_scale = 1.0
    else:
        lo = np.percentile(vertices, 5, axis=0)
        hi = np.percentile(vertices, 95, axis=0)
        scene_scale = float(np.linalg.norm(hi - lo))

    builder = _GlbBuilder()
    builder.add_point_cloud(vertices, colors)

    if show_cam:
        glyph_verts, glyph_faces = _camera_frustum_vertices(scene_scale)
        color = _frame_color(frame_rel_idx)
        for pose in camera_poses:
            c2w = np.eye(4)
            c2w[:3, :4] = pose[:3, :4]
            transformed = _transform_points(c2w @ _OPENGL_FLIP, glyph_verts)
            builder.add_triangle_mesh(transformed, glyph_faces, color)

    return builder


def write_glb(path: str, predictions: Dict[str, np.ndarray], **kwargs) -> None:
    predictions_to_glb(predictions, **kwargs).write(path)

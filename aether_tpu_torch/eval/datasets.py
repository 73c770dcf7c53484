"""Benchmark dataset registries and ground-truth readers.

Capability parity with reference ``evaluation/video_depth/metadata.py``,
``evaluation/rel_pose/metadata.py``, the per-dataset GT readers embedded in
``evaluation/video_depth/eval_depth.py`` (Sintel ``.dpt`` TAG_FLOAT ``:52-70``,
Bonn 16-bit png / 5000 ``:245-253``, KITTI png / 256 ``:391-402``) and
``evaluation/rel_pose/evo_utils.py`` (Sintel ``.cam`` ``:17-37``, Replica
12/16-column ``:40-66``, TUM ``:112-116``).

Copy of ``aether_tpu/eval/datasets.py`` (numpy and scipy; ``cv2`` is
imported only to read PNG depth).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

TAG_FLOAT = 202021.25  # Sintel binary-file magic


# ---------------------------------------------------------------------------
# depth GT readers
# ---------------------------------------------------------------------------


def read_sintel_depth(path: str) -> np.ndarray:
    """Sintel ``.dpt``: float32 magic, int32 w/h, row-major float32 depth."""
    with open(path, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        assert check == TAG_FLOAT, (
            f"wrong tag in {path} (expected {TAG_FLOAT}, got {check}); "
            "big-endian machine?"
        )
        width = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        height = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        size = width * height
        assert 1 < size < 100000000, f"bad size in {path}: {width}x{height}"
        return np.fromfile(f, dtype=np.float32, count=-1).reshape(height, width)


def read_bonn_depth(path: str) -> np.ndarray:
    """Bonn RGBD: 16-bit png, depth = value / 5000 m."""
    import cv2

    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
    return raw.astype(np.float64) / 5000.0


def read_kitti_depth(path: str) -> np.ndarray:
    """KITTI depth-selection: 16-bit png, depth = value / 256 m, 0 = invalid."""
    import cv2

    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
    return raw.astype(np.float64) / 256.0


# ---------------------------------------------------------------------------
# trajectory GT readers (all return TUM-convention (N,7)+(N,) tuples)
# ---------------------------------------------------------------------------


def read_sintel_cam(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Sintel ``.cam``: magic, 3x3 float64 intrinsic M, 3x4 float64 w2c N."""
    with open(path, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        assert check == TAG_FLOAT, f"wrong tag in {path}"
        m = np.fromfile(f, dtype=np.float64, count=9).reshape(3, 3)
        n = np.fromfile(f, dtype=np.float64, count=12).reshape(3, 4)
    return m, n


def load_sintel_traj(cam_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Directory of per-frame .cam files -> TUM traj (w2c inverted to c2w,
    positions mean-centered, reference ``evo_utils.py:69-98``)."""
    from scipy.spatial.transform import Rotation

    files = sorted(
        os.path.join(cam_dir, x) for x in os.listdir(cam_dir) if x.endswith(".cam")
    )
    stamps = [float(os.path.basename(x)[:-4].split("_")[-1]) for x in files]
    rows = []
    for path in files:
        _, n = read_sintel_cam(path)
        w2c = np.concatenate([n, [[0, 0, 0, 1]]], axis=0)
        c2w = np.linalg.inv(w2c)
        quat = Rotation.from_matrix(c2w[:3, :3]).as_quat()  # xyzw
        rows.append(np.concatenate([c2w[:3, 3], quat]))
    traj = np.stack(rows)
    traj[:, :3] -= traj[:, :3].mean(axis=0, keepdims=True)
    return traj, np.asarray(stamps, np.float64)


def load_replica_traj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Replica: one 12- or 16-column row-major c2w matrix per line."""
    from scipy.spatial.transform import Rotation

    mat = np.loadtxt(path)
    assert mat.shape[1] in (12, 16), f"bad replica traj width {mat.shape[1]}"
    rows = []
    for r in mat:
        pose = np.eye(4)
        pose[:3, :4] = r[:12].reshape(3, 4)
        quat = Rotation.from_matrix(pose[:3, :3]).as_quat()
        rows.append(np.concatenate([pose[:3, 3], quat]))
    traj = np.stack(rows)
    return traj, np.arange(len(traj), dtype=np.float64)


def load_tum_traj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    from aether_tpu_torch.eval.pose_metrics import load_tum_file

    return load_tum_file(path)


def load_scannet_traj(pose_dir: str, stride: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """ScanNet: per-frame ``<idx>.txt`` 4x4 c2w pose files in a directory."""
    from scipy.spatial.transform import Rotation

    files = sorted(
        glob.glob(os.path.join(pose_dir, "*.txt")),
        key=lambda p: int(os.path.splitext(os.path.basename(p))[0]),
    )[::stride]
    rows, stamps = [], []
    for path in files:
        pose = np.loadtxt(path).reshape(4, 4)
        if not np.all(np.isfinite(pose)):
            continue
        quat = Rotation.from_matrix(pose[:3, :3]).as_quat()
        rows.append(np.concatenate([pose[:3, 3], quat]))
        stamps.append(float(os.path.splitext(os.path.basename(path))[0]))
    return np.stack(rows), np.asarray(stamps, np.float64)


def load_traj(gt_file: str, traj_format: str = "sintel", skip: int = 0,
              stride: int = 1, num_frames: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Dispatching loader, reference ``evo_utils.py:101-126``."""
    if traj_format == "replica":
        traj, stamps = load_replica_traj(gt_file)
    elif traj_format == "sintel":
        traj, stamps = load_sintel_traj(gt_file)
    elif traj_format in ("tum", "tartanair"):
        traj, stamps = load_tum_traj(gt_file)
    elif traj_format == "scannet":
        traj, stamps = load_scannet_traj(gt_file)
    else:
        raise ValueError(f"unknown trajectory format {traj_format!r}")
    traj, stamps = traj[skip::stride], stamps[skip::stride]
    if num_frames is not None:
        traj, stamps = traj[:num_frames], stamps[:num_frames]
    return traj, stamps


# ---------------------------------------------------------------------------
# registries (paths are defaults relative to a --data_root)
# ---------------------------------------------------------------------------

SINTEL_SEQS = [
    "alley_2", "ambush_4", "ambush_5", "ambush_6", "cave_2", "cave_4",
    "market_2", "market_5", "market_6", "shaman_3", "sleeping_1",
    "sleeping_2", "temple_2", "temple_3",
]
BONN_SEQS = ["balloon2", "crowd2", "crowd3", "person_tracking2", "synchronous"]
TUM_SEQS = [
    "360", "desk", "desk2", "floor", "plant", "room", "rpy", "teddy", "xyz",
]

VIDEO_DEPTH_DATASETS: Dict[str, dict] = {
    "kitti": {
        "img_path": "kitti/depth_selection/val_selection_cropped/image_gathered",
        "depth_path": "kitti/depth_selection/val_selection_cropped/groundtruth_depth_gathered",
        "depth_read": read_kitti_depth,
        "depth_ext": ".png",
        "seq_list": None,  # full_seq: every directory under img_path
        "full_seq": True,
        "max_depth": 80.0,
    },
    "bonn": {
        "img_path": "bonn/rgbd_bonn_dataset",
        "depth_path": "bonn/rgbd_bonn_dataset",
        "dir_path": lambda img_path, seq: os.path.join(
            img_path, f"rgbd_bonn_{seq}", "rgb_110"
        ),
        "depth_dir_path": lambda depth_path, seq: os.path.join(
            depth_path, f"rgbd_bonn_{seq}", "depth_110"
        ),
        "depth_read": read_bonn_depth,
        "depth_ext": ".png",
        "seq_list": BONN_SEQS,
        "full_seq": False,
        "max_depth": 10.0,
    },
    "sintel": {
        "img_path": "sintel/training/final",
        "depth_path": "sintel/training/depth",
        "depth_read": read_sintel_depth,
        "depth_ext": ".dpt",
        "seq_list": SINTEL_SEQS,
        "full_seq": False,
        "max_depth": 70.0,
    },
}

def _scannet_entry(img_path: str) -> dict:
    """One ScanNet registry row; the reference keeps five strided copies of
    the dataset (full / 257 / 129 / 65 / 33 frames per window, see
    ``evaluation/rel_pose/metadata.py:9-78``), identical except for
    ``img_path``.  Poses ship as one replica-format ``pose_90.txt`` per
    sequence, subsampled in lockstep with the ``color_90`` frames."""
    return {
        "img_path": img_path,
        "gt_traj": lambda img_path, anno_path, seq: os.path.join(
            img_path, seq, "pose_90.txt"
        ),
        "dir_path": lambda img_path, seq: os.path.join(img_path, seq, "color_90"),
        "traj_format": "replica",
        "seq_list": None,
        "full_seq": True,
    }


REL_POSE_DATASETS: Dict[str, dict] = {
    "sintel": {
        "img_path": "sintel/training/final",
        "anno_path": "sintel/training/camdata_left",
        "gt_traj": lambda img_path, anno_path, seq: os.path.join(anno_path, seq),
        "traj_format": "sintel",
        "seq_list": SINTEL_SEQS,
        "full_seq": True,
    },
    # reference ``rel_pose/metadata.py:79-92``: 90-frame subsampled TUM dump,
    # one ``rgb_90`` dir + ``groundtruth_90.txt`` per sequence directory.
    "tum": {
        "img_path": "tum",
        "gt_traj": lambda img_path, anno_path, seq: os.path.join(
            img_path, seq, "groundtruth_90.txt"
        ),
        "dir_path": lambda img_path, seq: os.path.join(img_path, seq, "rgb_90"),
        "traj_format": "tum",
        "seq_list": None,
        "full_seq": True,
    },
    "scannet": _scannet_entry("scannetv2"),
    "scannet-257": _scannet_entry("scannetv2_3_257"),
    "scannet-129": _scannet_entry("scannetv2_3_129"),
    "scannet-65": _scannet_entry("scannetv2_3_65"),
    "scannet-33": _scannet_entry("scannetv2_3_33"),
}


def list_sequences(meta: dict, img_path: str,
                   seq_list: Optional[List[str]] = None) -> List[str]:
    """Resolve the sequence list: explicit > registry > directory scan."""
    if seq_list:
        return sorted(seq_list)
    if meta.get("seq_list"):
        dir_path = meta.get("dir_path", lambda p, s: os.path.join(p, s))
        # tolerate partially-downloaded datasets: keep only present sequences
        return sorted(
            s for s in meta["seq_list"] if os.path.isdir(dir_path(img_path, s))
        )
    return sorted(
        d for d in os.listdir(img_path)
        if os.path.isdir(os.path.join(img_path, d))
    )


def sequence_frames(meta: dict, img_path: str, seq: str,
                    stride: int = 1) -> List[str]:
    """Sorted image file list for one sequence."""
    dir_path = meta.get("dir_path", lambda p, s: os.path.join(p, s))(
        img_path, seq
    )
    files = sorted(
        os.path.join(dir_path, f)
        for f in os.listdir(dir_path)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    return files[::stride]

"""Canned camera actions: generate raymap conditioning from named motions.

Port of ``aether_tpu/apps/actions.py`` over the port's
:func:`~aether_tpu_torch.geometry.raymap.camera_pose_to_raymap` (run on the
CPU: the raymap is a small host-side condition, returned as numpy).

The reference ships four pre-baked raymap ``.npy`` assets for the prediction
task (``scripts/demo_gradio.py:1554-1560``: backward / forward_right /
left_forward / right, loaded at ``:653``; the demo CLI takes them via
``--raymap_action``). Rather than shipping opaque binaries, this module
*constructs* them — a camera trajectory builder plus
:func:`camera_pose_to_raymap` — so arbitrary
motions (speed, arc, frame count, fov) are scriptable.

Convention: camera looks down +z in its own frame (the codec's unprojection
convention); a "forward" motion translates along +z, "right" along +x.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from aether_tpu_torch.geometry.raymap import camera_pose_to_raymap


def _yaw(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def trajectory(
    num_frames: int,
    forward: float = 0.0,
    right: float = 0.0,
    yaw_deg: float = 0.0,
) -> np.ndarray:
    """(F, 4, 4) c2w poses moving ``forward``/``right`` meters in total while
    turning ``yaw_deg`` degrees, constant velocity, starting at identity."""
    poses = np.broadcast_to(np.eye(4), (num_frames, 4, 4)).copy()
    ts = np.linspace(0.0, 1.0, num_frames)
    for i, t in enumerate(ts):
        rot = _yaw(np.radians(yaw_deg) * t)
        poses[i, :3, :3] = rot
        # integrate translation along the (turning) heading
        poses[i, :3, 3] = rot @ np.array([right * t, 0.0, forward * t])
    return poses


# The four canonical actions the reference offers, as (forward, right, yaw).
NAMED_ACTIONS: Dict[str, dict] = {
    "forward": dict(forward=2.0),
    "backward": dict(forward=-2.0),
    "right": dict(right=2.0),
    "left": dict(right=-2.0),
    "forward_right": dict(forward=2.0, right=1.0, yaw_deg=-20.0),
    "left_forward": dict(forward=1.0, right=-2.0, yaw_deg=20.0),
    "turn_left": dict(yaw_deg=60.0),
    "turn_right": dict(yaw_deg=-60.0),
}


def action_raymap(
    name_or_kwargs,
    num_frames: int = 41,
    height: int = 480,
    width: int = 720,
    hfov_deg: float = 60.0,
    vae_downsample: int = 8,
) -> np.ndarray:
    """Build an (F, 6, H/8, W/8) raymap for a named or custom camera motion."""
    kwargs = (NAMED_ACTIONS[name_or_kwargs]
              if isinstance(name_or_kwargs, str) else dict(name_or_kwargs))
    poses = trajectory(num_frames, **kwargs)
    focal = 0.5 * width / np.tan(0.5 * np.radians(hfov_deg))
    intrinsic = np.broadcast_to(
        np.array(
            [[focal, 0.0, width / 2.0],
             [0.0, focal, height / 2.0],
             [0.0, 0.0, 1.0]]
        ),
        (num_frames, 3, 3),
    ).copy()
    raymap = camera_pose_to_raymap(
        poses, intrinsic, height=height, width=width,
        vae_downsample=vae_downsample,
    )
    return raymap.cpu().numpy().astype(np.float32)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Generate canned raymap action .npy files"
    )
    p.add_argument("--out_dir", type=str, default="assets/example_raymaps")
    p.add_argument("--actions", nargs="*", default=sorted(NAMED_ACTIONS))
    p.add_argument("--num_frames", type=int, default=41)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=720)
    args = p.parse_args(argv)

    import os

    os.makedirs(args.out_dir, exist_ok=True)
    for name in args.actions:
        raymap = action_raymap(name, args.num_frames, args.height, args.width)
        path = os.path.join(args.out_dir, f"raymap_{name}.npy")
        np.save(path, raymap)
        print(f"{path}: {raymap.shape}")


if __name__ == "__main__":
    main()

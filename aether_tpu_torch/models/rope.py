"""3D rotary position embeddings for (t, h, w) video tokens.

Semantics match reference ``aetherv1_pipeline_cogvideox.py:25-163`` and the upstream
1D RoPE it builds on: head_dim is split dim_t = d/4, dim_h = dim_w = 3d/8; the
temporal grid is scaled by ``fps_factor = base_fps / fps`` for variable-fps inference
(``:89,:97,:331,:345``); cos/sin use interleaved-pair ("repeat_interleave") layout so
rotation acts on (x0,x1), (x2,x3), ... channel pairs.

Everything here is host-side precomputation per (frames, height, width, fps) — the
resulting (S_video, head_dim) cos/sin tables are closed over by the jitted DiT.

Copy of ``aether_tpu/models/rope.py`` (numpy only); the port's tests pin
identical tables.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from aether_tpu_torch.config import DiTConfig


def get_resize_crop_region_for_grid(
    src: Tuple[int, int], tgt_width: int, tgt_height: int
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Aspect-preserving resize-crop coordinates on the RoPE base grid."""
    th, tw = tgt_height, tgt_width
    h, w = src
    r = h / w
    if r > (th / tw):
        resize_height = th
        resize_width = int(round(th / h * w))
    else:
        resize_width = tw
        resize_height = int(round(tw / w * h))
    crop_top = int(round((th - resize_height) / 2.0))
    crop_left = int(round((tw - resize_width) / 2.0))
    return (crop_top, crop_left), (crop_top + resize_height, crop_left + resize_width)


def get_1d_rotary_pos_embed(
    dim: int, pos: np.ndarray, theta: float = 10000.0
) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables (len(pos), dim) in interleaved-pair layout."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    angles = np.outer(np.asarray(pos, dtype=np.float64), freqs)  # (S, dim/2)
    cos = np.repeat(np.cos(angles), 2, axis=1)
    sin = np.repeat(np.sin(angles), 2, axis=1)
    return cos.astype(np.float32), sin.astype(np.float32)


def get_3d_rotary_pos_embed(
    embed_dim: int,
    crops_coords: Optional[Tuple[Tuple[int, int], Tuple[int, int]]],
    grid_size: Tuple[int, int],
    temporal_size: int,
    theta: float = 10000.0,
    grid_type: str = "linspace",
    max_size: Optional[Tuple[int, int]] = None,
    fps_factor: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(T*H*W, embed_dim) cos/sin tables with dim split d/4 | 3d/8 | 3d/8."""
    grid_size_h, grid_size_w = grid_size
    if grid_type == "linspace":
        start, stop = crops_coords
        grid_h = np.linspace(
            start[0], stop[0] * (grid_size_h - 1) / grid_size_h, grid_size_h,
            dtype=np.float64,
        )
        grid_w = np.linspace(
            start[1], stop[1] * (grid_size_w - 1) / grid_size_w, grid_size_w,
            dtype=np.float64,
        )
        grid_t = (
            np.linspace(
                0, temporal_size * (temporal_size - 1) / temporal_size, temporal_size,
                dtype=np.float64,
            )
            * fps_factor
        )
    elif grid_type == "slice":
        max_h, max_w = max_size
        grid_h = np.arange(max_h, dtype=np.float64)
        grid_w = np.arange(max_w, dtype=np.float64)
        grid_t = np.arange(temporal_size, dtype=np.float64) * fps_factor
    else:
        raise ValueError(f"Invalid grid_type: {grid_type}")

    dim_t = embed_dim // 4
    dim_h = embed_dim // 8 * 3
    dim_w = embed_dim // 8 * 3

    t_cos, t_sin = get_1d_rotary_pos_embed(dim_t, grid_t, theta)
    h_cos, h_sin = get_1d_rotary_pos_embed(dim_h, grid_h, theta)
    w_cos, w_sin = get_1d_rotary_pos_embed(dim_w, grid_w, theta)

    if grid_type == "slice":
        t_cos, t_sin = t_cos[:temporal_size], t_sin[:temporal_size]
        h_cos, h_sin = h_cos[:grid_size_h], h_sin[:grid_size_h]
        w_cos, w_sin = w_cos[:grid_size_w], w_sin[:grid_size_w]

    def combine(ft: np.ndarray, fh: np.ndarray, fw: np.ndarray) -> np.ndarray:
        t, h, w = len(ft), len(fh), len(fw)
        ft = np.broadcast_to(ft[:, None, None, :], (t, h, w, ft.shape[-1]))
        fh = np.broadcast_to(fh[None, :, None, :], (t, h, w, fh.shape[-1]))
        fw = np.broadcast_to(fw[None, None, :, :], (t, h, w, fw.shape[-1]))
        return np.concatenate([ft, fh, fw], axis=-1).reshape(t * h * w, -1)

    return combine(t_cos, h_cos, w_cos), combine(t_sin, h_sin, w_sin)


def prepare_rotary_positional_embeddings(
    cfg: DiTConfig,
    height: int,
    width: int,
    num_latent_frames: int,
    vae_scale_factor_spatial: int = 8,
    base_fps: int = 12,
    fps: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pipeline-level RoPE builder (reference ``pipeline:299-348``).

    ``num_latent_frames`` is the latent temporal length (latents.size(1) in the
    reference). Returns (cos, sin) of shape (F * H/(8p) * W/(8p), head_dim).
    """
    fps = fps or base_fps
    p = cfg.patch_size
    grid_height = height // (vae_scale_factor_spatial * p)
    grid_width = width // (vae_scale_factor_spatial * p)
    base_size_width = cfg.sample_width // p
    base_size_height = cfg.sample_height // p

    if cfg.patch_size_t is None:
        grid_crops_coords = get_resize_crop_region_for_grid(
            (grid_height, grid_width), base_size_width, base_size_height
        )
        return get_3d_rotary_pos_embed(
            embed_dim=cfg.head_dim,
            crops_coords=grid_crops_coords,
            grid_size=(grid_height, grid_width),
            temporal_size=num_latent_frames,
            theta=cfg.rope_theta,
            fps_factor=base_fps / fps,
        )
    base_num_frames = (num_latent_frames + cfg.patch_size_t - 1) // cfg.patch_size_t
    return get_3d_rotary_pos_embed(
        embed_dim=cfg.head_dim,
        crops_coords=None,
        grid_size=(grid_height, grid_width),
        temporal_size=base_num_frames,
        theta=cfg.rope_theta,
        grid_type="slice",
        max_size=(base_size_height, base_size_width),
        fps_factor=base_fps / fps,
    )

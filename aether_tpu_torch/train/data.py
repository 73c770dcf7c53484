"""Training data pipeline: latent precompute + shuffled batch loading.

Port of ``aether_tpu/train/data.py``. The reference ships no training code or
data tooling; this module provides the standard video-diffusion recipe:

1. :func:`precompute_latents` — VAE-encode each clip's RGB and
   (sqrt-)disparity on the pipeline's device, encode camera poses to packed
   raymap latents, and write one ``.npz`` per clip. Encoding once amortizes
   the VAE over every epoch and keeps the training step on the DiT.
2. :func:`latent_batches` — an infinite shuffled iterator of training batches
   (clean_latents 56ch / condition_latents 40ch / text_embeds / rope tables)
   matching :meth:`aether_tpu_torch.train.trainer.Trainer.fit`'s contract,
   sharded across hosts with
   :func:`aether_tpu_torch.eval.sharding.shard_sequences`. By default the
   files are read and inflated ahead of the consumer on the C++ thread pool
   of :mod:`aether_tpu_torch.runtime`.

Depth supervision inputs follow the reference's encoding: disparity is
sqrt-compressed before VAE encode (``postprocess_utils.py:964-987``), and the
camera raymap folds 4-to-1 into 24 latent channels (``pipeline:666-670``).
The files, their keys and dtypes, and the batches are the JAX module's: a
file written by either package trains either trainer.
"""

from __future__ import annotations

import glob
import os
from collections import deque
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from aether_tpu_torch.eval.sharding import shard_sequences
from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings
from aether_tpu_torch.utils.profiling import stage_timer

# the modalities a clip's posterior draws are keyed by (JAX: fold_in(key, m))
RGB, DISPARITY = 0, 1


class LatentNoise:
    """The posterior draws of :func:`precompute_latents`: one
    ``torch.Generator`` on the device for each (seed, clip index, modality),
    so a clip's latents depend on its index and the seed only, as the JAX
    function's ``fold_in(fold_in(PRNGKey(seed), i), m)`` keys do. A caller
    may pass any object with this ``posterior`` method instead (the parity
    tests hand in the JAX draws)."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def posterior(self, clip: int, modality: int, shape) -> torch.Tensor:
        """Channels-last f32 (1, F_lat, h, w, C) noise of clip ``clip``'s
        ``modality`` (:data:`RGB` or :data:`DISPARITY`)."""
        state = np.random.SeedSequence([self.seed, clip, modality]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(state))
        return torch.randn(tuple(shape), generator=gen, device=self.device,
                           dtype=torch.float32)


def _to_host_f32(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


@torch.no_grad()
def precompute_latents(
    pipeline,
    clips: Sequence[dict],
    out_dir: str,
    fps: int = 12,
    seed: int = 0,
    noise=None,
) -> list:
    """Encode training clips to latent ``.npz`` files.

    Each clip dict: {"name": str, "rgb": (F, H, W, 3) [0, 1],
    "disparity": optional (F, H, W) [0, 1], "poses": optional (F, 4, 4),
    "intrinsics": optional (F, 3, 3), "text_embeds": optional}.

    Runs on ``pipeline.device`` in ``pipeline.compute_dtype``. The VAE is not
    tiled: 8-frame framewise chunks over the whole frame, as the JAX function
    encodes (its latents are the training latents' numerics). ``noise``
    (default :class:`LatentNoise` of ``seed`` on the pipeline's device) gives
    the posterior draws by clip index and modality. Each clip's encode and
    its file write run inside ``stage_timer("precompute_encode")`` and
    ``stage_timer("precompute_write")``. Returns the written paths.
    """
    from aether_tpu_torch.geometry.raymap import camera_pose_to_raymap
    from aether_tpu_torch.pipeline.aether import _encode_pixels, pack_raymap
    from aether_tpu_torch.utils.preprocess import preprocess_video

    cfg = pipeline.config
    dtype, dev = pipeline.compute_dtype, pipeline.device
    if noise is None:
        noise = LatentNoise(seed, dev)
    os.makedirs(out_dir, exist_ok=True)

    def encode(pixels: np.ndarray, i: int, modality: int) -> torch.Tensor:
        # f32 pixels in [-1, 1], cast to the compute dtype on the device, as
        # the JAX chunk encode casts its input
        frames = torch.from_numpy(pixels).to(dev).to(dtype)
        return _encode_pixels(cfg, dtype, pipeline.vae, frames,
                              lambda shape: noise.posterior(i, modality, shape),
                              tiling=False)

    written = []
    for i, clip in enumerate(clips):
        rgb = np.asarray(clip["rgb"])
        f, h, w = rgb.shape[:3]
        with stage_timer("precompute_encode", log=False):
            rgb_lat = encode(preprocess_video(rgb, h, w), i, RGB)

            if clip.get("disparity") is not None:
                disp = np.sqrt(np.clip(np.asarray(clip["disparity"]), 0.0, 1.0))
                disp3 = np.repeat(disp[..., None] * 2.0 - 1.0, 3, axis=-1)
                disp_lat = encode(disp3.astype(np.float32), i, DISPARITY)
            else:
                disp_lat = torch.zeros_like(rgb_lat)

            if clip.get("poses") is not None:
                raymap = camera_pose_to_raymap(
                    torch.as_tensor(np.asarray(clip["poses"]), dtype=torch.float32,
                                    device=dev),
                    torch.as_tensor(np.asarray(clip["intrinsics"]), dtype=torch.float32,
                                    device=dev),
                    height=h, width=w, vae_downsample=cfg.vae_scale_factor_spatial,
                )
                # rounded to the compute dtype before the f16 file, as in JAX
                camera = pack_raymap(raymap[None].to(dtype))
            else:
                camera = torch.zeros((1, rgb_lat.shape[1], 24, *rgb_lat.shape[-2:]),
                                     dtype=dtype, device=dev)

            clean = np.concatenate(
                [_to_host_f32(rgb_lat), _to_host_f32(disp_lat), _to_host_f32(camera)],
                axis=2,
            )[0]
        text = clip.get("text_embeds")
        path = os.path.join(out_dir, f"{clip.get('name', f'clip_{i:05d}')}.npz")
        with stage_timer("precompute_write", log=False):
            np.savez_compressed(
                path,
                clean_latents=clean.astype(np.float16),
                num_frames=np.asarray(f),
                height=np.asarray(h),
                width=np.asarray(w),
                fps=np.asarray(fps),
                text_embeds=np.asarray(np.zeros((0,)) if text is None else text,
                                       np.float16),
            )
        written.append(path)
    return written


def _np_load(path: str) -> Dict[str, np.ndarray]:
    """Every array of an ``.npz`` file, read with ``np.load``; the file is
    closed on return."""
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def _conditioning_from_clean(
    clean: np.ndarray, rng: np.random.Generator, task_probs=(0.5, 0.3, 0.2)
) -> np.ndarray:
    """Build 40-ch condition latents from 56-ch targets with task-mixture
    masking: reconstruction keeps all content frames, prediction keeps frame 0,
    planning keeps first+last (mirrors the three inference conditionings)."""
    f = clean.shape[0]
    content = clean[:, :16].copy()
    camera = clean[:, 32:]
    task = rng.choice(3, p=task_probs)
    if task == 1 and f > 1:  # prediction: only frame 0 observed
        content[1:] = 0.0
    elif task == 2 and f > 2:  # planning: first + last observed
        content[1:-1] = 0.0
    return np.concatenate([content, camera], axis=1)


def latent_batches(
    latent_dir: str,
    dit_cfg,
    batch_size: int = 1,
    seed: int = 0,
    text_embeds: Optional[np.ndarray] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    base_fps: int = 12,
    native_prefetch: bool = True,
    prefetch_batches: int = 3,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite shuffled iterator over precomputed latent ``.npz`` files.

    With ``native_prefetch`` (default), file reads and zlib inflation run on
    the C++ thread pool of :mod:`aether_tpu_torch.runtime` (two threads),
    ``prefetch_batches`` batches ahead of the consumer: the next batch
    decodes while the device steps. When the native library cannot be built,
    this raises ``RuntimeError`` with the build's reason (the JAX loader
    falls back to ``np.load`` without a word); ``native_prefetch=False``
    reads synchronously with ``np.load``. Both routes give the same batches,
    equal to the JAX loader's: the conditioning-mask draws and the epoch
    permutations come from two numpy streams of ``seed``.
    """
    files = sorted(glob.glob(os.path.join(latent_dir, "*.npz")))
    if not files:
        raise FileNotFoundError(f"no .npz latents under {latent_dir}")
    files = shard_sequences(files, process_index, process_count)
    if len(files) < batch_size:
        raise ValueError(
            f"batch_size={batch_size} exceeds the {len(files)} latent files "
            f"in this shard of {latent_dir}"
        )
    rng = np.random.default_rng(seed)
    # separate stream for epoch permutations: the prefetcher draws the next
    # epoch's order ahead of the consumer, which must not perturb the
    # conditioning-mask draws from ``rng``
    order_rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    rope_cache: Dict[tuple, tuple] = {}

    def batch_paths_stream():
        while True:
            order = order_rng.permutation(len(files))
            for start in range(0, len(order) - batch_size + 1, batch_size):
                yield [files[j] for j in order[start : start + batch_size]]

    prefetcher = None
    if native_prefetch:
        from aether_tpu_torch import runtime

        if not runtime.available():
            raise RuntimeError(
                f"native_prefetch=True needs the native npz loader, which failed "
                f"to build: {runtime.build_error()} (pass native_prefetch=False, "
                "CLI: --no_native_prefetch, to read with np.load)")
        prefetcher = runtime.NpzPrefetcher(n_threads=2)
    paths_iter = batch_paths_stream()
    pending: deque = deque()
    try:
        while True:
            if prefetcher is not None:
                while len(pending) < max(1, prefetch_batches):
                    batch_paths = next(paths_iter)
                    for p in batch_paths:
                        prefetcher.submit(p)
                    pending.append(batch_paths)
                batch_paths = pending.popleft()
                items = [prefetcher.get() for _ in batch_paths]
            else:
                items = [_np_load(p) for p in next(paths_iter)]
            clean = np.stack(
                [it["clean_latents"].astype(np.float32) for it in items]
            )
            cond = np.stack(
                [_conditioning_from_clean(c, rng) for c in clean]
            )
            h = int(items[0]["height"])
            w = int(items[0]["width"])
            fps = int(items[0]["fps"])
            f_lat = clean.shape[1]
            rope_key = (h, w, f_lat, fps)
            if rope_key not in rope_cache:
                rope_cache[rope_key] = prepare_rotary_positional_embeddings(
                    dit_cfg, h, w, f_lat, base_fps=base_fps, fps=fps
                )
            cos, sin = rope_cache[rope_key]
            if text_embeds is not None:
                text = np.broadcast_to(
                    text_embeds.astype(np.float32),
                    (batch_size, *text_embeds.shape[-2:]),
                ).copy()
            else:
                text = np.zeros(
                    (batch_size, dit_cfg.max_text_seq_length,
                     dit_cfg.text_embed_dim), np.float32,
                )
            yield {
                "clean_latents": clean,
                "condition_latents": cond,
                "text_embeds": text,
                "rope_cos": cos,
                "rope_sin": sin,
            }
    finally:
        if prefetcher is not None:
            prefetcher.close()  # joins the worker threads

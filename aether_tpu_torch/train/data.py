"""Training data: shuffled batches of precomputed latents.

Port of ``aether_tpu/train/data.py`` on its synchronous ``np.load`` route.
:func:`latent_batches` keeps the JAX loader's two numpy streams (the
conditioning-mask draws and a separate stream for epoch permutations), so its
batches equal the JAX loader's with ``native_prefetch=False``. Not ported yet
(ROADMAP.md, Queue 1: ``precompute_latents`` and the native prefetcher): the
C++ prefetch thread pool (``native_prefetch=True`` raises, so the trainer's
command line needs ``--no_native_prefetch``) and ``precompute_latents``, whose
geometry and raymap packing the port has had since the long-video slice.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, Optional

import numpy as np

from aether_tpu_torch.eval.sharding import shard_sequences
from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings


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
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite shuffled iterator over precomputed latent ``.npz`` files.

    ``native_prefetch=True`` (the JAX default) needs the C++ prefetcher and
    raises ``NotImplementedError``; pass False to read with ``np.load``.
    """
    if native_prefetch:
        raise NotImplementedError(
            "native_prefetch needs the C++ prefetch thread pool (aether_tpu/"
            "runtime), not ported yet (ROADMAP.md, Queue 1: the native "
            "prefetcher); pass "
            "native_prefetch=False (CLI: --no_native_prefetch)")
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
    # separate stream for epoch permutations, so the order never perturbs
    # the conditioning-mask draws from ``rng``
    order_rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    rope_cache: Dict[tuple, tuple] = {}

    def batch_paths_stream():
        while True:
            order = order_rng.permutation(len(files))
            for start in range(0, len(order) - batch_size + 1, batch_size):
                yield [files[j] for j in order[start : start + batch_size]]

    paths_iter = batch_paths_stream()
    while True:
        items = [np.load(p) for p in next(paths_iter)]
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

"""Diffusion fine-tuning: the v-prediction loss and a train step.

Port of ``aether_tpu/train/step.py``. The CogVideoX zero-terminal-SNR schedule
(``schedule/dpm.py``) supplies (sqrt_alpha, sqrt_1m_alpha); the loss is the
v-prediction MSE. The parameters live in the ``DiT`` module and a step
updates them in place: ``loss.backward()``, then ``torch.optim.AdamW`` with
optax's ``adamw`` settings (eps 1e-8, eps_root 0, weight decay on every
parameter, biases and norms included). Random draws come from an explicit
``torch.Generator``; passing ``t`` and ``eps`` makes a step deterministic,
which is how the tests feed both frameworks the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from aether_tpu_torch.config import SchedulerConfig
from aether_tpu_torch.models.dit import DiT
from aether_tpu_torch.schedule.dpm import compute_alphas_cumprod


@dataclasses.dataclass
class TrainState:
    step: int
    model: DiT
    optimizer: torch.optim.Optimizer


def create_train_state(
    model: DiT,
    learning_rate: float = 1e-5,
    weight_decay: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.95,
) -> TrainState:
    """``optax.adamw(learning_rate, b1, b2, weight_decay=...)`` as
    ``torch.optim.AdamW`` over every parameter of ``model``."""
    opt = torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(b1, b2),
                            eps=1e-8, weight_decay=weight_decay)
    return TrainState(0, model, opt)


def noise_schedule(sched_cfg: SchedulerConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sqrt(alphas_cumprod), sqrt(1 - alphas_cumprod)): float64 on the host,
    then f32 on ``device``, as the JAX step builds them."""
    alphas = compute_alphas_cumprod(sched_cfg)
    return (torch.from_numpy(np.sqrt(alphas).astype(np.float32)).to(device),
            torch.from_numpy(np.sqrt(1.0 - alphas).astype(np.float32)).to(device))


def diffusion_loss(
    model: DiT,
    sqrt_alphas: torch.Tensor,
    sqrt_one_minus_alphas: torch.Tensor,
    clean_latents: torch.Tensor,  # [B, F, 56, h, w] target (rgb+disp+camera)
    condition_latents: torch.Tensor,  # [B, F, 40, h, w]
    text_embeds: torch.Tensor,  # [B, S_text, text_dim]
    rope_cos: Optional[torch.Tensor],
    rope_sin: Optional[torch.Tensor],
    generator: Optional[torch.Generator] = None,
    attn_impl: str = "xla",
    t: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
    remat: bool = False,
    block_scan=None,
) -> torch.Tensor:
    """v-prediction MSE at uniformly sampled timesteps.

    ``t`` / ``eps`` default to draws from ``generator`` (t first); passing
    them makes the loss deterministic. ``block_scan`` runs the DiT's blocks
    on another schedule (``parallel.pipeline.make_pipeline_block_scan``);
    the pipeline's ``seed_loss`` then weights the loss's gradient so that
    the head counts once over the stages."""
    b = clean_latents.shape[0]
    dev = clean_latents.device
    if t is None:
        t = torch.randint(0, sqrt_alphas.shape[0], (b,), generator=generator, device=dev)
    if eps is None:
        eps = torch.randn(clean_latents.shape, generator=generator, device=dev)
    x0 = clean_latents.float()
    a = sqrt_alphas[t][:, None, None, None, None]
    s = sqrt_one_minus_alphas[t][:, None, None, None, None]
    x_t = a * x0 + s * eps
    v_target = a * eps - s * x0
    model_in = torch.cat([x_t.to(clean_latents.dtype), condition_latents], dim=2)
    v_pred = model(model_in, text_embeds, t, rope_cos, rope_sin,
                   attn_impl=attn_impl, remat=remat, block_scan=block_scan).float()
    loss = torch.mean(torch.square(v_pred - v_target))
    if block_scan is not None and hasattr(block_scan, "seed_loss"):
        loss = block_scan.seed_loss(loss)
    return loss


def make_train_step(
    scheduler_cfg: SchedulerConfig,
    attn_impl: str = "xla",
    block_scan=None,
) -> Callable:
    """Build ``train_step(state, batch, generator=None, *, t=None, eps=None)
    -> loss``, which updates ``state`` in place.

    ``batch`` is a dict of tensors on the model's device: clean_latents /
    condition_latents / text_embeds / rope_cos / rope_sin. ``block_scan``
    swaps the DiT's block loop for the GPipe schedule
    (``parallel.pipeline.make_pipeline_block_scan``; the model holds its
    stage's blocks, ``parallel.pipeline.shard_blocks_pp``): the gradients
    are reduced over the pipeline (``block_scan.reduce_grads``) before the
    optimizer steps."""
    tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev = batch["clean_latents"].device
        if dev not in tables:
            tables[dev] = noise_schedule(scheduler_cfg, dev)
        state.optimizer.zero_grad(set_to_none=True)
        loss = diffusion_loss(
            state.model, *tables[dev], batch["clean_latents"],
            batch["condition_latents"], batch["text_embeds"],
            batch.get("rope_cos"), batch.get("rope_sin"), generator, attn_impl,
            t=t, eps=eps, block_scan=block_scan)
        loss.backward()
        if block_scan is not None and hasattr(block_scan, "reduce_grads"):
            block_scan.reduce_grads(state.model)
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    return train_step

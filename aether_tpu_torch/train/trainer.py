"""Training loop: LR schedule, clipping, accumulation, EMA, checkpoints.

Port of ``aether_tpu/train/trainer.py`` for one device. The optimizer is the
JAX ``make_optimizer`` over ``torch.optim.AdamW``, reproduced where a
plain PyTorch version would differ:

- the LR is ``optax.warmup_cosine_decay_schedule`` computed in float32 as
  optax computes it; it is 0 at count 0, so the first update moves nothing;
- ``optax.clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm >= max_norm``, with no epsilon (``clip_grad_norm_`` adds 1e-6);
- ``optax.MultiSteps(k)`` averages k mini-step gradients (a running mean);
  the inner update and the schedule's count advance once per k calls, while
  the EMA and ``state.step`` advance on every call.

Random draws come from a ``torch.Generator`` the Trainer owns, through a
replaceable noise source, so a test can feed it the JAX key stream.
Checkpoints are ``torch.save`` files ``step_{:08d}`` holding the parameters,
the EMA, the optimizer with its counters, the generator state and the step;
a new Trainer resumes from the newest one as an exact continuation.

CLI (``--device`` defaults to cuda; the CPU runs only when asked for):
    python -m aether_tpu_torch.train.trainer --synthetic --tiny --device cpu --steps 2
    python -m aether_tpu_torch.train.trainer --tiny --device cpu --latent_dir DIR --steps 3

``--latent_dir`` reads the files of ``train.data.precompute_latents``
through the native prefetch loader (``aether_tpu_torch/runtime``, built with
g++ at first use); ``--no_native_prefetch`` reads them with ``np.load``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from aether_tpu_torch.config import DiTConfig, SchedulerConfig
from aether_tpu_torch.models.dit import DiT, init_dit
from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings
from aether_tpu_torch.train.step import diffusion_loss, noise_schedule

# (clean_latents shape) -> (t [B] int64, eps f32 of that shape), on the device
NoiseSource = Callable[[Tuple[int, ...]], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    warmup_steps: int = 100
    total_steps: int = 10000
    grad_clip_norm: float = 1.0
    grad_accum_steps: int = 1
    ema_decay: float = 0.999
    remat: bool = True
    attn_impl: str = "xla"
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 500
    log_every: int = 10


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1), 0.1 * lr)`` as a function of the update count, in float32
    with optax's order of operations."""
    f32 = np.float32
    peak, end = cfg.learning_rate, 0.1 * cfg.learning_rate
    warmup = cfg.warmup_steps
    decay_steps = max(cfg.total_steps, warmup + 1) - warmup
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup:  # linear_schedule(0, peak, warmup)
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float(f32(0.0 - peak) * frac + f32(peak))
        c = f32(min(count - warmup, decay_steps))  # cosine_decay_schedule
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps)))
        return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: every g becomes
    ``g / norm * max_norm`` unless ``norm < max_norm``. Returns the norm."""
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    if not bool(norm < max_norm):
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


class Optimizer:
    """``make_optimizer``'s transformation over ``torch.optim.AdamW``:
    ``clip_by_global_norm`` then ``adamw(lr_schedule)``, inside
    ``MultiSteps(grad_accum_steps)`` when that is above 1.

    :meth:`update` is one call of the optax update, after ``backward()``."""

    def __init__(self, params, cfg: TrainConfig):
        self.params = list(params)
        self.adamw = torch.optim.AdamW(self.params, lr=0.0, betas=(cfg.b1, cfg.b2),
                                       eps=1e-8, weight_decay=cfg.weight_decay)
        self.schedule = lr_schedule(cfg)
        self.k = cfg.grad_accum_steps
        self.max_norm = cfg.grad_clip_norm
        self.count = 0      # inner updates so far: the schedule's count
        self.mini_step = 0  # calls since the last inner update
        self.acc: Optional[List[torch.Tensor]] = None  # mean of pending grads
        self.grad_norm: Optional[torch.Tensor] = None  # at the last update

    def update(self) -> bool:
        """Consume the parameters' ``.grad``; True when AdamW stepped."""
        grads = [p.grad for p in self.params]
        if self.k > 1:
            if self.mini_step == 0:
                self.acc = [g.detach().clone() for g in grads]
            else:
                for a, g in zip(self.acc, grads):
                    a.add_((g - a) / (self.mini_step + 1))
            emit = self.mini_step == self.k - 1
            self.mini_step = (self.mini_step + 1) % self.k
            if not emit:
                return False
            grads, self.acc = self.acc, None
            for p, g in zip(self.params, grads):
                p.grad = g
        self.grad_norm = clip_by_global_norm_(grads, self.max_norm)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        self.acc = state["acc"]


def make_optimizer(params, cfg: TrainConfig) -> Optimizer:
    return Optimizer(params, cfg)


@dataclasses.dataclass
class EmaTrainState:
    step: int
    model: DiT
    optimizer: Optimizer
    ema_params: Dict[str, torch.Tensor]


def make_ema_train_step(
    sched_cfg: SchedulerConfig,
    train_cfg: TrainConfig,
) -> Callable:
    """``train_step(state, batch, t, eps) -> loss``: loss and gradient, one
    optimizer call, then ``ema = decay * ema + (1 - decay) * params``; the
    state is updated in place."""
    decay = train_cfg.ema_decay
    tables: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def train_step(state: EmaTrainState, batch: Dict[str, torch.Tensor],
                   t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        dev = batch["clean_latents"].device
        if dev not in tables:
            tables[dev] = noise_schedule(sched_cfg, dev)
        model = state.model
        for p in model.parameters():
            p.grad = None
        loss = diffusion_loss(
            model, *tables[dev], batch["clean_latents"], batch["condition_latents"],
            batch["text_embeds"], batch.get("rope_cos"), batch.get("rope_sin"),
            attn_impl=train_cfg.attn_impl, t=t, eps=eps, remat=train_cfg.remat)
        loss.backward()
        state.optimizer.update()
        with torch.no_grad():
            for name, p in model.named_parameters():
                state.ema_params[name].mul_(decay).add_(p.float() * (1.0 - decay))
        state.step += 1
        return loss.detach()

    return train_step


def synthetic_batches(
    dit_cfg: DiTConfig,
    batch_size: int = 1,
    f_lat: int = 2,
    h_lat: int = 8,
    w_lat: int = 12,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Random latent batches with the real channel layout (56 + 40 + text);
    the JAX generator's numpy stream, so both frameworks get equal batches."""
    cos, sin = prepare_rotary_positional_embeddings(
        dit_cfg, h_lat * 8, w_lat * 8, f_lat, fps=12)
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "clean_latents": rng.normal(
                size=(batch_size, f_lat, 56, h_lat, w_lat)).astype(np.float32),
            "condition_latents": rng.normal(
                size=(batch_size, f_lat, 40, h_lat, w_lat)).astype(np.float32),
            "text_embeds": rng.normal(
                size=(batch_size, dit_cfg.max_text_seq_length,
                      dit_cfg.text_embed_dim)).astype(np.float32),
            "rope_cos": cos,
            "rope_sin": sin,
        }


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class Trainer:
    """Owns the model, optimizer, EMA, random draws, checkpoints and the loop.

    ``init_params``: a ``DiT`` state dict to start from (``io/from_jax.py``
    converts a JAX tree); otherwise ``init_dit`` draws f32 weights from
    ``seed``. ``noise``: the (t, eps) source; by default draws from the
    Trainer's generator (seeded with ``seed``), whose state checkpoints keep.
    """

    def __init__(
        self,
        dit_cfg: DiTConfig,
        train_cfg: TrainConfig,
        sched_cfg: Optional[SchedulerConfig] = None,
        *,
        device,
        init_params: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        noise: Optional[NoiseSource] = None,
    ):
        self.dit_cfg = dit_cfg
        self.train_cfg = train_cfg
        self.sched_cfg = sched_cfg or SchedulerConfig.aetherv1()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the Trainer was given a CUDA device and none is available")
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.noise = noise or self._draw
        if init_params is not None:
            with torch.device(self.device):
                model = DiT(dit_cfg)
            model.load_state_dict(init_params)
        else:
            model = init_dit(dit_cfg, device=self.device, dtype=torch.float32, seed=seed)
        self.state = EmaTrainState(
            step=0,
            model=model,
            optimizer=make_optimizer(model.parameters(), train_cfg),
            ema_params={n: p.detach().float().clone()
                        for n, p in model.named_parameters()},
        )
        self._step_fn = make_ema_train_step(self.sched_cfg, train_cfg)
        if train_cfg.checkpoint_dir:
            self.maybe_restore()

    def _draw(self, shape: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
        t = torch.randint(0, self.sched_cfg.num_train_timesteps, (shape[0],),
                          generator=self.gen, device=self.device)
        eps = torch.randn(shape, generator=self.gen, device=self.device)
        return t, eps

    # -- checkpointing ------------------------------------------------------
    def _ckpt_path(self, step: int) -> str:
        return os.path.join(os.path.abspath(self.train_cfg.checkpoint_dir),
                            f"step_{step:08d}")

    def save(self) -> str:
        path = self._ckpt_path(self.state.step)
        if os.path.exists(path):  # already checkpointed at this step
            return path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({
            "params": self.state.model.state_dict(),
            "ema_params": self.state.ema_params,
            # optimizer counters + generator state make restore an EXACT
            # continuation, as the JAX checkpoint's opt_state and key do
            "optimizer": self.state.optimizer.state_dict(),
            "generator": self.gen.get_state(),
            "step": self.state.step,
        }, tmp)
        os.replace(tmp, path)  # a reader never sees half a checkpoint
        return path

    def maybe_restore(self) -> Optional[int]:
        root = self.train_cfg.checkpoint_dir
        if not root or not os.path.isdir(root):
            return None
        steps = sorted(int(name.split("_")[-1]) for name in os.listdir(root)
                       if name.startswith("step_") and name.split("_")[-1].isdigit())
        if not steps:
            return None
        ckpt = torch.load(self._ckpt_path(steps[-1]), map_location=self.device,
                          weights_only=True)
        self.state.model.load_state_dict(ckpt["params"])
        with torch.no_grad():
            for name, e in self.state.ema_params.items():
                e.copy_(ckpt["ema_params"][name])
        self.state.optimizer.load_state_dict(ckpt["optimizer"])
        self.gen.set_state(ckpt["generator"].cpu())
        self.state.step = int(ckpt["step"])
        return steps[-1]

    # -- loop ---------------------------------------------------------------
    def fit(self, batches: Iterator[Dict[str, np.ndarray]],
            steps: Optional[int] = None) -> list:
        cfg = self.train_cfg
        total = steps if steps is not None else cfg.total_steps
        losses = []
        t0 = time.time()
        for i in range(total):
            batch = batch_to_device(next(batches), self.device)
            t, eps = self.noise(tuple(batch["clean_latents"].shape))
            loss = self._step_fn(self.state, batch, t, eps)
            if (i + 1) % cfg.log_every == 0 or i == total - 1:
                loss_val = float(loss)
                losses.append(loss_val)
                rate = (i + 1) / (time.time() - t0)
                print(f"step {self.state.step}: loss={loss_val:.4f} "
                      f"({rate:.2f} it/s)", flush=True)
            if cfg.checkpoint_dir and (i + 1) % cfg.checkpoint_every == 0:
                print(f"saved {self.save()}", flush=True)
        if cfg.checkpoint_dir:
            self.save()
        return losses


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="AetherV1 trainer (PyTorch)")
    p.add_argument("--synthetic", action="store_true",
                   help="Train on random latents (smoke/throughput runs).")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to train on (default cuda; cpu only when asked).")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--checkpoint_every", type=int, default=500)
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--tp", type=int, default=None)
    p.add_argument("--pp", type=int, default=None)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--init_checkpoint", type=str, default=None,
                   help="Converted DiT checkpoint to fine-tune from.")
    p.add_argument("--latent_dir", type=str, default=None,
                   help="Directory of precomputed latent .npz files "
                        "(train.data.precompute_latents); trains on real "
                        "data with the shuffled native-prefetch loader.")
    p.add_argument("--text_embeds", type=str, default=None,
                   help="Optional .npy with a baked (S, D) text embedding "
                        "broadcast to every real-data batch (default: "
                        "zeros, matching the empty-prompt conditioning).")
    p.add_argument("--no_native_prefetch", action="store_true",
                   help="Read latent files synchronously with np.load "
                        "instead of the C++ prefetch thread pool.")
    p.add_argument("--data_seed", type=int, default=0)
    args = p.parse_args(argv)

    for flag in ("dp", "tp", "pp", "fsdp"):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag}: parallel training (FSDP on dp, the pp schedule) is not "
                "ported yet; the parallel layer covers inference (ROADMAP.md, queue 1: "
                "Parallel, training)")
    init_params = None
    if args.init_checkpoint:
        from aether_tpu_torch.io.weights import load_state_dicts

        init_params = load_state_dicts(args.init_checkpoint)[0]
        if any(name.endswith(".q") for name in init_params):
            raise ValueError("--init_checkpoint needs an unquantized checkpoint "
                             "(io.convert --quantize none): the trainer updates f32 weights")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass --device cpu "
                           "to train on the CPU")

    dit_cfg = DiTConfig.tiny() if args.tiny else DiTConfig.aetherv1()
    train_cfg = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=min(100, max(args.steps // 10, 1)),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        log_every=max(args.steps // 20, 1),
        # flash_train: K4 on the forward, the blockwise chunked-attention
        # gradient on the backward (ops/chunked_attention.py)
        attn_impl="flash_train" if device.type == "cuda" else "xla",
    )
    trainer = Trainer(dit_cfg, train_cfg, device=device, init_params=init_params)
    if args.latent_dir:
        from aether_tpu_torch.train.data import latent_batches

        text = None
        if args.text_embeds:
            text = np.load(args.text_embeds).astype(np.float32)
        batches = latent_batches(
            args.latent_dir, dit_cfg, batch_size=args.batch_size,
            seed=args.data_seed, text_embeds=text,
            native_prefetch=not args.no_native_prefetch)
    elif args.synthetic:
        batches = synthetic_batches(dit_cfg, batch_size=args.batch_size)
    else:
        raise SystemExit("pass --latent_dir DIR (real precomputed latents) "
                         "or --synthetic (random smoke data)")
    trainer.fit(batches, steps=args.steps)


if __name__ == "__main__":
    main()

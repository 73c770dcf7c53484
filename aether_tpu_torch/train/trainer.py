"""Training loop: LR schedule, clipping, accumulation, EMA, checkpoints.

Port of ``aether_tpu/train/trainer.py``, on one device or over a mesh (one
process per card under ``torchrun``; see "Over a mesh" below). The optimizer is the
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

Over a mesh (``Trainer(mesh=...)``, the JAX Trainer's mesh branches):

- a ("dp", "tp") mesh (``parallel.make_mesh``): ``shard_params`` splits tp,
  and with ``fsdp`` ``parallel.mesh.fsdp_shard`` shards the weights over dp
  (FSDP2), so the AdamW moments and the EMA made from them are 1/dp a rank;
- a ("dp", "pp") mesh (``parallel.pipeline.make_pp_mesh``): each stage
  keeps its blocks (``shard_blocks_pp``) and the blocks run on the GPipe
  schedule with ``pp_microbatches`` microbatches over the whole mesh, as
  JAX hands its executor the whole mesh: the executor cuts each
  microbatch's dp rows and gathers the output, so every rank takes the
  whole batch's loss, and its ``reduce_grads`` sums the gradients of the
  parameters every stage holds over pp and every gradient over dp.

Every rank draws the same global (t, eps) from the same generator and reads
the same global batch, so a run at dp = 2 computes what the same run at
dp = 1 computes. On a ("dp", "tp") mesh each rank keeps its dp rows, the
loss is the mean of the ranks' means and the gradients are averaged over
dp (FSDP's reduce-scatter, else an all-reduce). The clip comes after, its
norm counting every parameter's squares once
(``parallel.mesh.ParamLayout``). Checkpoints keep the one-card format,
written by rank 0 from the gathered pieces and cut for this rank's place on
resume, so a run resumes on another mesh or on one card. Only rank 0
prints.

CLI (``--device`` defaults to cuda; the CPU runs only when asked for):
    python -m aether_tpu_torch.train.trainer --synthetic --tiny --device cpu --steps 2
    python -m aether_tpu_torch.train.trainer --tiny --device cpu --latent_dir DIR --steps 3
    torchrun --nproc_per_node 4 -m aether_tpu_torch.train.trainer --synthetic --tiny \
        --device cpu --dp 2 --tp 2 --fsdp --batch_size 2 --steps 2
    torchrun --nproc_per_node 2 -m aether_tpu_torch.train.trainer --synthetic --tiny \
        --device cpu --pp 2 --batch_size 2 --steps 2

``--latent_dir`` reads the files of ``train.data.precompute_latents``
through the native prefetch loader (``aether_tpu_torch/runtime``, built with
g++ at first use); ``--no_native_prefetch`` reads them with ``np.load``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from aether_tpu_torch.config import DiTConfig, SchedulerConfig
from aether_tpu_torch.models.dit import DiT, init_dit
from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings
from aether_tpu_torch.parallel.distributed import is_main
from aether_tpu_torch.parallel.mesh import (
    ParamLayout,
    axis_rank,
    axis_size,
    fsdp_shard,
    is_fsdp,
    local_view,
    shard_params,
)
from aether_tpu_torch.parallel.pipeline import make_pipeline_block_scan, shard_blocks_pp
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


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         owned: Optional[List[bool]] = None,
                         groups: Sequence = ()) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: every g becomes
    ``g / norm * max_norm`` unless ``norm < max_norm``. Returns the norm.

    Over a mesh each rank holds pieces (FSDP shards are read locally):
    ``owned[i]`` says whether this rank counts ``grads[i]``'s squares (False
    where another rank holds the same piece), and the sum is then summed
    over each process group of ``groups``, so every parameter's squares
    count exactly once."""
    local = [local_view(g) for g in grads]
    counted = [g for i, g in enumerate(local) if owned is None or owned[i]]
    sq = (torch.stack([torch.sum(g * g) for g in counted]).sum() if counted
          else local[0].new_zeros(()))
    for group in groups:
        dist.all_reduce(sq, group=group)
    norm = torch.sqrt(sq)
    if not bool(norm < max_norm):
        for g in local:
            g.div_(norm).mul_(max_norm)
    return norm


class Optimizer:
    """``make_optimizer``'s transformation over ``torch.optim.AdamW``:
    ``clip_by_global_norm`` then ``adamw(lr_schedule)``, inside
    ``MultiSteps(grad_accum_steps)`` when that is above 1.

    :meth:`update` is one call of the optax update, after ``backward()``.
    ``owned`` and ``groups`` make the clip's norm global over a mesh
    (:func:`clip_by_global_norm_`). FSDP's sharded parameters (DTensors)
    and the plain ones go in two AdamW groups of the same settings."""

    def __init__(self, params, cfg: TrainConfig, owned: Optional[List[bool]] = None,
                 groups: Sequence = ()):
        self.params = list(params)
        sharded = [p for p in self.params if is_fsdp(p)]
        plain = [p for p in self.params if not is_fsdp(p)]
        param_groups = [{"params": g} for g in (sharded, plain) if g] if sharded else self.params
        self.adamw = torch.optim.AdamW(param_groups, lr=0.0, betas=(cfg.b1, cfg.b2),
                                       eps=1e-8, weight_decay=cfg.weight_decay)
        self.schedule = lr_schedule(cfg)
        self.k = cfg.grad_accum_steps
        self.max_norm = cfg.grad_clip_norm
        self.owned, self.groups = owned, tuple(groups)
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
        self.grad_norm = clip_by_global_norm_(grads, self.max_norm, self.owned, self.groups)
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


def make_optimizer(params, cfg: TrainConfig, owned: Optional[List[bool]] = None,
                   groups: Sequence = ()) -> Optimizer:
    return Optimizer(params, cfg, owned, groups)


@dataclasses.dataclass
class EmaTrainState:
    step: int
    model: DiT
    optimizer: Optimizer
    ema_params: Dict[str, torch.Tensor]


def make_ema_train_step(
    sched_cfg: SchedulerConfig,
    train_cfg: TrainConfig,
    block_scan=None,
    sync_grads: Optional[Callable[[DiT], None]] = None,
) -> Callable:
    """``train_step(state, batch, t, eps) -> loss``: loss and gradient, one
    optimizer call, then ``ema = decay * ema + (1 - decay) * params``; the
    state is updated in place. ``block_scan`` runs the blocks on the pp
    schedule (its ``reduce_grads`` sums the shared parameters' gradients
    over pp and every gradient over its dp axis); ``sync_grads(model)``
    reduces them over a tp mesh's dp axis. Both come before the
    optimizer's clip."""
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
            attn_impl=train_cfg.attn_impl, t=t, eps=eps, remat=train_cfg.remat,
            block_scan=block_scan)
        loss.backward()
        if block_scan is not None:
            block_scan.reduce_grads(model)
        if sync_grads is not None:
            sync_grads(model)
        state.optimizer.update()
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name in state.ema_params:
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


# the keys of a batch whose first axis is the batch (the RoPE tables have none)
BATCHED_KEYS = ("clean_latents", "condition_latents", "text_embeds")


def batch_to_device(batch: Dict[str, np.ndarray], device,
                    rows: Optional[slice] = None) -> Dict[str, torch.Tensor]:
    """The batch as tensors on ``device``; ``rows`` keeps those rows of its
    batched arrays (a dp rank's share)."""
    if rows is not None:
        batch = {k: v[rows] if k in BATCHED_KEYS else v for k, v in batch.items()}
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _newest_step(root: Optional[str]) -> Optional[int]:
    """The newest ``step_{:08d}`` checkpoint's step under ``root`` (None for
    none)."""
    if not root or not os.path.isdir(root):
        return None
    steps = [int(name.split("_")[-1]) for name in os.listdir(root)
             if name.startswith("step_") and name.split("_")[-1].isdigit()]
    return max(steps, default=None)


class Trainer:
    """Owns the model, optimizer, EMA, random draws, checkpoints and the loop.

    ``init_params``: a ``DiT`` state dict to start from (``io/from_jax.py``
    converts a JAX tree); otherwise ``init_dit`` draws f32 weights from
    ``seed``. ``noise``: the (t, eps) source; by default draws from the
    Trainer's generator (seeded with ``seed``), whose state checkpoints keep.
    ``mesh``: None (one device), a ("dp", "tp") mesh of
    ``parallel.make_mesh`` (``fsdp`` shards the weights over dp), or a
    ("dp", "pp") mesh of ``parallel.pipeline.make_pp_mesh`` (the GPipe
    schedule over ``pp_microbatches`` microbatches); see the module
    docstring. Every rank builds the same whole model first, then keeps its
    pieces.
    """

    def __init__(
        self,
        dit_cfg: DiTConfig,
        train_cfg: TrainConfig,
        sched_cfg: Optional[SchedulerConfig] = None,
        *,
        device,
        mesh=None,
        init_params: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        noise: Optional[NoiseSource] = None,
        pp_microbatches: int = 2,
        fsdp: bool = False,
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
        self.mesh = mesh
        pp = mesh is not None and "pp" in mesh.mesh_dim_names
        if fsdp and (mesh is None or pp or axis_size(mesh, "dp") < 2):
            raise ValueError("fsdp needs a (dp > 1, tp) mesh (not pp)")
        # the dp rows this Trainer cuts itself (under pp the executor does)
        self.dp, self.dp_rank = 1, 0
        self.block_scan = None
        self.layout: Optional[ParamLayout] = None
        if pp:
            # the blocks (and so their AdamW moments and EMA) live on their
            # stage; the executor runs each dp row of stages on its rows
            shard_blocks_pp(model, mesh)
            self.block_scan = make_pipeline_block_scan(mesh, pp_microbatches)
        elif mesh is not None:
            self.dp, self.dp_rank = axis_size(mesh, "dp"), axis_rank(mesh, "dp")
            shard_params(model, mesh)
            # the trainer hands each rank its dp rows itself: the forward
            # sees the tp axis only
            model.mesh = mesh["tp"] if axis_size(mesh, "tp") > 1 else None
            if fsdp:
                fsdp_shard(model, mesh)
        params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        owned, groups = None, ()
        if mesh is not None:
            self.layout = ParamLayout(model, mesh)
            owned = [self.layout.owns(self.layout.by_local[n], p) for n, p in params]
            groups = [mesh.get_group(a) for a in mesh.mesh_dim_names if axis_size(mesh, a) > 1]
        self.state = EmaTrainState(
            step=0,
            model=model,
            optimizer=make_optimizer([p for _, p in params], train_cfg, owned, groups),
            ema_params={n: p.detach().float().clone() for n, p in params},
        )
        self._step_fn = make_ema_train_step(
            self.sched_cfg, train_cfg, self.block_scan,
            self._dp_mean if self.dp > 1 else None)
        if train_cfg.checkpoint_dir:
            self.maybe_restore()

    def _draw(self, shape: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
        t = torch.randint(0, self.sched_cfg.num_train_timesteps, (shape[0],),
                          generator=self.gen, device=self.device)
        eps = torch.randn(shape, generator=self.gen, device=self.device)
        return t, eps

    def _dp_mean(self, model: DiT) -> None:
        """The dp mean of the gradients FSDP does not reduce (all of them
        without FSDP)."""
        group = self.mesh.get_group("dp")
        for p in model.parameters():
            if p.requires_grad and not is_fsdp(p):
                dist.all_reduce(p.grad, group=group)
                p.grad.div_(self.dp)

    def _rows(self, batch_size: int) -> Optional[slice]:
        """This rank's dp rows of a global batch (None where the Trainer
        cuts none)."""
        if self.dp == 1:
            return None
        if batch_size % self.dp:
            raise ValueError(f"batch {batch_size} not divisible by dp {self.dp}")
        n = batch_size // self.dp
        return slice(self.dp_rank * n, (self.dp_rank + 1) * n)

    # -- checkpointing ------------------------------------------------------
    def _ckpt_path(self, step: int) -> str:
        return os.path.join(os.path.abspath(self.train_cfg.checkpoint_dir),
                            f"step_{step:08d}")

    def gathered_state(self) -> dict:
        """A copy of the one-card checkpoint of this state: ``params``,
        ``ema_params`` (unsharded names, the unsharded order), ``optimizer``
        (the one-card ``Optimizer.state_dict``), ``generator`` and ``step``.
        Over a mesh every rank must call it; rank 0 gets the whole state,
        gathered one tensor at a time to the CPU, and the other ranks an
        empty dict."""
        return self._checkpoint() if self.layout is not None else copy.deepcopy(
            self._checkpoint())

    def _checkpoint(self) -> dict:
        """:meth:`gathered_state`; on one device its tensors are the live
        ones (``save`` writes them as they are)."""
        st = self.state
        if self.layout is None:
            return {"params": st.model.state_dict(), "ema_params": st.ema_params,
                    "optimizer": st.optimizer.state_dict(), "generator": self.gen.get_state(),
                    "step": st.step}
        lay, opt = self.layout, st.optimizer
        named = dict(st.model.named_parameters())
        index = {id(p): i for i, p in enumerate(opt.params)}
        params = lay.gather(lambda n: named[n])
        ema = lay.gather(st.ema_params.get)
        moments = {key: lay.gather(lambda n: opt.adamw.state.get(named[n], {}).get(key))
                   for key in ("exp_avg", "exp_avg_sq")}
        acc = None if opt.acc is None else lay.gather(lambda n: opt.acc[index[id(named[n])]])
        if not is_main():
            return {}
        step = next((s["step"] for s in opt.adamw.state.values()), None)
        names = lay.names()
        group = {k: v for k, v in opt.adamw.state_dict()["param_groups"][0].items()
                 if k != "params"}
        adamw = {"state": {i: {"step": step.clone(), "exp_avg": moments["exp_avg"][n],
                               "exp_avg_sq": moments["exp_avg_sq"][n]}
                           for i, n in enumerate(names) if n in moments["exp_avg"]},
                 "param_groups": [dict(group, params=list(range(len(names))))]}
        return {"params": params, "ema_params": ema,
                "optimizer": {"adamw": adamw, "count": opt.count, "mini_step": opt.mini_step,
                              "acc": None if acc is None else [acc[n] for n in names]},
                "generator": self.gen.get_state(), "step": st.step}

    def _agreed(self, value):
        """Rank 0's ``value`` on every rank of the mesh: one decision
        (whether to save, which step to resume) where every rank must join
        the collectives that follow, whatever its own file system shows."""
        if self.mesh is None:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def save(self) -> str:
        path = self._ckpt_path(self.state.step)
        if self._agreed(os.path.exists(path)):  # already checkpointed at this step
            return path
        # optimizer counters + generator state make restore an EXACT
        # continuation, as the JAX checkpoint's opt_state and key do
        state = self._checkpoint()
        if is_main():
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)  # a reader never sees half a checkpoint
        if self.mesh is not None:
            dist.barrier()
        return path

    def maybe_restore(self) -> Optional[int]:
        newest = self._agreed(_newest_step(self.train_cfg.checkpoint_dir) if is_main()
                              else None)
        if newest is None:
            return None
        path = self._ckpt_path(newest)
        if self.layout is None:
            ckpt = torch.load(path, map_location=self.device, weights_only=True)
            self.state.model.load_state_dict(ckpt["params"])
            with torch.no_grad():
                for name, e in self.state.ema_params.items():
                    e.copy_(ckpt["ema_params"][name])
            self.state.optimizer.load_state_dict(ckpt["optimizer"])
        else:
            ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
            self._load_pieces(ckpt)
        self.gen.set_state(ckpt["generator"].cpu())
        self.state.step = int(ckpt["step"])
        return newest

    def _load_pieces(self, ckpt: dict) -> None:
        """This rank's pieces of a one-card checkpoint: parameters, EMA,
        AdamW moments and pending accumulation, cut by the live layout."""
        lay, opt = self.layout, self.state.optimizer
        named = dict(self.state.model.named_parameters())
        index = {n: i for i, n in enumerate(lay.names())}
        saved = ckpt["optimizer"]
        for name, p in named.items():
            if not p.requires_grad:
                continue
            e = lay.by_local[name]
            lay.write(e, p, ckpt["params"][e.name])
            lay.write(e, self.state.ema_params[name], ckpt["ema_params"][e.name])
            st = saved["adamw"]["state"].get(index[e.name])
            if st is not None:
                moments = {"step": st["step"].clone()}
                for key in ("exp_avg", "exp_avg_sq"):
                    moments[key] = torch.zeros_like(p)
                    lay.write(e, moments[key], st[key])
                opt.adamw.state[p] = moments
        settings = {k: v for k, v in saved["adamw"]["param_groups"][0].items() if k != "params"}
        for group in opt.adamw.param_groups:
            group.update(settings)
        opt.count, opt.mini_step = int(saved["count"]), int(saved["mini_step"])
        opt.acc = None
        if saved["acc"] is not None:
            opt.acc = []
            name_of = {id(p): n for n, p in named.items()}
            for p in opt.params:
                e = lay.by_local[name_of[id(p)]]
                a = torch.zeros_like(p)
                lay.write(e, a, saved["acc"][index[e.name]])
                opt.acc.append(a)

    # -- loop ---------------------------------------------------------------
    def fit(self, batches: Iterator[Dict[str, np.ndarray]],
            steps: Optional[int] = None) -> list:
        cfg = self.train_cfg
        total = steps if steps is not None else cfg.total_steps
        losses = []
        t0 = time.time()
        for i in range(total):
            host = next(batches)
            rows = self._rows(host["clean_latents"].shape[0])
            batch = batch_to_device(host, self.device, rows)
            # the global draws on every rank, then this rank's rows
            t, eps = self.noise(tuple(host["clean_latents"].shape))
            if rows is not None:
                t, eps = t[rows], eps[rows]
            loss = self._step_fn(self.state, batch, t.to(self.device), eps.to(self.device))
            if self.dp > 1:  # the mean of the ranks' means: the batch mean
                dist.all_reduce(loss, group=self.mesh.get_group("dp"))
                loss = loss / self.dp
            if (i + 1) % cfg.log_every == 0 or i == total - 1:
                loss_val = float(loss)
                losses.append(loss_val)
                rate = (i + 1) / (time.time() - t0)
                if is_main():
                    print(f"step {self.state.step}: loss={loss_val:.4f} "
                          f"({rate:.2f} it/s)", flush=True)
            if cfg.checkpoint_dir and (i + 1) % cfg.checkpoint_every == 0:
                path = self.save()
                if is_main():
                    print(f"saved {path}", flush=True)
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
    p.add_argument("--pp", type=int, default=None,
                   help="GPipe pipeline stages (stage-shards the block stack; "
                        "mutually exclusive with --tp).")
    p.add_argument("--pp_microbatches", type=int, default=2)
    p.add_argument("--fsdp", action="store_true",
                   help="Fully-sharded data parallelism: weights, AdamW "
                        "moments, and the EMA copy shard 1/dp per rank "
                        "(FSDP2; requires --dp > 1).")
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

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass --device cpu "
                           "to train on the CPU")
    # one process per card: torchrun's variables join the group (NCCL on
    # cuda, gloo on cpu); a lone process joins nothing
    from aether_tpu_torch.parallel import initialize, is_distributed, make_mesh

    mesh = None
    if args.pp:
        if args.tp:
            raise SystemExit("--pp and --tp are mutually exclusive (the "
                             "attention shard_map cannot nest inside the "
                             "pipeline shard_map)")
        from aether_tpu_torch.parallel.pipeline import make_pp_mesh

        initialize(device=args.device)
        mesh = make_pp_mesh(args.pp, args.dp or 1)
    elif initialize(device=args.device) and is_distributed():
        mesh = make_mesh(dp=args.dp, tp=args.tp)
    if mesh is not None:
        device = torch.device(device.type, torch.cuda.current_device()) \
            if device.type == "cuda" else device
        if is_main():
            print(f"mesh: {mesh}", flush=True)

    init_params = None
    if args.init_checkpoint:
        from aether_tpu_torch.io.weights import load_state_dicts

        init_params = load_state_dicts(args.init_checkpoint)[0]
        if any(name.endswith(".q") for name in init_params):
            raise ValueError("--init_checkpoint needs an unquantized checkpoint "
                             "(io.convert --quantize none): the trainer updates f32 weights")
    if args.fsdp and (args.pp or mesh is None or axis_size(mesh, "dp") < 2):
        raise SystemExit("--fsdp needs a (dp>1, tp) mesh (not --pp)")

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
    trainer = Trainer(dit_cfg, train_cfg, device=device, mesh=mesh, init_params=init_params,
                      pp_microbatches=args.pp_microbatches, fsdp=args.fsdp)
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

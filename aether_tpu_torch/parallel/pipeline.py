"""GPipe pipeline parallelism over the DiT's block stack.

Port of ``aether_tpu/parallel/pipeline.py``. The mesh has axes ("dp", "pp"),
pp the faster one. Each pp stage holds ``L/pp`` contiguous blocks
(:func:`shard_blocks_pp`), so a 42-block model at pp = 7 keeps 6 blocks of
weights and AdamW moments a stage. The batch is cut into ``n_micro``
microbatches that stream through the stages: at tick t stage s runs
microbatch t - s through its blocks and hands the activations to stage s+1
(one point-to-point hop); ``n_micro + pp - 1`` ticks drain the pipeline,
and the bubble is ``(pp - 1) / (n_micro + pp - 1)``. A dp axis in the mesh
cuts each microbatch's rows over dp: every dp row of stages runs its own
pipeline on its rows, and the outputs are gathered over dp.

The executor is ``block_scan(body, carry, blocks, temb) -> carry`` for
``DiT.forward(block_scan=...)``: the same block body as the default loop,
another schedule. It takes the whole batch on every rank and returns the
whole output on every rank (the last stage's, broadcast over pp, as the JAX
executor psum-broadcasts it).

The JAX package gets the backward from autodiff of ``ppermute``; here the
schedule is one ``torch.autograd.Function`` whose backward runs the GPipe
backward explicitly: in reverse tick order each stage takes the gradient of
its microbatch's output (the last stage from the loss, the others from the
stage after them), runs its blocks' backward (remat's recompute included),
and sends the input gradient to the stage before it. Block parameters
accumulate their gradients there. Two rules make the gradients the JAX
ones:

- :meth:`PipelineBlockScan.seed_loss`: every rank computes the same head
  and loss on the broadcast output, but the loss's gradient flows on the
  last stage only (weighted 1/dp), so the head's gradient is counted once;
- :meth:`PipelineBlockScan.reduce_grads`: the parameters outside the
  stages' blocks (the patch and time embeddings, the head), which every
  stage holds, have their gradients summed over pp (the time embedding
  feeds every stage's blocks, the patch embedding stage 0's, the head the
  last stage's), and every parameter's over dp (each dp row saw its rows).

tp and sp do not compose inside the executor (as in JAX): the DiT runs
without a mesh of its own under pp.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from aether_tpu_torch.parallel.mesh import axis_rank, axis_size

Carry = Tuple[torch.Tensor, torch.Tensor]  # (video tokens, text tokens)


def make_pp_mesh(pp: int, dp: int = 1):
    """A ("dp", "pp") ``DeviceMesh`` over the process group, pp the faster
    axis (consecutive ranks are consecutive stages). ``dp * pp`` must be the
    world; the device type follows the backend (CUDA under NCCL)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * pp != world:
        raise ValueError(f"dp({dp}) * pp({pp}) != num devices ({world})")
    if not dist.is_initialized():
        raise RuntimeError("make_pp_mesh needs a process group: call "
                           "aether_tpu_torch.parallel.initialize() first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, pp), mesh_dim_names=("dp", "pp"))


class StageBlocks(nn.ModuleList):
    """One pp stage's contiguous blocks: blocks ``start .. start + len``
    of a stack of ``num_layers``."""

    def __init__(self, blocks, start: int, num_layers: int):
        super().__init__(blocks)
        self.start = start
        self.num_layers = num_layers


def shard_blocks_pp(model: nn.Module, mesh) -> nn.Module:
    """Keep this stage's ``L/pp`` contiguous blocks of ``model.blocks`` (in
    place; the other blocks are dropped) as :class:`StageBlocks`. Every
    parameter outside the stack stays on every stage."""
    pp, stage = axis_size(mesh, "pp"), axis_rank(mesh, "pp")
    n_layers = len(model.blocks)
    if n_layers % pp:
        raise ValueError(f"layers {n_layers} not divisible by pp {pp}")
    n = n_layers // pp
    model.blocks = StageBlocks(list(model.blocks)[stage * n:(stage + 1) * n], stage * n,
                               n_layers)
    return model


def _send(tensors, dst: int) -> None:
    for t in tensors:
        dist.send(t.contiguous(), dst)


def _recv(shapes, like: torch.Tensor, src: int) -> List[torch.Tensor]:
    out = []
    for shape in shapes:
        t = like.new_empty(shape)
        dist.recv(t, src)
        out.append(t)
    return out


class _Schedule:
    """One call of the executor: this rank's place in the mesh, its blocks,
    its microbatch rows, and what the forward keeps for the backward."""

    def __init__(self, scan: "PipelineBlockScan", body: Callable, blocks, batch: int):
        self.scan, self.body = scan, body
        pp, dp = scan.pp, scan.dp
        self.stage = scan.stage
        n_layers = getattr(blocks, "num_layers", len(blocks))
        if n_layers % pp:
            raise ValueError(f"layers {n_layers} not divisible by pp {pp}")
        if isinstance(blocks, StageBlocks):
            self.blocks = list(blocks)
        else:  # the whole stack: this stage takes its slice
            n = n_layers // pp
            self.blocks = list(blocks)[self.stage * n:(self.stage + 1) * n]
        self.n_micro = scan.n_micro
        self.b_mb = batch // self.n_micro
        self.rows = self.b_mb // dp
        self.r0 = scan.dp_rank * self.rows
        self.saved: List[Optional[tuple]] = [None] * self.n_micro

    def mb(self, x: torch.Tensor, m: int) -> torch.Tensor:
        """This dp rank's rows of microbatch ``m`` of ``x``."""
        start = m * self.b_mb + self.r0
        return x[start:start + self.rows]

    def ticks(self):
        """(tick, microbatch) of this stage's work, in tick order."""
        for tick in range(self.n_micro + self.scan.pp - 1):
            m = tick - self.stage
            if 0 <= m < self.n_micro:
                yield tick, m

    def run_blocks(self, h, e, t):
        carry = (h, e)
        for block in self.blocks:
            carry = self.body(carry, block, t)
        return carry

    def forward(self, hid, enc, temb, keep: bool) -> Carry:
        scan, stage = self.scan, self.stage
        first, last = stage == 0, stage == scan.pp - 1
        shapes = ((self.rows, *hid.shape[1:]), (self.rows, *enc.shape[1:]))
        outs = []
        for _, m in self.ticks():
            if first:
                h, e = self.mb(hid, m), self.mb(enc, m)
            else:
                h, e = _recv(shapes, hid, scan.prev)
            t = self.mb(temb, m)
            if keep:  # the microbatch's own graph, for the backward
                h, e, t = (x.detach().requires_grad_() for x in (h, e, t))
                with torch.enable_grad():
                    h_out, e_out = self.run_blocks(h, e, t)
                self.saved[m] = (h, e, t, h_out, e_out)
            else:
                h_out, e_out = self.run_blocks(h, e, t)
            if last:
                outs.append((h_out.detach(), e_out.detach()))
            else:
                _send((h_out, e_out), scan.next)
        # the last stage's output, every microbatch, to every stage
        if last:
            out_h = torch.stack([o[0] for o in outs])
            out_e = torch.stack([o[1] for o in outs])
        else:
            out_h = hid.new_empty((self.n_micro, *shapes[0]))
            out_e = enc.new_empty((self.n_micro, *shapes[1]))
        if scan.pp > 1:
            dist.broadcast(out_h, scan.last_rank, group=scan.pp_group)
            dist.broadcast(out_e, scan.last_rank, group=scan.pp_group)
        return self._gather_dp(out_h), self._gather_dp(out_e)

    def _gather_dp(self, x: torch.Tensor) -> torch.Tensor:
        """[n_micro, rows, ...] of each dp rank -> the whole batch."""
        if self.scan.dp > 1:
            parts = [torch.empty_like(x) for _ in range(self.scan.dp)]
            dist.all_gather(parts, x.contiguous(), group=self.scan.dp_group)
            x = torch.cat(parts, dim=1)
        return x.reshape(self.n_micro * self.b_mb, *x.shape[2:])

    def _rows_of_grad(self, g: torch.Tensor) -> torch.Tensor:
        """This dp rank's rows of the output gradient, [n_micro, rows, ...]:
        the transpose of the dp gather (the sum over dp, then the rows)."""
        g = g.reshape(self.n_micro, self.b_mb, *g.shape[1:])
        if self.scan.dp > 1:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=self.scan.dp_group)
        return g[:, self.r0:self.r0 + self.rows]

    def backward(self, g_h, g_e, hid, enc, temb):
        scan, stage = self.scan, self.stage
        first, last = stage == 0, stage == scan.pp - 1
        if last:
            g_h, g_e = self._rows_of_grad(g_h), self._rows_of_grad(g_e)
        d_hid = torch.zeros_like(hid) if first else None
        d_enc = torch.zeros_like(enc) if first else None
        d_temb = torch.zeros_like(temb)
        for _, m in reversed(list(self.ticks())):
            h, e, t, h_out, e_out = self.saved[m]
            self.saved[m] = None
            if last:
                gh, ge = g_h[m], g_e[m]
            else:
                gh, ge = _recv((h_out.shape, e_out.shape), h_out, scan.next)
            torch.autograd.backward((h_out, e_out), (gh, ge))
            grads = [x.grad if x.grad is not None else torch.zeros_like(x) for x in (h, e, t)]
            if first:
                self.mb(d_hid, m).copy_(grads[0])
                self.mb(d_enc, m).copy_(grads[1])
            else:
                _send(grads[:2], scan.prev)
            self.mb(d_temb, m).add_(grads[2])
        return d_hid, d_enc, d_temb


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, schedule: _Schedule, hid, enc, temb, anchor):
        ctx.schedule = schedule
        ctx.save_for_backward(hid, enc, temb)
        return schedule.forward(hid, enc, temb, keep=True)

    @staticmethod
    def backward(ctx, g_h, g_e):
        hid, enc, temb = ctx.saved_tensors
        d_hid, d_enc, d_temb = ctx.schedule.backward(g_h, g_e, hid, enc, temb)
        ctx.schedule = None
        return None, d_hid, d_enc, d_temb, None


class PipelineBlockScan:
    """The GPipe executor of one mesh (see the module docstring); build it
    with :func:`make_pipeline_block_scan`."""

    def __init__(self, mesh, n_micro: int):
        self.mesh, self.n_micro = mesh, n_micro
        self.pp, self.dp = axis_size(mesh, "pp"), axis_size(mesh, "dp")
        self.stage, self.dp_rank = axis_rank(mesh, "pp"), axis_rank(mesh, "dp")
        self.pp_group = mesh.get_group("pp") if self.pp > 1 else None
        self.dp_group = mesh.get_group("dp") if self.dp > 1 else None
        if self.pp > 1:
            ranks = dist.get_process_group_ranks(self.pp_group)
            self.prev = ranks[self.stage - 1] if self.stage > 0 else None
            self.next = ranks[self.stage + 1] if self.stage < self.pp - 1 else None
            self.last_rank = ranks[-1]

    def __call__(self, body: Callable, carry: Carry, blocks, temb: torch.Tensor) -> Carry:
        hid, enc = carry
        batch = hid.shape[0]
        if batch % self.n_micro != 0:
            raise ValueError(f"batch {batch} not divisible by n_micro {self.n_micro}")
        b_mb = batch // self.n_micro
        if b_mb % self.dp != 0:
            raise ValueError(f"microbatch {b_mb} not divisible by dp {self.dp}")
        schedule = _Schedule(self, body, blocks, batch)
        params = [p for blk in schedule.blocks for p in blk.parameters()]
        grad = torch.is_grad_enabled() and any(
            x.requires_grad for x in (hid, enc, temb, *params))
        if not grad:
            return schedule.forward(hid, enc, temb, keep=False)
        # the anchor puts the schedule in the graph even where no input
        # needs a gradient (the blocks' parameters alone do)
        anchor = torch.zeros((), device=hid.device, requires_grad=True)
        return _Pipeline.apply(schedule, hid, enc, temb, anchor)

    def seed_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss`` with its value unchanged and its gradient weighted 1/dp
        on the last stage and 0 elsewhere: every rank computes the head and
        the loss on the broadcast output, and they count once."""
        w = 1.0 / self.dp if self.stage == self.pp - 1 else 0.0
        return loss.detach() + (loss - loss.detach()) * w

    def reduce_grads(self, model: nn.Module) -> None:
        """Sum over pp the gradients of the parameters every stage holds
        (outside :class:`StageBlocks`; all of them where the model holds the
        whole stack), and every gradient over dp. A missing gradient counts
        as zeros."""
        staged = ({id(p) for p in model.blocks.parameters()}
                  if isinstance(model.blocks, StageBlocks) else set())
        for p in model.parameters():
            if not p.requires_grad:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if self.pp > 1 and id(p) not in staged:
                dist.all_reduce(p.grad, group=self.pp_group)
            if self.dp > 1:
                dist.all_reduce(p.grad, group=self.dp_group)


def make_pipeline_block_scan(mesh, n_micro: int) -> PipelineBlockScan:
    """The GPipe ``block_scan`` executor for ``DiT.forward`` (JAX
    ``make_pipeline_block_scan``), with the JAX checks: the mesh's axes are
    among {"pp", "dp"} and include "pp"; at the call, the layers divide by
    pp, the batch by ``n_micro`` and the microbatch by dp."""
    names = tuple(mesh.mesh_dim_names or ())
    if "pp" not in names:
        raise ValueError(f"mesh {names} has no 'pp' axis")
    extra = set(names) - {"pp", "dp"}
    if extra:
        raise ValueError(
            f"pipeline executor composes with 'dp' only, got extra axes {extra} "
            "(tp/sp attention cannot nest inside the pipeline schedule — "
            "run the DiT without a mesh under pp)")
    return PipelineBlockScan(mesh, n_micro)

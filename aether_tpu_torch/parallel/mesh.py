"""Device meshes and the tensor-parallel plan of the DiT (dp x tp [x sp]).

Port of ``aether_tpu/parallel/mesh.py``. The JAX package annotates
shardings and lets GSPMD insert the collectives; the port is SPMD, one
process per card, so the plan slices each rank's weights out of the full
model and the model code runs the collectives itself:

- **dp**: the batch (the CFG pair, a batch of reconstruction windows, the
  stacked RGB + disparity decode, eval sequences) splits over the dp axis;
- **tp**: Megatron tensor parallelism of the 3072-wide DiT. Column-split (the
  output dim, i.e. the heads): the fused ``attn.qkv``, ``mlp.w1`` and the
  patch embedding ``proj`` / ``text_proj``; row-split (the input dim):
  ``attn.o``, ``mlp.w2`` and ``proj_out``. Activations stay replicated over
  tp, so a block does two all-reduces, one after ``attn.o`` and one after
  ``mlp.w2`` (:class:`RowParallelLinear`); the patch embedding gathers its
  columns once a forward (:class:`GatheredColumnLinear`) and ``proj_out``
  all-reduces once;
- **sp**: the token axis of the joint stream is striped over sp (the DiT's
  forward does it; no weight changes).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the JAX axis
names; :func:`axis_size` and :func:`axis_rank` read it and treat a missing
mesh or axis as size 1; ``mesh.get_group(name)`` is an axis's process group.

Layout departure from the JAX plan: the adaLN modulation (``norm1`` /
``norm2.linear``, 6 x D outputs) stays replicated on tp. JAX shards its
outputs and GSPMD gathers them back before use; the numbers are the same.

Training (``train/trainer.py`` over a mesh) needs the collectives to carry
gradients, as Megatron pairs them: the sum after a row split is an
all-reduce on the forward and the identity on the backward
(:func:`reduce_from_tp`); the replicated input of a column split is the
identity on the forward and an all-reduce of its gradient on the backward
(:func:`copy_to_tp`); the patch embedding's gather takes this rank's slice
of the gradient (:func:`gather_from_tp`). Every sliced weight, the
row-split bias and every replicated parameter is trainable; the inference
numbers do not change.

FSDP (JAX ``dit_param_sharding(fsdp=True)``, ``aether_tpu/parallel/mesh.py:
63-116``) is :func:`fsdp_shard`: FSDP2's ``fully_shard`` over the dp axis,
applied after the tp split, holds every matrix weight (and so its AdamW
moments and EMA copy) 1/dp a rank; biases, norm scales, the time
embedding and ``norm_out`` stay replicated. :class:`ParamLayout` maps each
parameter of the unsharded DiT to this rank's piece of it, which the
trainer's clip, checkpoints and resume read.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from aether_tpu_torch.models.dit import (
    DiT,
    Linear,
    QuantLinear,
    _product_f32,
    all_gather_cat,
    int8_mm,
)


def _factor(world: int, dp: Optional[int], tp: Optional[int],
            sp: Optional[int]):
    """(dp, tp, sp) of a world of ``world`` ranks, the JAX factorization:
    with no axis given the whole world goes to tp; one of dp / tp given, the
    other takes the rest."""
    sp_total = 1 if sp is None else sp
    if sp_total < 1 or world % sp_total:
        raise ValueError(f"sp({sp_total}) does not divide the world ({world})")
    n_dt = world // sp_total
    if dp is None and tp is None:
        dp, tp = 1, n_dt
    elif dp is None:
        dp = n_dt // tp
    elif tp is None:
        tp = n_dt // dp
    if dp * tp * sp_total != world:
        raise ValueError(f"dp({dp}) * tp({tp}) * sp({sp_total}) != world ({world})")
    return dp, tp, sp_total


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
              sp: Optional[int] = None, *, replicas: int = 1,
              device_type: Optional[str] = None):
    """A ('dp', 'tp'[, 'sp']) ``DeviceMesh`` over the ranks of the process
    group (:func:`~aether_tpu_torch.parallel.initialize` joins one).

    The factorization is the JAX one: with no axis given every rank goes to
    tp; ``dp * tp * sp`` must equal the world. The mesh has two axes unless
    ``sp`` is given. ``replicas`` > 1 first splits the world into that many
    groups of consecutive ranks, each holding one mesh, and returns this
    rank's (the eval drivers' sequence sharding). The device type follows
    the group's backend (CUDA under NCCL, the CPU under gloo) unless
    ``device_type`` names it: gloo ranks holding CUDA tensors (two ranks
    sharing one card) take "cuda", which FSDP places its shards on."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "aether_tpu_torch.parallel.initialize() first")
    world = dist.get_world_size()
    if replicas < 1 or world % replicas:
        raise ValueError(f"{replicas} replicas do not divide the world ({world})")
    dims = _factor(world // replicas, dp, tp, sp)
    names = ("dp", "tp", "sp")
    if sp is None:
        dims, names = dims[:2], names[:2]
    device_type = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    if replicas == 1:
        return init_device_mesh(device_type, dims, mesh_dim_names=names)
    full = init_device_mesh(device_type, (replicas, *dims),
                            mesh_dim_names=("replica", *names))
    return full[names]


def axis_size(mesh, name: str) -> int:
    """Size of mesh axis ``name``; 1 without a mesh or without that axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate on axis ``name`` (0 where the axis is 1)."""
    return mesh.get_local_rank(name) if axis_size(mesh, name) > 1 else 0


# ---------------------------------------------------------------------------
# tensor-parallel layers
# ---------------------------------------------------------------------------


def _slice_linear(lin: nn.Module, rows: Optional[slice] = None,
                  cols: Optional[slice] = None, bias: bool = True) -> nn.Module:
    """A copy of ``lin`` (``Linear`` or ``QuantLinear``) holding only weight
    ``rows`` (output features, with their bias and per-output scales) and
    ``cols`` (input features); ``bias=False`` gives it a zero bias (a
    row-split layer adds the full bias after the sum)."""
    rows = slice(None) if rows is None else rows
    cols = slice(None) if cols is None else cols
    b = lin.bias.detach()[rows].clone() if bias else None
    if isinstance(lin, QuantLinear):
        s = lin.s[rows].clone()
        return QuantLinear(lin.q[rows, cols].contiguous(), s,
                           b if b is not None else torch.zeros_like(s))
    w = lin.weight.detach()[rows, cols].contiguous()
    with torch.device("meta"):
        out = Linear(w.shape[1], w.shape[0])
    out.weight = nn.Parameter(w)
    # a row split's zero bias is never read (the full bias is added after
    # the sum), so it is not trained
    out.bias = nn.Parameter(b if b is not None else w.new_zeros(w.shape[0]),
                            requires_grad=b is not None)
    return out


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(ctx.group, g), None


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x``: an all-reduce on the
    forward (in place when no gradient is taken), the identity on the
    backward."""
    if not _needs_grad(x):
        dist.all_reduce(x, group=group)
        return x
    return _ReduceFromTP.apply(x, group)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, replicated over ``group``, entering a split layer: the
    identity on the forward, the sum of every rank's input gradient on the
    backward."""
    return _CopyToTP.apply(x, group) if _needs_grad(x) else x


def _copy_to_tp_hook(group, module, args):
    """Forward pre-hook of a column-split layer: its input through
    :func:`copy_to_tp` (the layer keeps its type and attributes)."""
    return (copy_to_tp(args[0], group), *args[1:])


def _summed(group, g: torch.Tensor) -> torch.Tensor:
    """A copy of ``g`` summed over ``group``. Also the gradient hook of a
    parameter that is whole on every tp rank but acts on this rank's heads
    only (the per-head QK LayerNorm)."""
    g = g.clone()
    dist.all_reduce(g, group=group)
    return g


class RowParallelLinear(nn.Module):
    """A linear whose weight is split over tp along its input dim: each rank
    multiplies its input columns by its slice, the partial products are
    summed over the group (one ``all_reduce``), then the bias is added once.

    The sum is taken where the unsplit layer accumulates, so the result is
    the unsplit layer's up to the order of that sum: f32 partial products
    for float and weight-only codes (scaled and biased after the sum, rounded
    to x's dtype once); for int8 codes with int8 activations (w8a8) the
    per-token activation scale is the maximum over the whole row (one
    ``all_reduce(MAX)`` of a [..., 1] tensor) and the partial int32 sums are
    summed exactly. ``scatter_input`` takes this rank's columns of a
    replicated input (``proj_out``); otherwise the input holds them already
    (the head-split attention output, the column-split MLP hidden)."""

    def __init__(self, inner: nn.Module, bias: torch.Tensor, group, start: int,
                 stop: int, scatter_input: bool = False):
        super().__init__()
        self.inner = inner
        self.bias = nn.Parameter(bias.detach().clone())
        self.group = group
        self.start, self.stop = start, stop
        self.scatter_input = scatter_input

    def forward(self, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
        if self.scatter_input:
            x = copy_to_tp(x, self.group)[..., self.start:self.stop]
        inner = self.inner
        if isinstance(inner, QuantLinear) and a8 and inner.q.dtype == torch.int8:
            xf = x.float()
            absmax = xf.abs().amax(dim=-1, keepdim=True)
            dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=self.group)
            sx = absmax.clamp_min(1e-6) / xf.new_tensor(127.0)
            xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
            y = int8_mm(xq.reshape(-1, xq.shape[-1]), inner.q.t())
            dist.all_reduce(y, group=self.group)
            y = y.reshape(*x.shape[:-1], -1).float() * sx * inner.s
        elif isinstance(inner, QuantLinear):
            y = reduce_from_tp(_product_f32(x, inner.q).contiguous(), self.group)
            y = y * inner.s
        else:
            y = reduce_from_tp(_product_f32(x, inner.weight).contiguous(), self.group)
        return (y + self.bias.float()).to(x.dtype)


class _GatherFromTp(torch.autograd.Function):
    """:func:`gather_from_tp`: the gather on the forward, this rank's slice
    of the gradient on the backward."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.size = dim, t.shape[dim]
        ctx.rank = dist.get_rank(group)
        return all_gather_cat(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def gather_from_tp(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The output columns of a column split gathered over tp
    (:func:`all_gather_cat`), differentiable: every tp rank holds the same
    gradient of the replicated result, so the backward is this rank's
    slice of it."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherFromTp.apply(t, dim, group)
    return all_gather_cat(t, dim, group)


class GatheredColumnLinear(nn.Module):
    """A linear whose weight is split over tp along its output dim, its
    output columns gathered from every rank (one ``all_gather``): the patch
    embedding, whose tokens the replicated activations need whole."""

    def __init__(self, inner: nn.Module, group):
        super().__init__()
        self.inner = inner
        self.group = group

    def forward(self, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
        return gather_from_tp(self.inner(copy_to_tp(x, self.group), a8), -1, self.group)


# ---------------------------------------------------------------------------
# the DiT's tp plan
# ---------------------------------------------------------------------------

#: module name (``{i}`` for every block) -> how it splits over tp: "qkv" (the
#: fused [q | k | v] projection, each rank's rows its heads' q, k and v),
#: "colwise", "colwise_gather", "rowwise", "rowwise_scatter".
TP_PLAN: Dict[str, str] = {
    "proj": "colwise_gather",
    "text_proj": "colwise_gather",
    "blocks.{i}.attn.qkv": "qkv",
    "blocks.{i}.attn.o": "rowwise",
    "blocks.{i}.mlp.w1": "colwise",
    "blocks.{i}.mlp.w2": "rowwise",
    "proj_out": "rowwise_scatter",
}


def dit_tp_plan(model: DiT) -> Dict[str, str]:
    """:data:`TP_PLAN` spelled out for ``model``'s blocks: module name ->
    split."""
    plan = {}
    for name, style in TP_PLAN.items():
        if "{i}" in name:
            for i in range(len(model.blocks)):
                plan[name.format(i=i)] = style
        else:
            plan[name] = style
    return plan


def _shard(lin: nn.Module, style: str, rank: int, tp: int, group) -> nn.Module:
    w = lin.q if isinstance(lin, QuantLinear) else lin.weight
    out_dim, in_dim = w.shape
    if style == "qkv":
        part = _slice_linear(lin, rows=_qkv_rows(out_dim, rank, tp, w.device))
    elif style in ("colwise", "colwise_gather"):
        n = out_dim // tp
        part = _slice_linear(lin, rows=slice(rank * n, (rank + 1) * n))
        if style == "colwise_gather":
            return GatheredColumnLinear(part, group)
    else:
        n = in_dim // tp
        cols = slice(rank * n, (rank + 1) * n)
        return RowParallelLinear(_slice_linear(lin, cols=cols, bias=False), lin.bias, group,
                                 cols.start, cols.stop,
                                 scatter_input=style == "rowwise_scatter")
    # the replicated input of a column split sums its gradient over tp
    part.register_forward_pre_hook(functools.partial(_copy_to_tp_hook, group))
    return part


def _qkv_rows(out_dim: int, rank: int, tp: int, device=None) -> torch.Tensor:
    """Rank ``rank``'s rows of the fused [q | k | v] projection at tp:
    ``[q_r | k_r | v_r]``, its heads' q, k and v."""
    d = out_dim // 3
    n = d // tp
    return torch.cat([torch.arange(j * d + rank * n, j * d + (rank + 1) * n, device=device)
                      for j in range(3)])


@torch.no_grad()
def shard_params(model: DiT, mesh) -> DiT:
    """Split ``model`` in place for this rank of ``mesh`` and attach the mesh
    (``model.mesh``), which the forward reads for dp, tp and sp.

    At tp > 1 every module of :func:`dit_tp_plan` keeps only this rank's
    slice: codes and their per-output scales slice together (the scales
    follow the output dim, as JAX's ``shard_params`` ``_put`` does), for
    int8 (w8a8 or weight-only) and fp8 codes alike. The fused qkv's rows are
    taken per shard, ``[q_r | k_r | v_r]``, the layout JAX's
    ``_qkv_fused_projection(shards=tp)`` interleaves, so each rank's fused
    projection holds exactly its own heads' q, k and v. The heads and the MLP
    width must divide by tp. At tp = 1 no weight changes. For training, the
    column splits' inputs go through :func:`copy_to_tp`, and the QK
    LayerNorm's parameters (whole on every rank, applied to this rank's
    heads) get a gradient hook that sums them over tp."""
    tp = axis_size(mesh, "tp")
    if tp > 1:
        cfg = model.cfg
        if cfg.num_heads % tp or cfg.mlp_dim % tp or cfg.hidden_size % tp:
            raise ValueError(f"tp={tp} must divide the heads ({cfg.num_heads}), the "
                             f"width ({cfg.hidden_size}) and the MLP ({cfg.mlp_dim})")
        rank, group = axis_rank(mesh, "tp"), mesh.get_group("tp")
        for name, style in dit_tp_plan(model).items():
            parent_name, _, attr = name.rpartition(".")
            parent = model.get_submodule(parent_name) if parent_name else model
            setattr(parent, attr, _shard(getattr(parent, attr), style, rank, tp, group))
        # the QK LayerNorm's scales and biases are shared by every head, and
        # each rank normalizes its own heads: their gradients sum over tp
        for block in model.blocks:
            for name in ("norm_q_scale", "norm_q_bias", "norm_k_scale", "norm_k_bias"):
                getattr(block.attn, name).register_hook(functools.partial(_summed, group))
    model.mesh = mesh
    return model


# ---------------------------------------------------------------------------
# FSDP on the dp axis, and where each parameter lives
# ---------------------------------------------------------------------------


def _replicated_on_fsdp(name: str, param: torch.Tensor) -> bool:
    """The leaves JAX ``dit_param_sharding(fsdp=True)`` keeps replicated:
    biases and norm scales (every 1-D leaf), the time embedding and the
    output adaLN (``norm_out``); CogVideoX-1.5's ofs embedding, the time
    embedding's twin, as it is."""
    return param.ndim < 2 or name.startswith(("time_embed.", "ofs_embed.", "norm_out."))


def fsdp_shard(model: DiT, mesh) -> DiT:
    """Fully sharded data parallelism over ``mesh``'s dp axis, in place.

    FSDP2's ``fully_shard`` on each block and then on the model, over the
    ``dp`` sub-mesh, after :func:`shard_params` has split tp: each rank holds
    1/dp of its tp slice of every matrix weight (dim 0, ``torch.chunk``
    pieces), gathers a block's weights for its forward and for remat's
    recompute, and gets their gradients reduce-scattered (the dp mean). The
    small leaves (:func:`_replicated_on_fsdp`) stay out of FSDP, replicated,
    as JAX keeps them (``aether_tpu/parallel/mesh.py:81-83``); their dp mean
    is the caller's all-reduce. Departure: JAX shards the other matmul dim
    (``P(None, "dp", "tp")`` for a column split); the numbers are the same."""
    from torch.distributed.fsdp import fully_shard

    if axis_size(mesh, "dp") < 2:
        raise ValueError("fsdp_shard needs a mesh with dp > 1")
    dp_mesh = mesh["dp"]
    small = {p for n, p in model.named_parameters() if _replicated_on_fsdp(n, p)}
    for block in model.blocks:
        fully_shard(block, mesh=dp_mesh, ignored_params=small)
    fully_shard(model, mesh=dp_mesh, ignored_params=small)
    return model


def is_fsdp(t: torch.Tensor) -> bool:
    """True for an FSDP-sharded parameter (or a tensor made like one): a
    ``DTensor``."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_view(t: torch.Tensor) -> torch.Tensor:
    """This rank's piece of ``t``: the local shard of an FSDP tensor, else
    ``t`` itself (a view either way, for in-place updates)."""
    return t.to_local() if is_fsdp(t) else t


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one parameter of the unsharded DiT lives on this rank.

    ``name`` is its name in the unsharded model (and in a one-card
    checkpoint); ``local`` the name of this rank's parameter that holds its
    piece (None on a pp stage that does not hold its block); ``tp_index``
    maps a tp rank to the index of that rank's piece in the full tensor
    (None: whole on every tp rank); ``block`` its block (None outside the
    block stack)."""

    name: str
    local: Optional[str]
    tp_index: Optional[Callable[[int], Tuple]]
    block: Optional[int]


def _tp_index(style: str, leaf: str, shape, tp: int) -> Optional[Callable[[int], Tuple]]:
    """The tp piece selector of a ``weight`` / ``bias`` leaf of a layer split
    ``style`` (None where the leaf stays whole: a row split's bias)."""
    out_dim = shape[0]
    if style == "qkv":
        return lambda r: (_qkv_rows(out_dim, r, tp),)
    if style in ("colwise", "colwise_gather"):
        n = out_dim // tp
        return lambda r: (slice(r * n, (r + 1) * n),)
    if leaf == "bias":
        return None
    n = shape[1] // tp
    return lambda r: (slice(None), slice(r * n, (r + 1) * n))


def _local_name(name: str, style: Optional[str], leaf: str) -> str:
    if style == "colwise_gather" or (style in ("rowwise", "rowwise_scatter")
                                     and leaf == "weight"):
        return name[:-len(leaf)] + "inner." + leaf
    return name


class ParamLayout:
    """Every parameter of the unsharded DiT, in its order, and this rank's
    piece of it under ``mesh`` (tp slices, FSDP shards over dp, pp stages'
    blocks): read by the trainer's global-norm clip (each parameter's
    squares once), its checkpoints (gathered to the one-card format) and
    its resume (the one-card format cut for this rank)."""

    def __init__(self, model: DiT, mesh):
        self.mesh = mesh
        self.tp, self.dp, self.pp = (axis_size(mesh, a) for a in ("tp", "dp", "pp"))
        with torch.device("meta"):
            full = DiT(model.cfg)
        plan = dit_tp_plan(full) if self.tp > 1 else {}
        n_local = len(model.blocks)
        self.per_stage = model.cfg.num_layers // self.pp
        start = getattr(model.blocks, "start", 0)
        self.entries: List[Placement] = []
        for name, p in full.named_parameters():
            layer, _, leaf = name.rpartition(".")
            style = plan.get(layer)
            index = _tp_index(style, leaf, tuple(p.shape), self.tp) if style else None
            local = _local_name(name, style, leaf)
            block = None
            if name.startswith("blocks."):
                block = int(name.split(".")[1])
                i = block - start
                local = (f"blocks.{i}." + local.split(".", 2)[2]
                         if 0 <= i < n_local else None)
            self.entries.append(Placement(name, local, index, block))
        self.by_local = {e.local: e for e in self.entries if e.local is not None}

    def names(self) -> List[str]:
        return [e.name for e in self.entries]

    def replicated_axes(self, e: Placement, t: torch.Tensor) -> List[str]:
        """The mesh axes over which every rank holds the same piece of
        ``e`` (``t`` is this rank's tensor of it)."""
        axes = []
        if self.tp > 1 and e.tp_index is None:
            axes.append("tp")
        if self.dp > 1 and not is_fsdp(t):
            axes.append("dp")
        if self.pp > 1 and e.block is None:
            axes.append("pp")
        return axes

    def owns(self, e: Placement, t: torch.Tensor) -> bool:
        """True on the one rank, of those holding the same piece of ``e``,
        that counts it (coordinate 0 on each axis it is replicated over)."""
        return all(axis_rank(self.mesh, a) == 0 for a in self.replicated_axes(e, t))

    def piece(self, e: Placement, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the full tensor ``full`` of ``e``, shaped as
        ``like``'s local view (its tp slice, then its FSDP chunk)."""
        if e.tp_index is not None:
            full = full[e.tp_index(axis_rank(self.mesh, "tp"))]
        if is_fsdp(like):
            chunks = list(torch.chunk(full, self.dp, dim=0))
            r = axis_rank(self.mesh, "dp")
            full = chunks[r] if r < len(chunks) else full[:0]
        return full

    def write(self, e: Placement, dst: torch.Tensor, full: torch.Tensor) -> None:
        """Copy this rank's piece of ``full`` into ``dst`` (a parameter or a
        tensor shaped like one) in place."""
        with torch.no_grad():
            local_view(dst).copy_(self.piece(e, full.to(dst.device), dst))

    def gather(self, get: Callable[[str], Optional[torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """The full tensor of every entry, in the unsharded order, on rank 0
        as a CPU copy (other ranks return an empty dict): ``get(local name)`` gives this
        rank's tensor of it (None for none, on every rank alike). Collective:
        every rank of the mesh calls it."""
        out: Dict[str, torch.Tensor] = {}
        main = not dist.is_initialized() or dist.get_rank() == 0
        for e in self.entries:
            if e.local is None:
                continue
            t = get(e.local)
            if t is None:
                continue
            t = t.detach()
            if is_fsdp(t):
                t = self._gather_fsdp(t)
            if e.tp_index is not None:
                parts = [torch.empty_like(t) for _ in range(self.tp)]
                dist.all_gather(parts, t.contiguous(), group=self.mesh.get_group("tp"))
                shape = list(t.shape)
                dim = len(e.tp_index(0)) - 1
                shape[dim] *= self.tp
                t = t.new_empty(shape)
                for r, part in enumerate(parts):
                    t[e.tp_index(r)] = part
            if self.pp > 1 and e.block is not None:
                parts = [torch.empty_like(t) for _ in range(self.pp)]
                dist.all_gather(parts, t.contiguous(), group=self.mesh.get_group("pp"))
                n = self.per_stage
                i = int(e.local.split(".")[1])
                rest = e.name.split(".", 2)[2]
                for stage, part in enumerate(parts):
                    if main:
                        out[f"blocks.{stage * n + i}.{rest}"] = part.to("cpu", copy=True)
            elif main:
                out[e.name] = t.to("cpu", copy=True)
        return {e.name: out[e.name] for e in self.entries if e.name in out}

    def _gather_fsdp(self, t: torch.Tensor) -> torch.Tensor:
        """The whole (tp-local) tensor of an FSDP shard: its ``torch.chunk``
        pieces over dp, padded to one size for a c10d ``all_gather`` (gloo
        gathers CUDA tensors that way; ``DTensor.full_tensor``'s functional
        collective does not run there)."""
        local = t.to_local()
        sizes = [len(c) for c in torch.arange(t.shape[0]).chunk(self.dp)]
        sizes += [0] * (self.dp - len(sizes))
        buf = local.new_zeros((sizes[0], *local.shape[1:]))
        buf[:local.shape[0]] = local
        parts = [torch.empty_like(buf) for _ in range(self.dp)]
        dist.all_gather(parts, buf, group=self.mesh.get_group("dp"))
        return torch.cat([part[:n] for part, n in zip(parts, sizes)])

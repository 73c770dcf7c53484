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
"""

from __future__ import annotations

from typing import Dict, Optional

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
              sp: Optional[int] = None, *, replicas: int = 1):
    """A ('dp', 'tp'[, 'sp']) ``DeviceMesh`` over the ranks of the process
    group (:func:`~aether_tpu_torch.parallel.initialize` joins one).

    The factorization is the JAX one: with no axis given every rank goes to
    tp; ``dp * tp * sp`` must equal the world. The mesh has two axes unless
    ``sp`` is given. ``replicas`` > 1 first splits the world into that many
    groups of consecutive ranks, each holding one mesh, and returns this
    rank's (the eval drivers' sequence sharding). The device type follows
    the group's backend: CUDA under NCCL, the CPU under gloo."""
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
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
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
    out.weight = nn.Parameter(w, requires_grad=False)
    out.bias = nn.Parameter(b if b is not None else w.new_zeros(w.shape[0]),
                            requires_grad=False)
    return out


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
        self.bias = nn.Parameter(bias.detach().clone(), requires_grad=False)
        self.group = group
        self.start, self.stop = start, stop
        self.scatter_input = scatter_input

    def forward(self, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
        if self.scatter_input:
            x = x[..., self.start:self.stop]
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
            y = _product_f32(x, inner.q).contiguous()
            dist.all_reduce(y, group=self.group)
            y = y * inner.s
        else:
            y = _product_f32(x, inner.weight).contiguous()
            dist.all_reduce(y, group=self.group)
        return (y + self.bias.float()).to(x.dtype)


class GatheredColumnLinear(nn.Module):
    """A linear whose weight is split over tp along its output dim, its
    output columns gathered from every rank (one ``all_gather``): the patch
    embedding, whose tokens the replicated activations need whole."""

    def __init__(self, inner: nn.Module, group):
        super().__init__()
        self.inner = inner
        self.group = group

    def forward(self, x: torch.Tensor, a8: bool = False) -> torch.Tensor:
        return all_gather_cat(self.inner(x, a8), -1, self.group)


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
        d = out_dim // 3
        n = d // tp
        idx = torch.cat([torch.arange(j * d + rank * n, j * d + (rank + 1) * n,
                                      device=w.device) for j in range(3)])
        return _slice_linear(lin, rows=idx)
    if style in ("colwise", "colwise_gather"):
        n = out_dim // tp
        part = _slice_linear(lin, rows=slice(rank * n, (rank + 1) * n))
        return part if style == "colwise" else GatheredColumnLinear(part, group)
    n = in_dim // tp
    cols = slice(rank * n, (rank + 1) * n)
    return RowParallelLinear(_slice_linear(lin, cols=cols, bias=False), lin.bias, group,
                             cols.start, cols.stop, scatter_input=style == "rowwise_scatter")


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
    width must divide by tp. At tp = 1 no weight changes."""
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
    model.mesh = mesh
    return model

"""Multi-process work sharding for embarrassingly-parallel jobs.

:func:`shard_sequences` is a copy of ``aether_tpu/eval/sharding.py``: each
process takes a contiguous, load-balanced slice of the items by its rank.
Without an explicit index and count, the rank and world size of an
initialized ``torch.distributed`` process group are used, and a single
process takes everything. :func:`join_replicas` sets up the eval drivers'
process group and meshes, and the shard each rank runs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, TypeVar

T = TypeVar("T")


def shard_sequences(
    items: Sequence[T],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[T]:
    """Return this process's slice of ``items`` (contiguous, load-balanced).

    With k = len(items) % n processes, the first k processes take
    ceil(len/n) items — the same contract as Accelerate's
    ``split_between_processes`` without padding.
    """
    if process_index is None or process_count is None:
        import torch.distributed as dist

        ready = dist.is_available() and dist.is_initialized()
        if process_index is None:
            process_index = dist.get_rank() if ready else 0
        if process_count is None:
            process_count = dist.get_world_size() if ready else 1
    if process_count <= 1:
        return list(items)
    n = len(items)
    base, extra = divmod(n, process_count)
    start = process_index * base + min(process_index, extra)
    stop = start + base + (1 if process_index < extra else 0)
    return list(items[start:stop])


def join_replicas(args) -> Tuple[object, object, dict]:
    """The eval drivers' parallel set-up from their flags: (device, mesh,
    shard).

    ``--distributed`` joins the process group ``torchrun`` describes;
    ``--dp/--tp`` give each replica, a group of ``dp * tp`` consecutive ranks,
    one mesh (``apps.demo.build_mesh``, which joins too). The sequences shard
    by replica: ``shard`` holds ``process_index = rank // (dp * tp)``,
    ``process_count = world // (dp * tp)`` and ``write``, true on the first
    rank of each replica (the others compute alongside it), for the drivers'
    ``run_sequences``; it is empty in a single process. ``device`` is the
    resolved ``--device``."""
    import torch.distributed as dist

    from aether_tpu_torch.apps.demo import build_mesh, resolve_device
    from aether_tpu_torch.parallel import initialize
    from aether_tpu_torch.parallel.mesh import axis_size

    if args.distributed:
        initialize(device=args.device)
    mesh = build_mesh(args, replicas=True)
    device = resolve_device(args.device)
    if not dist.is_initialized():
        return device, mesh, {}
    width = axis_size(mesh, "dp") * axis_size(mesh, "tp")
    rank, world = dist.get_rank(), dist.get_world_size()
    return device, mesh, dict(process_index=rank // width, process_count=world // width,
                              write=rank % width == 0)

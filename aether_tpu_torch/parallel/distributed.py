"""Process-group bootstrap: join, barrier, and main-process gating.

Port of ``aether_tpu/parallel/distributed.py``. The JAX package drives every
chip of a host from one process and joins hosts through
``jax.distributed``; the port follows PyTorch's SPMD idiom instead: one
process per card, all of them running the same program, launched by
``torchrun`` (or any launcher that sets its variables) and joined into one
``torch.distributed`` process group. NCCL carries the collectives between
cards, gloo those between CPU processes.

- :func:`initialize` joins the group. Each field is read from an explicit
  argument first, then from ``torchrun``'s variables (``MASTER_ADDR`` /
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), then from the ``AETHER_*``
  aliases the JAX package reads (``AETHER_COORDINATOR`` as ``host:port``,
  ``AETHER_NUM_PROCESSES``, ``AETHER_PROCESS_ID``). A single process with
  nothing configured does not join, and the call returns False.
- :func:`barrier` is ``accelerator.wait_for_everyone()``: a fence before the
  main process aggregates (reference ``rel_pose/launch_aether.py:348-350``).
- :func:`is_main` gates aggregation, file writes and printing to rank 0.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_ENV = {
    "coordinator_address": ("AETHER_COORDINATOR",),
    "num_processes": ("WORLD_SIZE", "AETHER_NUM_PROCESSES"),
    "process_id": ("RANK", "AETHER_PROCESS_ID"),
}


def _from_env(name: str) -> Optional[str]:
    if name == "coordinator_address":
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr and port:
            return f"{addr}:{port}"
    for var in _ENV[name]:
        val = os.environ.get(var)
        if val not in (None, ""):
            return val
    return None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: str = "cuda",
) -> bool:
    """Join the process group; returns True when joined (or already in one).

    ``coordinator_address`` is the ``host:port`` of rank 0's store,
    ``num_processes`` the world size and ``process_id`` this process's rank;
    each falls back on the environment (see the module docstring). With no
    coordinator or a world of one this is a single-process run: nothing is
    joined and the call returns False, so callers never special-case local
    runs. ``device`` picks the backend: NCCL for ``cuda`` (the default; the
    process's card is then ``cuda:LOCAL_RANK``, made current here), gloo for
    ``cpu``. A second call after a join returns True and changes nothing."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or _from_env("coordinator_address")
    if num_processes is None:
        env = _from_env("num_processes")
        num_processes = int(env) if env is not None else None
    if process_id is None:
        env = _from_env("process_id")
        process_id = int(env) if env is not None else None
    if coordinator_address is None or num_processes in (None, 1):
        return False
    if process_id is None:
        raise ValueError("a process group of several processes needs this process's "
                         "rank (process_id, RANK or AETHER_PROCESS_ID)")
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda') needs a CUDA device; pass "
                               "device='cpu' for a gloo group of CPU processes")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def is_distributed() -> bool:
    """True when more than one process shares the process group."""
    return dist.is_initialized() and dist.get_world_size() > 1


def is_main() -> bool:
    """True on rank 0 (and in a single process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Block until every process of the group reaches this point; nothing
    in a single process."""
    if is_distributed():
        dist.barrier()

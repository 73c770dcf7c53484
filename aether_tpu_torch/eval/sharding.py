"""Multi-process work sharding for embarrassingly-parallel jobs.

Copy of ``aether_tpu/eval/sharding.py``: each process takes a contiguous,
load-balanced slice of the items by its rank. Without an explicit index and
count, the rank and world size of an initialized ``torch.distributed``
process group are used, and a single process takes everything.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, TypeVar

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

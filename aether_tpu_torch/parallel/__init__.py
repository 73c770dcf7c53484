"""The parallel layer: process groups, meshes and the DiT's tp plan.

Port of ``aether_tpu/parallel`` for inference (the JAX package's pipeline
parallelism, ``parallel/pipeline.py``, and FSDP belong to training and are
not ported yet). One process drives one card; see
:mod:`~aether_tpu_torch.parallel.distributed` and
:mod:`~aether_tpu_torch.parallel.mesh`.
"""

from aether_tpu_torch.parallel.distributed import (  # noqa: F401
    barrier,
    initialize,
    is_distributed,
    is_main,
)
from aether_tpu_torch.parallel.mesh import (  # noqa: F401
    axis_rank,
    axis_size,
    dit_tp_plan,
    make_mesh,
    shard_params,
)

"""The parallel layer: process groups, meshes, the DiT's tp plan, FSDP and
the GPipe pipeline schedule.

Port of ``aether_tpu/parallel``. One process drives one card; see
:mod:`~aether_tpu_torch.parallel.distributed`,
:mod:`~aether_tpu_torch.parallel.mesh` (tp, FSDP on dp, where each
parameter lives) and :mod:`~aether_tpu_torch.parallel.pipeline` (pp).
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

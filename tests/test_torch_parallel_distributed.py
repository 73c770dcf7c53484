"""The port's process-group bootstrap and meshes (``aether_tpu_torch.parallel``)
on the CPU, the counterpart of ``tests/test_distributed.py``.

- In one process with nothing configured ``initialize()`` joins nothing and
  returns False, ``is_main`` holds, ``barrier`` is a no-op, and ``make_mesh``
  asks for a group.
- Two real processes join a gloo group on localhost, with the rank and
  address from torchrun's variables, from explicit arguments or from the
  ``AETHER_*`` aliases: a second ``initialize()`` is idempotent, the ranks
  all-gather their indices, shard a sequence list as the eval drivers do and
  meet at the barrier.
- ``make_mesh``'s factorization against the JAX ``make_mesh`` on the
  conftest's 8-device mesh, and the meshes of four ranks (axes, coordinates
  and the rank lines of each axis) against the JAX mesh's device layout.
"""

import os

import numpy as np
import pytest
import torch

from aether_tpu_torch.parallel.launch import spawn
from aether_tpu_torch.parallel.mesh import _factor
from test_torch_parallel_dit import ENV, HERE

_GROUP_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "AETHER_COORDINATOR",
               "AETHER_NUM_PROCESSES", "AETHER_PROCESS_ID")


def test_single_process_is_noop(monkeypatch):
    import torch.distributed as dist

    from aether_tpu_torch.parallel import barrier, initialize, is_distributed, is_main
    from aether_tpu_torch.parallel import make_mesh

    for var in _GROUP_VARS:
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False and not dist.is_initialized()
    assert not is_distributed() and is_main()
    barrier()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            initialize("127.0.0.1:1", 2, 0)


def rank_join(mode):
    """Join a two-rank group the way ``mode`` says; returns what it saw."""
    import torch.distributed as dist

    from aether_tpu_torch.eval.sharding import shard_sequences
    from aether_tpu_torch.parallel import barrier, initialize, is_distributed, is_main

    addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if mode != "torchrun":
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            del os.environ[var]
    if mode == "explicit":
        joined = initialize(addr, world, rank, device="cpu")
    elif mode == "aether":
        os.environ.update(AETHER_COORDINATOR=addr, AETHER_NUM_PROCESSES=str(world),
                          AETHER_PROCESS_ID=str(rank))
        joined = initialize(device="cpu")
    else:
        joined = initialize(device="cpu")
    again = initialize(device="cpu")
    ranks = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(ranks, torch.tensor([dist.get_rank()]))
    barrier()
    return dict(joined=joined, again=again, distributed=is_distributed(), main=is_main(),
                backend=dist.get_backend(), ranks=[int(r) for r in ranks],
                mine=shard_sequences(["a", "b", "c"]))


@pytest.mark.parametrize("mode", ["torchrun", "explicit", "aether"])
def test_two_process_group_localhost(mode):
    got = spawn("test_torch_parallel_distributed:rank_join", 2, dict(mode=mode),
                extra_path=[HERE], env=ENV)
    for rank, seen in enumerate(got):
        assert seen["joined"] is True and seen["again"] is True
        assert seen["distributed"] and seen["main"] == (rank == 0)
        assert seen["backend"] == "gloo" and seen["ranks"] == [0, 1]
        assert seen["mine"] == (["a", "b"] if rank == 0 else ["c"])


@pytest.mark.parametrize("axes", [dict(), dict(dp=2), dict(tp=4), dict(sp=2),
                                  dict(dp=2, tp=2, sp=2), dict(dp=4, sp=2), dict(dp=8)])
def test_factorization_matches_jax(axes):
    import jax

    from aether_tpu.parallel.mesh import make_mesh as jax_make_mesh

    mesh = jax_make_mesh(**axes, devices=jax.devices())
    dims = _factor(8, axes.get("dp"), axes.get("tp"), axes.get("sp"))
    names = ("dp", "tp", "sp") if "sp" in axes else ("dp", "tp")
    assert dict(mesh.shape) == dict(zip(names, dims[:len(names)]))


@pytest.mark.parametrize("axes", [dict(dp=3), dict(sp=3), dict(dp=2, tp=2)])
def test_factorization_refuses_what_jax_refuses(axes):
    import jax

    from aether_tpu.parallel.mesh import make_mesh as jax_make_mesh

    with pytest.raises(AssertionError):
        jax_make_mesh(**axes, devices=jax.devices())
    with pytest.raises(ValueError):
        _factor(8, axes.get("dp"), axes.get("tp"), axes.get("sp"))


MESHES = {"dp2_tp2": (dict(dp=2, tp=2), 1), "all_tp": (dict(), 1),
          "sp2": (dict(sp=2), 1), "tp2_two_replicas": (dict(dp=1, tp=2), 2)}


def rank_meshes():
    """Each mesh of ``MESHES`` on this rank: its axes, this rank's
    coordinates and the ranks of its line along each axis."""
    import torch.distributed as dist

    from aether_tpu_torch.parallel import axis_rank, axis_size, initialize
    from aether_tpu_torch.parallel import make_mesh

    initialize(device="cpu")
    seen = {}
    for name, (axes, replicas) in MESHES.items():
        mesh = make_mesh(**axes, replicas=replicas)
        seen[name] = {axis: (axis_size(mesh, axis), axis_rank(mesh, axis),
                             dist.get_process_group_ranks(mesh.get_group(axis)))
                      for axis in mesh.mesh_dim_names}
    return seen


def test_meshes_on_four_ranks():
    import jax

    from aether_tpu.parallel.mesh import make_mesh as jax_make_mesh

    got = spawn("test_torch_parallel_distributed:rank_meshes", 4, {}, extra_path=[HERE],
                env=ENV)
    for name, (axes, replicas) in MESHES.items():
        per_replica = 4 // replicas
        for r0 in range(0, 4, per_replica):
            devices = jax.devices()[r0:r0 + per_replica]
            ref = jax_make_mesh(**axes, devices=devices)
            ids = np.vectorize(lambda d: d.id)(ref.devices)
            for rank in range(r0, r0 + per_replica):
                seen = got[rank][name]
                assert list(seen) == list(ref.axis_names), (name, list(seen))
                coords = [int(c[0]) for c in np.nonzero(ids == rank)]
                for i, axis in enumerate(ref.axis_names):
                    line = np.moveaxis(ids, i, 0)[(slice(None),) + tuple(
                        c for j, c in enumerate(coords) if j != i)]
                    assert seen[axis] == (ref.shape[axis], coords[i],
                                          [int(x) for x in line]), (name, rank, axis)

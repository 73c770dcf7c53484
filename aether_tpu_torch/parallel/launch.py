"""Run one function on several local ranks, one process each.

``spawn("pkg.module:function", world_size, kwargs)`` starts ``world_size``
processes of ``python -m aether_tpu_torch.parallel.launch``, each with the
variables ``torchrun`` sets (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR=127.0.0.1``, a free ``MASTER_PORT``), so that
:func:`~aether_tpu_torch.parallel.initialize` in the function joins them.
Each process calls ``function(**kwargs)`` and hands its return value back
(``torch.save`` through a temporary directory); ``spawn`` returns them in
rank order, or raises with every rank's output if one fails or the time runs
out, after ending all of them. ``start`` returns the running ranks at once
(``Ranks.procs``, ``Ranks.join``), for a caller that talks to them first. ``extra_path`` entries are put on each child's
``PYTHONPATH`` (a test directory, a script's directory).

:func:`run_main` as the target runs a CLI's ``main(argv)`` on every rank.
Used by the parallel tests (gloo ranks on the CPU) and by ``chip_smoke.py``
(two ranks sharing one card). A real deployment launches with ``torchrun``.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch

_REPO = str(pathlib.Path(__file__).resolve().parents[2])


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """``world_size`` running ranks of ``target`` (see :func:`start`);
    :meth:`join` waits for them and returns their results."""

    def __init__(self, target: str, world_size: int, kwargs: Optional[dict], *,
                 extra_path: Sequence[str] = (), env: Optional[dict] = None):
        self.target, self.world_size = target, world_size
        port = free_port()
        self._tmp = tempfile.TemporaryDirectory(prefix="aether_ranks_")
        tmp = self._tmp.name
        torch.save(kwargs or {}, os.path.join(tmp, "kwargs.pt"))
        path = os.pathsep.join([_REPO, *extra_path, os.environ.get("PYTHONPATH", "")])
        self.procs, self._logs = [], []
        for rank in range(world_size):
            child_env = dict(os.environ, **(env or {}), PYTHONPATH=path, RANK=str(rank),
                             LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                             MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            log = open(os.path.join(tmp, f"log_{rank}.txt"), "w+")
            self._logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "aether_tpu_torch.parallel.launch", target, tmp],
                env=child_env, stdout=log, stderr=subprocess.STDOUT))

    def join(self, timeout: float = 300.0) -> list:
        """Wait up to ``timeout`` seconds for every rank; returns each rank's
        result, rank 0 first, or raises with every rank's output (after
        ending all of them) if one fails or the time runs out."""
        failed = False
        deadline = time.monotonic() + timeout
        try:
            for proc in self.procs:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.0))
                failed = failed or proc.returncode != 0
        except subprocess.TimeoutExpired:
            failed = True
        finally:
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        try:
            outputs = []
            for log in self._logs:
                log.seek(0)
                outputs.append(log.read())
                log.close()
            if failed:
                report = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{out[-6000:]}"
                                   for r, (p, out) in enumerate(zip(self.procs, outputs)))
                raise RuntimeError(f"{self.target} failed on {self.world_size} ranks:\n"
                                   f"{report}")
            return [torch.load(os.path.join(self._tmp.name, f"result_{r}.pt"),
                               weights_only=False) for r in range(self.world_size)]
        finally:
            self._tmp.cleanup()


def start(target: str, world_size: int, kwargs: Optional[dict] = None, *,
          extra_path: Sequence[str] = (), env: Optional[dict] = None) -> Ranks:
    """Start ``target`` ("module:function") on ``world_size`` local ranks and
    return at once, so that the caller can talk to them (a server's ranks)
    before :meth:`Ranks.join`."""
    return Ranks(target, world_size, kwargs, extra_path=extra_path, env=env)


def spawn(target: str, world_size: int, kwargs: Optional[dict] = None, *,
          timeout: float = 300.0, extra_path: Sequence[str] = (),
          env: Optional[dict] = None) -> list:
    """Run ``target`` ("module:function") on ``world_size`` local ranks;
    returns each rank's result, rank 0 first."""
    return start(target, world_size, kwargs, extra_path=extra_path, env=env).join(timeout)


def run_main(module: str, argv: Sequence[str]) -> str:
    """``module.main(argv)`` on this rank (a CLI entry point, as ``torchrun
    -m module`` runs it); returns what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        importlib.import_module(module).main(list(argv))
    return buf.getvalue()


def _main(target: str, tmp: str) -> None:
    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    kwargs = torch.load(os.path.join(tmp, "kwargs.pt"), weights_only=False)
    out = os.path.join(tmp, f"result_{os.environ['RANK']}.pt")
    torch.save(fn(**kwargs), out)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2])

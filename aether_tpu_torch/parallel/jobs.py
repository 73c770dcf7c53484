"""The server's job channel: the leader hands each job to the other ranks.

The JAX server drives every chip of its mesh from one controller. The port
runs one process per card (SPMD), so a server over a mesh has a leader, rank
0, which serves HTTP and broadcasts each job (a dict of scalars and numpy
arrays, the decoded uploads included) to the followers; every rank then
makes the same pipeline calls (``apps/serve.py``).

The channel is a gloo group of its own (``dist.new_group(backend="gloo")``),
not the mesh's group: its messages are host bytes, and a follower waiting
for the next job waits in a gloo broadcast, not in an NCCL collective whose
watchdog would abort it after the NCCL timeout. Every collective of the
group still has the group's ``timeout``, so a thread of the leader sends a
keep-alive message whenever ``keepalive`` seconds (a quarter of the timeout
by default) have passed since the last message and no job is between
:meth:`JobChannel.send_job` and :meth:`JobChannel.job_done`: a server left
idle longer than any timeout still serves the next job, and the followers'
wait while the leader blends and exports a job never reaches the timeout.
Only the ranks' device calls (coupled by the mesh's own collectives) lie
between a job's broadcast and its ``job_done``.

A message is pickled and sent as two broadcasts from rank 0: its length,
then its bytes. Kinds: a job, a keep-alive, and the stop that ends the
followers' loop.
"""

from __future__ import annotations

import datetime
import pickle
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

JOB, IDLE, STOP = "job", "idle", "stop"


class JobChannel:
    """Rank 0's jobs, broadcast to every rank of the process group over a
    gloo group of its own. Every rank builds it, in the same order as its
    other groups (``new_group`` is collective). On the leader a daemon
    thread sends the keep-alive messages; a failure there is kept in
    :attr:`error` and handed to ``on_error`` (the server stops)."""

    def __init__(self, timeout: float = 1800.0, keepalive: Optional[float] = None):
        if not dist.is_initialized():
            raise RuntimeError("a job channel needs a process group: call "
                               "aether_tpu_torch.parallel.initialize() first")
        self.timeout = float(timeout)
        self.keepalive = self.timeout / 4 if keepalive is None else float(keepalive)
        if not 0 < self.keepalive < self.timeout:
            raise ValueError(f"keepalive {self.keepalive} s must be within (0, "
                             f"{self.timeout}) s, the group's timeout")
        self.group = dist.new_group(backend="gloo",
                                    timeout=datetime.timedelta(seconds=self.timeout))
        self.rank = dist.get_rank()
        self.jobs = 0  # jobs sent (the leader) or received (a follower)
        self.error: Optional[BaseException] = None
        self.on_error = None
        self._last = time.monotonic()
        self._lock = threading.Lock()  # one collective of the group at a time
        self._busy = False  # a job is between send_job and job_done
        self._stopped = threading.Event()
        if self.is_leader:
            threading.Thread(target=self._keep_alive, daemon=True).start()

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def _broadcast(self, message: Optional[dict] = None) -> dict:
        """Rank 0's ``message`` on every rank."""
        if self.is_leader:
            payload = bytearray(pickle.dumps(message, protocol=pickle.HIGHEST_PROTOCOL))
            size = torch.tensor([len(payload)], dtype=torch.int64)
        else:
            size = torch.zeros(1, dtype=torch.int64)
        dist.broadcast(size, src=0, group=self.group)
        if self.is_leader:
            data = torch.frombuffer(payload, dtype=torch.uint8)
        else:
            data = torch.empty(int(size[0]), dtype=torch.uint8)
        dist.broadcast(data, src=0, group=self.group)
        self._last = time.monotonic()
        if self.is_leader:
            return message
        return pickle.loads(data.numpy().tobytes())

    def _keep_alive(self) -> None:
        """The leader's thread: a keep-alive message whenever ``keepalive``
        seconds have passed since the last message, outside jobs."""
        while not self._stopped.wait(min(self.keepalive / 4, 1.0)):
            with self._lock:
                if (self._busy or self._stopped.is_set()
                        or time.monotonic() - self._last < self.keepalive):
                    continue
                try:
                    self._broadcast({"kind": IDLE})
                except Exception as exc:  # noqa: BLE001 -- a follower is gone
                    self.error = exc
            if self.error is not None:
                if self.on_error is not None:
                    self.on_error(self.error)
                return

    def send_job(self, params: dict) -> None:
        """The leader: hand ``params`` to every follower."""
        with self._lock:
            if self.error is not None:
                raise RuntimeError(f"the job channel failed: {self.error}")
            self._busy = True
            self._broadcast({"kind": JOB, "params": params})
            self.jobs += 1

    def stop(self) -> None:
        """The leader: end the followers' loop (and the keep-alive thread)."""
        self._stopped.set()
        with self._lock:
            if self.error is None:
                self._broadcast({"kind": STOP})

    def receive(self) -> Optional[dict]:
        """A follower: the next job's params, or None at the stop message
        (keep-alive messages are skipped)."""
        while True:
            message = self._broadcast()
            if message["kind"] == JOB:
                self.jobs += 1
                return message["params"]
            if message["kind"] == STOP:
                return None

    def job_done(self) -> None:
        """Every rank after a job's device calls: returns once all of them
        have finished theirs, and raises where a rank is gone (a rank whose
        calls failed leaves without joining)."""
        dist.barrier(group=self.group)
        with self._lock:
            self._busy = False
            self._last = time.monotonic()

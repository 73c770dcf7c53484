"""Per-stage timing, stage listeners and device traces, in PyTorch.

Port of ``aether_tpu/utils/profiling.py``: ``stage_timer`` wraps a host-side
stage with wall-clock accounting (accumulated in a process-wide registry,
read by ``stage_report``) and tells the registered stage listeners where the
stage begins and ends; live front-ends (``apps/serve.py``) surface progress
through them without the pipeline knowing about them. ``device_trace`` wraps
a block in a ``torch.profiler`` range and, with ``trace_dir``, writes a
Chrome trace of it.

The registry and the listener list are shared by every thread of the process
(the server's worker thread and its HTTP threads), each behind a lock.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

logger = logging.getLogger("aether_tpu_torch")

_LOCK = threading.Lock()
_STAGE_TOTALS: Dict[str, float] = defaultdict(float)
_STAGE_COUNTS: Dict[str, int] = defaultdict(int)
_STAGE_LISTENERS: list = []


def add_stage_listener(fn) -> None:
    """Register ``fn(name, event, seconds)`` to observe stage boundaries.

    ``event`` is "begin" (seconds=0.0), "end" (seconds=elapsed) or
    "progress" (seconds=fraction done). Listener exceptions are swallowed:
    observability must never break the computation."""
    with _LOCK:
        _STAGE_LISTENERS.append(fn)


def remove_stage_listener(fn) -> None:
    with _LOCK:
        if fn in _STAGE_LISTENERS:
            _STAGE_LISTENERS.remove(fn)


def has_stage_listeners() -> bool:
    """True when a live front-end is observing stages. Loops use this to
    decide whether a host sync for sub-stage progress is worth paying (no
    listener: never block, no extra work)."""
    return bool(_STAGE_LISTENERS)


def notify_stage_progress(name: str, frac: float) -> None:
    """Emit a fractional progress event inside a running stage: listeners
    receive ``(name, "progress", frac)`` with frac in (0, 1]. The denoise loop
    fires one a step (the reference's per-step progress bar,
    ``pipeline:824``)."""
    _notify(name, "progress", frac)


def _notify(name: str, event: str, seconds: float) -> None:
    with _LOCK:
        listeners = list(_STAGE_LISTENERS)
    for fn in listeners:
        try:
            fn(name, event, seconds)
        except Exception:  # noqa: BLE001 -- see add_stage_listener
            pass


@contextlib.contextmanager
def stage_timer(name: str, log: bool = True) -> Iterator[None]:
    """Time a host-side stage; accumulates into the process-wide report."""
    t0 = time.perf_counter()
    _notify(name, "begin", 0.0)
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            _STAGE_TOTALS[name] += dt
            _STAGE_COUNTS[name] += 1
        _notify(name, "end", dt)
        if log:
            logger.info("stage %s: %.3fs", name, dt)


def stage_report(reset: bool = False) -> Dict[str, Dict[str, float]]:
    """Accumulated {stage: {total_s, count, mean_s}} since the last reset."""
    with _LOCK:
        report = {
            name: {"total_s": total, "count": _STAGE_COUNTS[name],
                   "mean_s": total / max(_STAGE_COUNTS[name], 1)}
            for name, total in _STAGE_TOTALS.items()
        }
        if reset:
            _STAGE_TOTALS.clear()
            _STAGE_COUNTS.clear()
    return report


@contextlib.contextmanager
def device_trace(name: str, trace_dir: Optional[str] = None) -> Iterator[None]:
    """Mark a block as the profiler range ``name`` and time it as a stage;
    with ``trace_dir``, profile it (CPU, and CUDA where there is a card) and
    write ``<trace_dir>/<name>.json``, a Chrome trace (Perfetto reads it)."""
    with contextlib.ExitStack() as ctx:
        prof = None
        if trace_dir is not None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = ctx.enter_context(torch.profiler.profile(activities=activities))
        with torch.profiler.record_function(name), stage_timer(name, log=False):
            yield
    if prof is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name.replace('/', '_')}.json"))

"""What the three attention benchmark entry points share: arguments, inputs,
timing and the printed lines."""

from __future__ import annotations

import argparse
import re
import statistics
import time
from typing import Callable, List, Optional, Tuple

import torch

# the AetherV1 attention shape: 226 text + 14850 video tokens, 48 heads x 64
FULL_HEADS, FULL_SEQ = 48, 15076
# --device cpu: the plain PyTorch versions at a small shape
CPU_HEADS, CPU_SEQ = 4, 300
HEAD_DIM = 64
SEED = 0

# "<name>: <ms> ms[  maxdiff=<err>]" or "<name>: FAILED <Exception>: <message>"
LINE = re.compile(r"^(?P<name>[^:]+): +(?:(?P<ms>[0-9.]+) ms(?:  maxdiff=(?P<err>[0-9.e+-]+))?"
                  r"|FAILED (?P<exc>\w+): (?P<msg>.*))$")


def parse_args(argv: Optional[List[str]], description: str) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without one) or cpu (plain versions)")
    p.add_argument("--iters", type=int, default=5, help="timed calls per configuration")
    args = p.parse_args(argv)
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark times the Hopper kernels; "
                           "pass --device cpu to run the plain versions")
    return args


def make_qkv(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Seeded bf16 q, k and v on ``device``: (1, 48, 15076, 64) on cuda,
    (1, 4, 300, 64) on the cpu."""
    device = torch.device(device)
    on_cpu = device.type == "cpu"
    shape = (1, CPU_HEADS if on_cpu else FULL_HEADS, CPU_SEQ if on_cpu else FULL_SEQ, HEAD_DIM)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    return tuple(torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                 for _ in range(3))


def timeit(fn: Callable[[], torch.Tensor], device: torch.device, iters: int):
    """(ms per call, the first call's output). The first call warms up; on
    CUDA the ``iters`` calls after it are timed with events (their mean), on
    the CPU each with the host clock (their median)."""
    out = fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters, out
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def max_diff(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (out.float() - ref).abs().max().item()


class Lines:
    """Prints each result line at once and keeps it for the caller."""

    def __init__(self):
        self.lines: List[str] = []

    def emit(self, line: str) -> None:
        print(line, flush=True)
        self.lines.append(line)

    def timed(self, name: str, ms: float, err: Optional[float] = None) -> None:
        tail = "" if err is None else f"  maxdiff={err:.3e}"
        self.emit(f"{name}: {ms:9.4f} ms{tail}")

    def failed(self, name: str, exc: Exception, limit: Optional[int] = None) -> None:
        msg = str(exc) if limit is None else str(exc)[:limit]
        self.emit(f"{name}: FAILED {type(exc).__name__}: {msg}")

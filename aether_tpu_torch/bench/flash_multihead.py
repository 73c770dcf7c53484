"""Bench K8 (``flash_mh``): hper heads per grid cell.

Counterpart of ``scripts/bench_flash_multihead.py`` at (1, 48, 15076, 64)
bf16: the K4 production kernel (``ops.flash_attention.flash_attention``), then
the script's seven (hper, block_q, block_k) configurations, the sequence
padded to ``lcm(block_q, block_k)``. ``maxdiff`` is the largest difference
from the K4 output on the last 256 rows of the first two heads. A
configuration whose hper does not divide the head count is skipped, as the
script skips it.

    python -m aether_tpu_torch.bench.flash_multihead [--device cpu] [--iters N]
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from aether_tpu_torch.bench._harness import Lines, make_qkv, max_diff, parse_args, timeit
from aether_tpu_torch.ops.flash_attention import flash_attention
from aether_tpu_torch.ops.flash_variants import flash_mh

# (hper, block_q, block_k), bench_flash_multihead.py:151-153
SWEEP = [(4, 1024, 1024), (8, 1024, 1024), (12, 1024, 1024), (4, 1280, 1280),
         (4, 768, 1024), (16, 1024, 1024), (4, 1024, 1024)]


def compared(o: torch.Tensor) -> torch.Tensor:
    """The part of an output that ``maxdiff`` reads."""
    return o[0, :2, -256:]


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Runs the sweep; returns the printed lines."""
    args = parse_args(argv, __doc__.splitlines()[0])
    q, k, v = make_qkv(args.device)
    out = Lines()
    ms, ref = timeit(lambda: flash_attention(q, k, v), args.device, args.iters)
    refn = compared(ref).float()
    out.timed("prod kernel (K4)", ms)
    for hper, bq, bk in SWEEP:
        if q.shape[1] % hper:
            continue
        name = f"mh hper={hper} {bq}x{bk}"

        def fn(hper=hper, bq=bq, bk=bk):
            return flash_mh(q, k, v, block_q=bq, block_k=bk, hper=hper)

        try:
            ms, o = timeit(fn, args.device, args.iters)
            out.timed(name, ms, max_diff(compared(o), refn))
        except Exception as e:  # the line records the failure, as the script's does
            out.failed(name, e, 120)
    return out.lines


if __name__ == "__main__":
    main(sys.argv[1:])

"""Bench K9 (``flash_x``): the four softmax modes, then a block sweep of padfix.

Counterpart of ``scripts/bench_flash_bisect.py`` at (1, 48, 15076, 64) bf16:
the K4 baseline (``ops.flash_attention.flash_attention``) at 1024 x 1024
blocks, the modes ``fold`` (exp, masked), ``fold2`` (exp2, masked),
``padfix`` (exp2, no mask, the pad keys' mass taken out of l at the end) and
``padfix_exp`` at 1024 x 1024, then padfix at the script's seven block
shapes. ``maxdiff`` is the largest difference from the baseline on the last
256 rows of the first two heads.

    python -m aether_tpu_torch.bench.flash_bisect [--device cpu] [--iters N]
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from aether_tpu_torch.bench._harness import Lines, make_qkv, max_diff, parse_args, timeit
from aether_tpu_torch.ops.flash_attention import flash_attention
from aether_tpu_torch.ops.flash_variants import FLASH_X_MODES, flash_x

# (block_q, block_k) of the padfix sweep, bench_flash_bisect.py:183-184
BLOCKS = [(512, 1024), (1024, 512), (512, 512), (2048, 512), (512, 2048),
          (256, 1024), (1024, 256)]


def compared(o: torch.Tensor) -> torch.Tensor:
    """The part of an output that ``maxdiff`` reads."""
    return o[0, :2, -256:]


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Runs the modes and the sweep; returns the printed lines."""
    args = parse_args(argv, __doc__.splitlines()[0])
    q, k, v = make_qkv(args.device)
    out = Lines()
    ms, ref = timeit(lambda: flash_attention(q, k, v, block_q=1024, block_k=1024),
                     args.device, args.iters)
    refn = compared(ref).float()
    out.timed("base 1024x1024", ms)

    def run(name, limit, **kw):
        try:
            ms, o = timeit(lambda: flash_x(q, k, v, **kw), args.device, args.iters)
            out.timed(name, ms, max_diff(compared(o), refn))
        except Exception as e:  # the line records the failure, as the script's does
            out.failed(name, e, limit)

    for mode in FLASH_X_MODES:
        run(f"{mode:11s} 1024x1024", 200, block_q=1024, block_k=1024, mode=mode)
    for bq, bk in BLOCKS:
        run(f"padfix {bq}x{bk}", 160, block_q=bq, block_k=bk, mode="padfix")
    return out.lines


if __name__ == "__main__":
    main(sys.argv[1:])

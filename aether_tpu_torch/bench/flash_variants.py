"""Bench K7 (``flash_v2``) at the AetherV1 attention shape.

Counterpart of ``scripts/bench_flash_variants.py``: (1, 48, 15076, 64) bf16
(226 text + 14850 video tokens) against the K4 baseline
(``ops.flash_attention.flash_attention`` at 1024 x 1024 blocks). The sweep is
the script's ten configurations: exp2 with ``sm_scale * log2(e)`` folded into
q, the mask on the last kv block only, K pre-transposed (``kt``), and block
sizes from 512 to 3072. ``maxdiff`` is the largest difference from the
baseline on the first 64 rows of the first two heads. A configuration whose
padding reaches ``block_k`` fails, as the JAX wrapper's assertion does
(``2048x1024``: a pad of 1308). One ``scaled_dot_product_attention`` call is
timed beside them as a yardstick.

    python -m aether_tpu_torch.bench.flash_variants [--device cpu] [--iters N]
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from aether_tpu_torch.bench._harness import Lines, make_qkv, max_diff, parse_args, timeit
from aether_tpu_torch.ops.flash_attention import flash_attention
from aether_tpu_torch.ops.flash_variants import flash_v2

# (block_q, block_k, kt), bench_flash_variants.py:199-210
SWEEP = [
    (1024, 1024, False),
    (1024, 1024, True),
    (1536, 1536, False),
    (1536, 1536, True),
    (2048, 1024, False),
    (1024, 2048, False),
    (2048, 2048, False),
    (3072, 1536, False),
    (1536, 3072, False),
    (512, 1536, False),
]


def compared(o: torch.Tensor) -> torch.Tensor:
    """The part of an output that ``maxdiff`` reads."""
    return o[0, :2, :64]


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Runs the sweep; returns the printed lines."""
    args = parse_args(argv, __doc__.splitlines()[0])
    q, k, v = make_qkv(args.device)
    out = Lines()
    ref = compared(flash_attention(q, k, v, block_q=1024, block_k=1024)).float()

    def check(o):
        return max_diff(compared(o), ref)

    ms, _ = timeit(lambda: flash_attention(q, k, v, block_q=1024, block_k=1024),
                   args.device, args.iters)
    out.timed("baseline 1024x1024", ms)
    for bq, bk, kt in SWEEP:
        name = f"v2 {bq}x{bk} kt={int(kt)}"

        def fn(bq=bq, bk=bk, kt=kt):
            return flash_v2(q, k, v, block_q=bq, block_k=bk, kt=kt)

        try:
            err = check(fn())
            ms, _ = timeit(fn, args.device, args.iters)
            out.timed(name, ms, err)
        except Exception as e:  # the line records the failure, as the script's does
            out.failed(name, e)

    # library yardstick (timed only; the port never calls it)
    try:
        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(q, k, v)

        err = check(sdpa())
        ms, _ = timeit(sdpa, args.device, args.iters)
        out.timed("torch sdpa library", ms, err)
    except Exception as e:
        out.failed("torch sdpa library", e)
    return out.lines


if __name__ == "__main__":
    main(sys.argv[1:])

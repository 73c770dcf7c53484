"""Time K1 (the QKV attention prologue) of one checkout on an NVIDIA GPU.

    python aether_tpu_torch/bench/time_prologue.py [CHECKOUT]

CHECKOUT is a directory that holds an ``aether_tpu_torch`` package (default:
this repository). Two versions are compared within one machine's run by
unpacking the other one with ``git archive`` into a git-ignored directory
(or copying the package there and editing the copy) and running A, B, B, A,
each in its own process: each package builds its kernels into its own
``_build/``. Prints the card's name and power limit, and, for that package,
``qkv_prologue`` at the AetherV1 window's shape, the fused [B, 15360,
3 x 3072] bf16 projection with 15076 valid tokens and seeded RoPE tables, at
batch 1 and 2 (the CFG pair), int8 codes and the float branch: three
CUDA-event means of 20 calls each, and the largest int8 code difference (or
bf16 ulp) against ``qkv_prologue_plain``; on a fresh build, K1's registers
and spill (ptxas). Timing and the ptxas names are ``chip_smoke.py``'s, as in
``time_hd_cells.py`` (K2, K3, K6). Needs CUDA; imports no JAX.
"""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
S_PAD = 15360


def worst(cs, got, ref, quantize: bool) -> str:
    """The largest int8 code difference, or bf16 ulp, over q and k."""
    out = 0.0
    for a, b in zip(got[:2], ref[:2]):
        diff = (a.int() - b.int()).abs() if quantize else cs.bf16_ulps(a.float(), b.float())
        out = max(out, diff.max().item())
    return f"{'codes' if quantize else 'ulps'} {out:g}"


def main(argv) -> None:
    checkout = os.path.abspath(argv[0]) if argv else ROOT
    # the package of that checkout, not one imported already, and the
    # helpers of its chip_smoke.py (else this repository's)
    sys.path.insert(0, checkout)
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from aether_tpu_torch.ops import _build
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue, qkv_prologue_plain

    if not _build.__file__.startswith(checkout):
        raise SystemExit(f"imported {_build.__file__}, not the package under {checkout}")
    if not torch.cuda.is_available():
        raise SystemExit("time_prologue.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"checkout {checkout}; {smi}", flush=True)
    _build.lib()
    kernel = "?"
    for line in _build.BUILD_LOG["ptxas"].splitlines():
        if "Compiling entry function" in line:
            kernel = cs.ptxas_kernel_name(line.split("'")[1])
        elif kernel.startswith("attn_prologue") and ("registers" in line or "spill" in line):
            print(f"  ptxas {kernel}: {line.strip()}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d = cs.HEADS * cs.HEAD_DIM
    norms = [1.0 + 0.1 * torch.randn(cs.HEAD_DIM, generator=gen, device=dev),
             0.1 * torch.randn(cs.HEAD_DIM, generator=gen, device=dev),
             1.0 + 0.1 * torch.randn(cs.HEAD_DIM, generator=gen, device=dev),
             0.1 * torch.randn(cs.HEAD_DIM, generator=gen, device=dev)]
    ang = torch.randn((cs.SEQ, cs.HEAD_DIM // 2), generator=gen, device=dev)
    rope = (ang.cos().repeat_interleave(2, -1), ang.sin().repeat_interleave(2, -1))
    for b in (1, 2):
        y = torch.randn((b, S_PAD, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
        y[:, cs.SEQ:] = 0  # the DiT pads the joint stream with zero rows
        xs = (y[..., :d], y[..., d:2 * d], y[..., 2 * d:])
        for quantize in (True, False):
            kw = dict(num_heads=cs.HEADS, head_dim=cs.HEAD_DIM, eps=1e-6, s_valid=cs.SEQ,
                      quantize=quantize)
            err = worst(cs, qkv_prologue(*xs, *norms, *rope, **kw),
                        qkv_prologue_plain(*xs, *norms, *rope, **kw), quantize)
            ms = " ".join(
                f"{cs.cuda_time_ms(lambda: qkv_prologue(*xs, *norms, *rope, **kw), 20):.4f}"
                for _ in range(3))
            print(f"K1 batch {b} {'int8' if quantize else 'float'}: {ms} ms; {err}",
                  flush=True)
        del y, xs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])

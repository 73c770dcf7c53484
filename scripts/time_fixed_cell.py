"""Time K2 and K3 (the fixed-shift attention) of one checkout on an NVIDIA GPU.

    python scripts/time_fixed_cell.py [CHECKOUT]

CHECKOUT is a directory that holds an ``aether_tpu_torch`` package (default:
this repository). Two versions are compared within one machine's run by
unpacking the other one with ``git archive`` into a git-ignored directory and
running parent, change, change, parent, each in its own process (the package
builds its kernels into its own ``_build/``). Prints, for that package:

- K2 (``flash_attention_prepacked``) at the main-path shape, (48, 15360, 64)
  over K1's operands with 15076 valid tokens, int8 and float: three CUDA-event
  means of 10 calls, and max / mean abs error against its plain version;
- K3 (``flash_attention_fixed_max``) at the CFG pair's (2, 48, 15076, 64)
  bf16, int8 and bf16 QK^T: three means of 5 calls through the wrapper and,
  where the package has ``_fixed_max_launch``, of the kernel alone on the
  operands the wrapper prepares; the error against the plain version;
- K3's unnormalized mode on the ring-merge stripe (3776 q rows against 15104
  kv rows, 15076 valid): the largest relative error of l;
- on a fresh build, each fixed-shift kernel's registers and spill (ptxas).
Needs CUDA; imports no JAX.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CHECKOUT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else ROOT
sys.path.insert(0, CHECKOUT)
sys.path.insert(1, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from aether_tpu_torch.ops import _build, flash_attention as fa  # noqa: E402
from aether_tpu_torch.ops.attn_prologue import qkv_prologue  # noqa: E402

H, D, S, SP, STRIPE = 48, 64, 15076, 15360, 3776


def err(a, b) -> str:
    e = (a.float() - b.float()).abs()
    return f"max {e.max().item():.3e} mean {e.mean().item():.3e}"


def times(fn, iters) -> str:
    return " ".join(f"{cs.cuda_time_ms(fn, iters):.4f}" for _ in range(3))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_fixed_cell.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(f"checkout {CHECKOUT}", flush=True)
    _build.lib()
    kernel = "?"
    for line in _build.BUILD_LOG["ptxas"].splitlines():
        if "Compiling entry function" in line:
            kernel = cs.ptxas_kernel_name(line.split("'")[1])
        elif ("registers" in line or "spill" in line) and (
                "fixed" in kernel or "prepacked" in kernel):
            print(f"  ptxas {kernel}: {line.strip()}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    d = H * D
    for quantize in (True, False):
        y = torch.randn((1, SP, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
        y[:, S:] = 0
        norms = [1.0 + 0.1 * torch.randn(D, generator=gen, device=dev),
                 0.1 * torch.randn(D, generator=gen, device=dev),
                 1.0 + 0.1 * torch.randn(D, generator=gen, device=dev),
                 0.1 * torch.randn(D, generator=gen, device=dev)]
        q, k, v, qsc, qn, ksc, kn, _ = qkv_prologue(
            y[..., :d], y[..., d:2 * d], y[..., 2 * d:], *norms, None, None,
            num_heads=H, head_dim=D, eps=1e-6, s_valid=S, quantize=quantize)
        kw = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=S)
        out = fa.flash_attention_prepacked(q, k, v, **kw)
        ref = fa.flash_attention_prepacked_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        ms = times(lambda: fa.flash_attention_prepacked(q, k, v, **kw), 10)
        print(f"K2 {'int8' if quantize else 'float'}: {ms} ms; {err(out, ref)}", flush=True)
        del y, q, k, v, out, ref
        torch.cuda.empty_cache()

    shape = (2, H, S, D)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    for qk8 in (True, False):
        out = fa.flash_attention_fixed_max(q, k, v, qk_int8=qk8)
        ref = fa.flash_attention_fixed_max_plain(q, k, v, qk_int8=qk8)
        torch.cuda.synchronize()
        line = (f"K3 {'int8' if qk8 else 'bf16'}: {err(out, ref)}; wrapper "
                f"{times(lambda: fa.flash_attention_fixed_max(q, k, v, qk_int8=qk8), 5)} ms")
        if hasattr(fa, "_fixed_max_launch"):
            ops = fa._fixed_max_operands(
                q, k, v, sm_scale=None, kv_valid=None, heads_per_cell=4, noshift=False,
                qk_int8=qk8, pv_int8=False, score_bound=None, unnormalized=False)
            buf = torch.empty((2 * H, S, D), dtype=torch.bfloat16, device=dev)
            line += f", alone {times(lambda: fa._fixed_max_launch(ops, buf, None), 5)} ms"
            del ops, buf
        print(line, flush=True)
        del out, ref

    qs = q[:1, :, :STRIPE].contiguous()
    kp, vp = (torch.nn.functional.pad(t[:1], (0, 0, 0, 4 * STRIPE - S)) for t in (k, v))
    bound = 1.0 + (qs.float().norm(dim=-1).max() * kp.float().norm(dim=-1).max()
                   * D ** -0.5 * 1.4426950408889634)
    for qk8 in (True, False):
        kw = dict(kv_valid=S, score_bound=bound, unnormalized=True, qk_int8=qk8)
        (o, l), (ro, rl) = (fa.flash_attention_fixed_max(qs, kp, vp, **kw),
                            fa.flash_attention_fixed_max_plain(qs, kp, vp, **kw))
        torch.cuda.synchronize()
        print(f"K3 unnormalized {'int8' if qk8 else 'bf16'}: l max rel err "
              f"{((l - rl).abs() / rl.abs()).max().item():.3e}", flush=True)


if __name__ == "__main__":
    main()

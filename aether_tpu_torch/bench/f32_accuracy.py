"""The f32 attention kernels' error against their plain versions as the kv
length grows, beside one f32 ``scaled_dot_product_attention`` call's, on an
NVIDIA GPU.

    python aether_tpu_torch/bench/f32_accuracy.py [CHECKOUT]

For (1, 48, S, D) f32 seeded inputs, S 1024 and 15076, D 16, 64, 96, 112 and
128, prints the max and mean abs error of K4 f32 (``flash_attention``) and of
K3 f32 with int8 QK^T (below 128) against their plain versions, and of SDPA
f32 against K4's plain version, each mean also over the mean |output|. A
kernel that adds its products into one long-lived tensor-core accumulator
shows a relative error that grows with S; one that adds each kv tile in f32
does not (``csrc/tf32x3_cell.cuh``). CHECKOUT (default: this one) is a
directory holding ``aether_tpu_torch`` and ``chip_smoke.py``. Needs CUDA;
imports no JAX.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(checkout: str) -> None:
    sys.path.insert(0, checkout)
    import chip_smoke as cs
    from aether_tpu_torch.ops import _build
    from aether_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("f32_accuracy.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.lib()
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    for s in (1024, 15076):
        for hd in (16, 64, 96, 112, 128):
            q, k, v = (torch.randn((1, 48, s, hd), generator=gen, device=dev) for _ in range(3))
            ref = fa.flash_attention_plain(q, k, v)
            scale = ref.abs().mean().item()
            rows = [("K4 f32", fa.flash_attention(q, k, v), ref)]
            if hd < 128:
                rows.append(("K3 f32 int8", fa.flash_attention(q, k, v, fixed_max=True,
                                                                qk_int8=True),
                             fa.flash_attention_fixed_max_plain(q, k, v, qk_int8=True)))
            for name, out, r in rows:
                err = (out - r).abs()
                print(f"{checkout} kv {s} hd {hd} {name}: max {err.max().item():.3e} mean "
                      f"{err.mean().item():.3e}, mean rel {err.mean().item() / scale:.3e}",
                      flush=True)
            e_max, e_mean = cs.sdpa_errors(q, k, v, ref)
            print(f"{checkout} kv {s} hd {hd} SDPA f32: max {e_max:.3e} mean {e_mean:.3e}, "
                  f"mean rel {e_mean / scale:.3e}", flush=True)
            del q, k, v, ref, rows
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ROOT)

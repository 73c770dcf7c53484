#!/usr/bin/env python3
"""Device-time breakdown of one AetherV1 reconstruction request of the PyTorch
port, on one CUDA GPU.

    python3 scripts/profile_torch_reconstruction.py [--batch_windows 1|2]

Builds the AetherV1 pipeline with seeded random bf16 weights (as
``chip_smoke.py``), runs one warm-up request on a seeded 41x480x720 clip, then
one request under ``torch.profiler`` (``--batch_windows 2``: one
``batch_reconstruct`` of two windows). Prints the card's name and power limit,
the request's host seconds profiled and unprofiled, and for each pipeline stage
(the ``aether.encode/denoise/decode`` ranges) its wall time, its busy device
time and the device time by kernel class. It also counts the memory layout of
every GroupNorm input (NCTHW contiguous or channels-last), which decides the
K5 kernel's read pattern.
"""

import argparse
import collections
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAMES, HEIGHT, WIDTH, STEPS = 41, 480, 720, 4
STAGES = ("encode", "denoise", "decode")
# kernel class by a substring of the kernel's name, first match wins
CLASSES = (
    ("K1", ("prologue_",)), ("K2", ("flash_prepacked",)), ("K5", ("moments_",)),
    ("conv", ("fprop", "conv", "cudnn", "implicit_convolve", "winograd", "dgrad")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas")),
    ("copies / casts", ("copy", "Memcpy", "Memset", "cast", "CatArray", "cat_",
                        "transpose", "permute", "nchwToNhwc", "nhwcToNchw")),
    ("reductions", ("reduce", "Reduce", "norm", "mean", "sum")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)


def kernel_class(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch_windows", type=int, default=1, choices=[1, 2])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("this profile needs a CUDA device")
    from aether_tpu_torch.config import PipelineConfig
    from aether_tpu_torch.models import init_dit, init_vae
    from aether_tpu_torch.models.vae import GroupNorm
    from aether_tpu_torch.pipeline import AetherPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    cfg = PipelineConfig.aetherv1()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    pipe = AetherPipeline(
        cfg, init_dit(cfg.dit, device=dev, dtype=torch.bfloat16, seed=0),
        init_vae(cfg.vae, device=dev, dtype=torch.bfloat16, seed=1),
        torch.randn((1, cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim),
                    generator=gen, device=dev),
        device=dev, compute_dtype=torch.bfloat16)
    video = np.random.default_rng(7).integers(0, 256, (FRAMES, HEIGHT, WIDTH, 3),
                                              dtype=np.uint8)
    kw = dict(height=HEIGHT, width=WIDTH, num_frames=FRAMES, num_inference_steps=STEPS,
              fps=12, seed=42)

    def request():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if args.batch_windows == 1:
            pipe(task="reconstruction", video=video, **kw)
        else:
            pipe.batch_reconstruct(np.stack([video, video[::-1]]), **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    layouts = collections.Counter()

    def note_layout(_mod, inputs):
        x = inputs[0]
        layouts["contiguous" if x.is_contiguous() else "channels-last"
                if x.is_contiguous(memory_format=torch.channels_last_3d) else "other"] += 1

    hooks = [m.register_forward_pre_hook(note_layout) for m in pipe.vae.modules()
             if isinstance(m, GroupNorm)]
    warm = request()
    for h in hooks:
        h.remove()
    plain = request()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled = request()
    print(f"batch_windows {args.batch_windows}: warm-up {warm:.3f} s, request {plain:.3f} s, "
          f"profiled {profiled:.3f} s; GroupNorm input layouts {dict(layouts)}", flush=True)

    events = prof.events()
    ranges = {e.name[len("aether."):]: e.time_range for e in events
              if e.name in {f"aether.{s}" for s in STAGES}
              and e.device_type == torch.autograd.DeviceType.CPU}
    per = {s: collections.defaultdict(float) for s in STAGES}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith("aether."):
            continue
        start = e.time_range.start
        for stage, r in ranges.items():
            if r.start <= start <= r.end:
                per[stage][kernel_class(e.name)] += e.time_range.elapsed_us() / 1e6
                break
    for stage in STAGES:
        if stage not in ranges:
            continue
        wall = ranges[stage].elapsed_us() / 1e6
        busy = sum(per[stage].values())
        parts = ", ".join(f"{cls} {sec:.3f}" for cls, sec in
                          sorted(per[stage].items(), key=lambda kv: -kv[1]))
        print(f"{stage}: wall {wall:.3f} s, device busy {busy:.3f} s "
              f"({100 * busy / wall:.1f}%): {parts}", flush=True)


if __name__ == "__main__":
    main()

"""How far the tp = 2 DiT departs from one process, block by block, and how
far a departure of that size carries into a served prediction job, on an
NVIDIA GPU.

    python -m aether_tpu_torch.bench.tp_departure [--configs 1x4 2x4 2x2]
        [--json OUT]

Each config is ``BLOCKS x STEPS``: the AetherV1 width (48 heads x 64, bf16,
seeded random weights: DiT seed 0, VAE seed 1, prompt seed 2) cut to BLOCKS
DiT blocks, and the prediction job of ``chip_smoke.py`` phase 25 (the seeded
480x720 image, the ``forward_right`` raymap, STEPS CFG steps at batch 2, then
the 4-step post-reconstruction at batch 1), run as the server runs it
(``apps.serve.job_calls``). For each config:

1. one process runs the job, recording every DiT call's inputs and output;
2. two ranks over gloo sharing cuda:0 build the same pipeline over a tp = 2
   mesh (24 heads a rank) and (a) feed each recorded call's inputs to the
   sharded DiT, while rank 0 feeds them to an unsharded copy of the same
   weights: each block's attention and MLP outputs and the DiT's output,
   max abs and mean abs departure over the reference's max abs (the scale);
   (b) run the job itself: the DiT's output at each call against the one
   process's (the departure compounded over the steps), and the exported
   rgb, disparity and poses against the one process's as phase 25c compares
   them (mean abs <= 1e-2 and max <= 0.25 of max(1, max |ref|));
3. the sensitivity control: one process runs the job again with the DiT's
   output at call i perturbed by seeded Gaussian noise of the RMS that (a)
   measured at call i, and its exports are held to the unperturbed run's in
   the same way. If the control departs as far as tp does, the gate measures
   how the random-weight job amplifies rounding, not a fault of tp.

Prints one JSON line a config (and writes them all to ``--json``). Needs
CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HEIGHT, WIDTH, FRAMES, LONG_FRAMES = 480, 720, 41, 65


def _pipeline(dev, blocks, mesh=None):
    from aether_tpu_torch.config import PipelineConfig
    from aether_tpu_torch.models import init_dit, init_vae
    from aether_tpu_torch.pipeline import AetherPipeline

    cfg = PipelineConfig.aetherv1()
    cfg = dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, num_layers=blocks))
    dit = init_dit(cfg.dit, device=dev, dtype=torch.bfloat16, seed=0)
    vae = init_vae(cfg.vae, device=dev, dtype=torch.bfloat16, seed=1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    prompt = torch.randn((1, cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim),
                         generator=gen, device=dev)
    return AetherPipeline(cfg, dit, vae, prompt, device=dev, compute_dtype=torch.bfloat16,
                          mesh=mesh)


def _params(steps):
    """Phase 25's tp job: its image is the second draw of the seeded uploads."""
    from aether_tpu_torch.apps.actions import action_raymap

    rng = np.random.default_rng(25)
    rng.integers(0, 256, (LONG_FRAMES, HEIGHT, WIDTH, 3), dtype=np.uint8)  # the clip
    image = rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)
    return {"task": "prediction", "num_frames": FRAMES, "fps": 12, "height": HEIGHT,
            "width": WIDTH, "seed": 42, "steps": steps, "image_array": image,
            "raymap_array": action_raymap("forward_right", num_frames=FRAMES, height=HEIGHT,
                                          width=WIDTH),
            "post_reconstruction": True}


def _exports(results, dev):
    """(rgb, disparity, poses [F, 16]) as the server exports a prediction job
    (``JobRunner._export`` through ``demo.save_output``'s blend)."""
    from aether_tpu_torch.pipeline.aether import AetherPipelineOutput
    from aether_tpu_torch.pipeline.windowing import blend_and_merge_window_results

    out, recon = results
    last = recon or out
    window = AetherPipelineOutput(rgb=out.rgb, disparity=last.disparity, raymap=last.raymap)
    _, _, poses, _ = blend_and_merge_window_results(
        [window], [0], HEIGHT, WIDTH, smooth_camera=True, smooth_method="kalman",
        align_pointmaps=False, device=dev)
    return (np.asarray(out.rgb), np.asarray(last.disparity),
            np.asarray(poses).reshape(len(poses), -1))


def gate(got, ref):
    """Phase 25c's comparison: {field: (max, mean, max |ref| floored at 1,
    within the gates)}."""
    out = {}
    for field, g, r in zip(("rgb", "disparity", "poses"), got, ref):
        d = np.abs(g - r)
        top = max(1.0, float(np.abs(r).max()))
        out[field] = (float(d.max()), float(d.mean()), top,
                      bool(d.mean() <= 1e-2 * top and d.max() <= 0.25 * top))
    return out


def _departure(got, ref):
    """(max abs, mean abs) of got - ref over max |ref|, and RMS of got - ref."""
    d = (got.float() - ref.float()).abs()
    top = ref.float().abs().max().clamp_min(1e-30)
    return (float(d.max() / top), float(d.mean() / top),
            float((got.float() - ref.float()).square().mean().sqrt()))


def run_job(pipe, params, dev, perturb=None):
    """The job's device calls and exports; every DiT call's (inputs, output)
    on the host. ``perturb``: per-call RMS of Gaussian noise added to the
    DiT's output (seeded)."""
    from aether_tpu_torch.apps.serve import job_calls

    calls = []
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)

    def hook(module, args, kwargs, output):
        if perturb is not None:
            noise = torch.randn(output.shape, generator=gen, device=output.device)
            output = (output.float() + perturb[len(calls)] * noise).to(output.dtype)
        calls.append(([a.cpu() if torch.is_tensor(a) else a for a in args], dict(kwargs),
                      output.cpu()))
        return output

    handle = pipe.dit.register_forward_hook(hook, with_kwargs=True)
    try:
        results = job_calls(pipe, params)
    finally:
        handle.remove()
    torch.cuda.synchronize()
    return calls, _exports(results, dev)


def _block_outputs(dit, args, kwargs):
    """The DiT's output on (args, kwargs), with each block's attention and
    MLP outputs (attn: video and text parts concatenated)."""
    seen = {}
    handles = []
    for i, block in enumerate(dit.blocks):
        def attn_hook(module, a, out, i=i):
            seen[f"block {i} attention"] = torch.cat([o.float() for o in out], dim=1).cpu()

        def mlp_hook(module, a, out, i=i):
            seen[f"block {i} mlp"] = out.float().cpu()

        handles += [block.attn.register_forward_hook(attn_hook),
                    block.mlp.register_forward_hook(mlp_hook)]
    try:
        with torch.no_grad():
            out = dit(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    seen["DiT output"] = out.float().cpu()
    return seen


def rank(blocks, steps, record):
    """On one of two gloo ranks sharing cuda:0: (a) the sharded DiT on each
    recorded call's inputs, rank 0 against an unsharded copy; (b) the job over
    the tp = 2 mesh. Returns rank 0's departures."""
    import torch.distributed as dist

    from aether_tpu_torch.models import init_dit
    from aether_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    me = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                            f"{os.environ['MASTER_PORT']}", rank=me, world_size=2)
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = _pipeline(dev, blocks, make_mesh(dp=1, tp=2, device_type="cuda"))
    heads = pipe.dit.blocks[0].attn.qkv.weight.shape[0] // 3 // 64
    calls = torch.load(record, weights_only=False)["calls"]
    one = init_dit(pipe.config.dit, device=dev, dtype=torch.bfloat16, seed=0) if me == 0 else None
    per_call = []
    for args, kwargs, _ in calls:
        args = [a.to(dev) if torch.is_tensor(a) else a for a in args]
        got = _block_outputs(pipe.dit, args, kwargs)
        if me == 0:
            ref = _block_outputs(one, args, kwargs)
            per_call.append({name: _departure(got[name], ref[name]) for name in ref})
    del one
    torch.cuda.empty_cache()
    dist.barrier()
    tp_calls, tp_exports = run_job(pipe, _params(steps), dev)
    dist.barrier()
    dist.destroy_process_group()
    if me != 0:
        return None
    return {"heads": heads, "per_call": per_call,
            "trajectory": [_departure(o, r) for (_, _, o), (_, _, r) in zip(tp_calls, calls)],
            "exports": tp_exports}


def run_config(blocks, steps, dev, tmp):
    from aether_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    pipe = _pipeline(dev, blocks)
    params = _params(steps)
    calls, one = run_job(pipe, params, dev)
    record = os.path.join(tmp, f"calls_{blocks}x{steps}.pt")
    torch.save({"calls": calls}, record)
    # the two ranks need the card's memory: this process keeps nothing there
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    ranks = spawn("aether_tpu_torch.bench.tp_departure:rank", 2,
                  dict(blocks=blocks, steps=steps, record=record), timeout=900,
                  env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    r0 = ranks[0]
    sigma = [c["DiT output"][2] for c in r0["per_call"]]
    pipe = _pipeline(dev, blocks)
    _, control = run_job(pipe, params, dev, perturb=sigma)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    worst = {}
    for c in r0["per_call"]:
        for name, (mx, mean, _) in c.items():
            key = name.split(" ", 2)[-1] if name.startswith("block") else name
            w = worst.setdefault(key, [0.0, 0.0])
            w[0], w[1] = max(w[0], mx), max(w[1], mean)
    return {"config": f"{blocks} blocks x {steps} steps", "heads_a_rank": r0["heads"],
            "dit_calls": len(calls),
            "per_forward": r0["per_call"],
            "per_forward_worst": worst,
            "perturbation_rms": sigma,
            "trajectory": r0["trajectory"],
            "tp_against_one_process": gate(r0["exports"], one),
            "control_against_one_process": gate(control, one),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=["1x4", "2x4", "2x2"])
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tp_departure needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    with tempfile.TemporaryDirectory(prefix="tp_departure_") as tmp:
        for cfg in args.configs:
            blocks, steps = map(int, cfg.split("x"))
            res = dict(run_config(blocks, steps, dev, tmp), device=smi)
            print(json.dumps(res), flush=True)
            out.append(res)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])

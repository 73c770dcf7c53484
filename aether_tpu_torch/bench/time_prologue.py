"""Time K1 (the QKV attention prologue) at every head dim, one checkout against
another, on an NVIDIA GPU.

    python aether_tpu_torch/bench/time_prologue.py unpack REV DIR
    python aether_tpu_torch/bench/time_prologue.py ab DIR [--json OUT]
    python aether_tpu_torch/bench/time_prologue.py run [CHECKOUT] [--json OUT]

``unpack`` (in a git checkout) writes revision REV's ``aether_tpu_torch`` and
``chip_smoke.py`` into DIR with ``git archive``; make DIR a git-ignored
directory of this repository (``_checkout/parent``) so that a copy of the
working tree carries it to the card. ``ab`` runs DIR, this checkout, this
checkout, DIR, each in its own process (each package builds its kernels
into its own ``_build/``), prints every case's four times side by side and
fails unless every head_dim-64 output is bit-identical across the four runs.
``run`` times one checkout (default: this one) and prints, for that package:

- the card's name and power limit, and on a fresh build K1's registers and
  spill (ptxas);
- ``qkv_prologue`` at the AetherV1 window's shape, the fused [B, 15360,
  3 x 48 x 64] bf16 projection with 15076 valid tokens and seeded RoPE
  tables, at batch 1 and 2 (the CFG pair), int8 codes and the float branch;
- the same at batch 1 at head_dim 16, 32, 48, 80, 96 and 112 ([1, 15360,
  3 x 48 x D]);
- for each case three CUDA-event means of 20 calls through the wrapper, as
  ``chip_smoke.py`` times it (at the small head dims the wrapper's host
  time, not the card, can set that pace), and of 20 calls replayed from a
  CUDA graph (the card's time alone, "graph"), the share of the bytes
  bound (``chip_smoke.py``'s ``bound``: the valid rows of q, k and v and the
  RoPE tables read once, int8 or bf16 q and k and bf16 v written), the
  largest int8 code difference (or bf16 ulp) against ``qkv_prologue_plain``,
  whether two launches are bit-identical, and a digest of the outputs.

Timing and the ptxas names are ``chip_smoke.py``'s, as in
``time_hd_cells.py`` (K2, K3, K4, K6). Needs CUDA for ``run`` and ``ab``;
imports no JAX.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
S_PAD = 15360
OTHER_HEAD_DIMS = (16, 32, 48, 80, 96, 112)


def unpack(rev: str, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    archive = subprocess.run(["git", "archive", rev, "aether_tpu_torch", "chip_smoke.py"],
                             cwd=ROOT, check=True, capture_output=True).stdout
    subprocess.run(["tar", "-x", "-C", out], input=archive, check=True)
    print(f"unpacked {rev} into {out}")


def digest(outputs) -> str:
    """The first 16 hex digits of the sha256 of the outputs' bytes."""
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: the kernels back to back, without the host's time
    between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def worst(cs, got, ref, quantize: bool) -> float:
    """The largest int8 code difference, or bf16 ulp, over q and k."""
    out = 0.0
    for a, b in zip(got[:2], ref[:2]):
        diff = (a.int() - b.int()).abs() if quantize else cs.bf16_ulps(a.float(), b.float())
        out = max(out, diff.max().item())
    return out


def run(checkout: str, out_json) -> None:
    # the package of that checkout, not one imported already, and the
    # helpers of its chip_smoke.py (else this repository's)
    sys.path.insert(0, checkout)
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from aether_tpu_torch.ops import _build
    from aether_tpu_torch.ops import attn_prologue as ap

    if not _build.__file__.startswith(checkout):
        raise SystemExit(f"imported {_build.__file__}, not the package under {checkout}")
    if not torch.cuda.is_available():
        raise SystemExit("time_prologue.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"checkout {checkout}; {smi}", flush=True)
    # chip_smoke.py's bound reads the SFU rate main() sets (K1 does no exp2,
    # so it adds nothing here)
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.strip().splitlines()[0])
    cs.SFU_PER_S = (cs.SFU_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(dev)
                    .multi_processor_count * max_sm_mhz * 1e6)
    _build.lib()
    kernel = "?"
    ptxas = []
    for line in _build.BUILD_LOG["ptxas"].splitlines():
        if "Compiling entry function" in line:
            # with its template arguments: head dim, rows, quantize
            kernel = cs.ptxas_kernel_name(line.split("'")[1])
        elif kernel.startswith("attn_prologue") and ("registers" in line or "spill" in line):
            ptxas.append(f"{kernel}: {line.strip()}")
            print(f"  ptxas {ptxas[-1]}", flush=True)
    result = {"device": smi, "ms": {}, "digests": {}, "err": {}, "bound": {}, "ptxas": ptxas}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def cases(hd, batches):
        d = cs.HEADS * hd
        norms = [1.0 + 0.1 * torch.randn(hd, generator=gen, device=dev),
                 0.1 * torch.randn(hd, generator=gen, device=dev),
                 1.0 + 0.1 * torch.randn(hd, generator=gen, device=dev),
                 0.1 * torch.randn(hd, generator=gen, device=dev)]
        ang = torch.randn((cs.SEQ, hd // 2), generator=gen, device=dev)
        rope = (ang.cos().repeat_interleave(2, -1), ang.sin().repeat_interleave(2, -1))
        for b in batches:
            y = torch.randn((b, S_PAD, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
            y[:, cs.SEQ:] = 0  # the DiT pads the joint stream with zero rows
            xs = (y[..., :d], y[..., d:2 * d], y[..., 2 * d:])
            half = b * cs.HEADS * S_PAD * hd
            for quantize in (True, False):
                kw = dict(num_heads=cs.HEADS, head_dim=hd, eps=1e-6, s_valid=cs.SEQ,
                          quantize=quantize)
                name = f"K1 hd{hd} batch {b} {'int8' if quantize else 'float'}"
                got = ap.qkv_prologue(*xs, *norms, *rope, **kw)
                err = worst(cs, got, ap.qkv_prologue_plain(*xs, *norms, *rope, **kw), quantize)
                same = all(torch.equal(x, z) for x, z in
                           zip(got[:7], ap.qkv_prologue(*xs, *norms, *rope, **kw)[:7]))
                result["digests"][name] = digest(got[:7])
                ms = [cs.cuda_time_ms(lambda: ap.qkv_prologue(*xs, *norms, *rope, **kw), 20)
                      for _ in range(3)]
                gms = [graph_ms(lambda: ap.qkv_prologue(*xs, *norms, *rope, **kw))
                       for _ in range(3)]
                result["ms"][name + " graph"] = gms
                nbytes = b * (cs.SEQ * 3 * d * 2) + 2 * cs.SEQ * hd * 4 + (
                    (2 if quantize else 4) * half + 2 * half)
                bnd = cs.bound(nbytes, {"f32": b * 30.0 * 2 * cs.SEQ * d})
                result["ms"][name], result["err"][name], result["bound"][name] = ms, err, bnd
                print(f"{name}: {' '.join(f'{m:.4f}' for m in ms)} ms, graph "
                      f"{' '.join(f'{m:.4f}' for m in gms)} ms ({bnd[0] / min(gms):.1%} "
                      f"of its {bnd[0]:.4f} ms {bnd[1]} bound); "
                      f"{'codes' if quantize else 'ulps'} {err:g}; repeat bit-identical "
                      f"{'yes' if same else 'NO'}", flush=True)
                if not same:
                    raise SystemExit(f"{name}: two launches differ")
                del got
            del y, xs
            torch.cuda.empty_cache()

    plan = ap._launch_plan(cs.HEADS, S_PAD, 1024, 4)
    print(f"K1 hd64 plan: cluster {plan.cluster}, {plan.smem_bytes} B a CTA, "
          f"cudaOccupancyMaxActiveClusters {ap.prologue_occupancy(plan, True)}", flush=True)
    cases(64, (1, 2))
    for hd in OTHER_HEAD_DIMS:
        if hasattr(ap, "_CTA_ROWS"):
            plan = ap._launch_plan(cs.HEADS, S_PAD, 1024, 4, hd)
            print(f"K1 hd{hd} plan: {plan.rows} rows, cluster {plan.cluster}, "
                  f"{plan.smem_bytes} B a CTA, cudaOccupancyMaxActiveClusters "
                  f"{ap.prologue_occupancy(plan, True)}", flush=True)
        cases(hd, (1,))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f)


def ab(other: str, out_json) -> None:
    """DIR, this checkout, this checkout, DIR, each in its own process."""
    order = [("parent", os.path.abspath(other)), ("change", ROOT), ("change", ROOT),
             ("parent", os.path.abspath(other))]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, checkout) in enumerate(order):
            path = os.path.join(tmp, f"{i}.json")
            print(f"---- run {i}: {label} ({checkout})", flush=True)
            subprocess.run([sys.executable, os.path.abspath(__file__), "run", checkout,
                            "--json", path], check=True)
            with open(path) as f:
                runs.append((label, json.load(f)))
    print("---- parent, change, change, parent (ms, the least of three means each)")
    for name in runs[1][1]["ms"]:
        cells = [min(r["ms"][name]) if name in r["ms"] else float("nan") for _, r in runs]
        parent, change = min(cells[0], cells[3]), min(cells[1], cells[2])
        bnd = runs[1][1]["bound"][name.removesuffix(" graph")][0]
        print(f"{name}: " + " / ".join(f"{c:.4f}" for c in cells)
              + f"; parent / change {parent / change:.3f}x; change at {bnd / change:.1%} of "
              f"its {bnd:.4f} ms bound", flush=True)
    same = {name: all(r["digests"].get(name) == want for _, r in runs)
            for name, want in runs[1][1]["digests"].items() if "hd64" in name}
    print("head_dim-64 outputs bit-identical across the four runs: "
          + ", ".join(f"{n} {'yes' if ok else 'NO'}" for n, ok in same.items()), flush=True)
    others = {name: all(r["digests"].get(name) == want for _, r in runs)
              for name, want in runs[1][1]["digests"].items()
              if "hd64" not in name}
    print("the other head dims' outputs bit-identical across the four runs (the parent's "
          "too): " + ", ".join(f"{n} {'yes' if ok else 'no'}" for n, ok in others.items()),
          flush=True)
    if out_json:
        with open(out_json, "w") as f:
            json.dump({"order": [label for label, _ in order], "runs": [r for _, r in runs],
                       "hd64_identical": same}, f, indent=1)
    if not all(same.values()):
        raise SystemExit("a head_dim-64 output differs between the checkouts")


def main(argv) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    u = sub.add_parser("unpack")
    u.add_argument("rev")
    u.add_argument("dir")
    a = sub.add_parser("ab")
    a.add_argument("dir")
    a.add_argument("--json")
    r = sub.add_parser("run")
    r.add_argument("checkout", nargs="?", default=ROOT)
    r.add_argument("--json")
    args = p.parse_args(argv)
    if args.cmd == "unpack":
        unpack(args.rev, args.dir)
    elif args.cmd == "ab":
        ab(args.dir, args.json)
    else:
        run(os.path.abspath(args.checkout), args.json)


if __name__ == "__main__":
    main(sys.argv[1:])

"""Time the score exchange of K4's wide kernels alone on an NVIDIA GPU.

    python aether_tpu_torch/bench/dsmem_probe.py [--json OUT]

K4 above head_dim 256 (``csrc/flash_online_wide_bf16.cu``,
``csrc/flash_online_wide.cu``) splits the head dim of a 128-row q tile over a
thread-block cluster of n CTAs; for every kv tile each CTA hands its f32
part of S to the others and adds the n parts in rank order through
distributed shared memory (``csrc/hopper.cuh::ScoreExchange``: pushed with
st.async for a pair, pulled for more). This script builds ``dsmem_probe.cu``
(that exchange and nothing else, in CTAs of the kernels' 384 threads and 224
KB of shared memory, parts of 128 x 64 f32, 32 KB) with ``nvcc`` into a
temporary directory and prints, for a pair pushed (the kernels' form) and
for n in 2, 3, 4 and 8 pulled (the kernels' form above 2):

- ``loaded``: one call at the main path's grid, 118 q tiles x n x 48 heads,
  236 exchanges a CTA (15076 keys of 64-row tiles), as CUDA-event ms (the
  least of three means of 3 calls): the exchange's share of a kernel call
  if nothing overlapped it; the rate of remote bytes, (n - 1) x 32 KiB a CTA
  and exchange over that time; and the time per exchange of one CTA (the
  call's time over its waves of clusters);
- ``alone``: one cluster, 236 exchanges: the latency of one exchange.

Every exchange's sums are checked on the card (small integers, exact); the
script fails if one is wrong. Needs CUDA; imports no JAX.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from aether_tpu_torch.ops import _build  # noqa: E402

Q_TILES, HEADS, TILES, PART = 118, 48, 236, 128 * 64 * 4
CLUSTERS = (2, 3, 4, 8)


def build(tmp: str) -> ctypes.CDLL:
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dsmem_probe.cu")
    out = os.path.join(tmp, "libdsmem_probe.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                           str(_build.CSRC), src, "-o", out], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stderr}{proc.stdout}")
    print("ptxas: " + " | ".join(line.strip() for line in proc.stderr.splitlines()
                                  if "registers" in line or "spill" in line), flush=True)
    lib = ctypes.CDLL(out)
    lib.aether_dsmem_probe.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.aether_dsmem_probe.restype = ctypes.c_int
    return lib


def main(argv) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dsmem_probe.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    result = {"device": smi, "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        stream = _build.stream_ptr(dev)
        bad = torch.zeros(1, dtype=torch.int32, device=dev)
        for n, pull in [(2, False)] + [(n, True) for n in CLUSTERS]:
            how = "pulled" if pull else "pushed"
            row = {}
            for label, q_tiles, heads in (("loaded", Q_TILES, HEADS), ("alone", 1, 1)):
                out = torch.empty(q_tiles * n * heads * 256, device=dev)

                def call():
                    _build.check(lib.aether_dsmem_probe(out.data_ptr(), bad.data_ptr(), int(pull),
                                                        q_tiles, n, heads, TILES, stream),
                                 "aether_dsmem_probe")

                call()
                torch.cuda.synchronize()
                ms = []
                for _ in range(3):
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    for _ in range(3):
                        call()
                    end.record()
                    torch.cuda.synchronize()
                    ms.append(start.elapsed_time(end) / 3)
                row[label] = min(ms)
            if int(bad.item()):
                raise SystemExit(f"cluster {n}, {how}: {int(bad.item())} threads summed wrongly")
            ctas = Q_TILES * n * HEADS
            remote = ctas * TILES * (n - 1) * PART
            waves = -(-ctas // (132 // n * n))
            row.update(remote_tb_s=remote / (row["loaded"] * 1e-3) / 1e12,
                       us_per_exchange_loaded=row["loaded"] * 1e3 / (waves * TILES),
                       us_per_exchange_alone=row["alone"] * 1e3 / TILES)
            result["cases"][f"cluster {n}, {how}"] = row
            print(f"cluster {n}, {how}: loaded {row['loaded']:.4f} ms a call (118 x {n} x 48 CTAs, "
                  f"{TILES} exchanges each; remote bytes {row['remote_tb_s']:.3f} TB/s; "
                  f"{row['us_per_exchange_loaded']:.3f} us an exchange over {waves} waves), alone "
                  f"{row['alone']:.4f} ms ({row['us_per_exchange_alone']:.3f} us an exchange); "
                  "sums exact", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1:])

"""Build the port's CUDA kernels (``csrc/*.cu``) and bind them with ``ctypes``.

Every kernel source is compiled by its own ``nvcc``, all of them started
together, and the objects are linked into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c csrc/<name>.cu -o _build/<hash>/<name>.o   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libaether_<hash>.so _build/<hash>/*.o

The library lands in ``aether_tpu_torch/_build/`` (ignored by git), named by a
hash of the sources and flags, so the first call after a checkout builds it and
later calls in any process reuse it. ``--use_fast_math`` is deliberately absent:
it changes division, ``sqrtf`` and ``exp2f``, and the int8 codes of the
attention prologue depend on them.

Nothing here runs at import time: ``lib()`` builds on first use. A failed build
raises with ``nvcc``'s stderr; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # report registers / spills per kernel; changes no code
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C entry points: name -> argtypes. Every function returns cudaGetLastError().
SIGNATURES = {
    "aether_qkv_prologue": [
        _P, _P, _P,          # xq, xk, xv (bf16, [B, S_in, H*D] views)
        _I, _I,              # stride_b, stride_s (elements)
        _P, _P, _P, _P,      # gq, bq, gk, bk (f32, [D])
        _P, _P, _I,          # rope cos, sin (f32, [rope_rows, D]) or null, rope_rows
        _I, _I, _I, _I, _I,  # B, S_in, H, D (even, 2 to 126), hs (columns from a head to
                             # the next: D, or below the width D rounded up to 8)
        _I, _I, _I, _I, _I,  # s_pad, s_valid, block, hper, quantize
        _F, _F, _F, _F,      # eps, fold, fold/127, 1/127
        _P, _P, _P,          # q, k (int8, or bf16 if !quantize), v (bf16): [B*H, s_pad, W],
                             # W the width of D's instance, zero columns past D
        _P, _P, _P, _P,      # qsc, qn, ksc, kn (f32, [G, T])
        _I, _I, _I,          # the launch plan: rows and cluster, shared memory bytes a CTA
        _P,                  # stream
    ],
    "aether_qkv_prologue_occupancy": [
        _I, _I, _I, _I, _I,  # D (the head dim), rows, cluster, shared memory bytes, quantize
        _P,                  # out: clusters the card holds at once (int)
    ],
    "aether_flash_prepacked": [
        _P, _P, _P,          # q, k (int8, or folded bf16), v (bf16): [B*H, s_pad, cols]
                             # with rows ld elements apart
        _P, _P, _P, _P,      # qsc, ksc, qn, kn (f32, [G, T])
        _P,                  # out (bf16, [B*H, s_pad, D])
        _I, _I, _I,          # BH, s_pad, s_valid
        _I, _I, _I, _I,      # hper, block (a multiple of 128), n_blocks, qk_int8
        _I,                  # noshift (0 keep, 1 drop, 2 drop when every bound < 96)
        _I, _I, _I,          # D (16 to 128 in steps of 16), cols (<= D), ld (>= D)
        _P,                  # stream
    ],
    "aether_flash_online": [
        _P, _P, _P, _P,      # q_hi, q_lo (folded), k_hi, k_lo: f32 [B*H, sq | skv, D]
        _P, _P,              # vt_hi, vt_lo: f32 [B*H, D, skv rounded up to 8], kv-permuted
        _P,                  # out: f32 [B*H, sq, D]
        _I, _I, _I, _I,      # BH, sq, skv (any lengths), kv_len
        _I,                  # D (16 to 128 in steps of 16)
        _P,                  # stream
    ],
    "aether_flash_online_bf16": [
        _P, _P, _P, _P,      # q (unfolded), k, v, out: bf16 [B*H, sq | skv, D]
        _I, _I, _I, _I,      # BH, sq, skv (any lengths), kv_len
        _I, _F,              # round_l (denom "mxu"), q fold sm_scale * log2e
        _I,                  # D (16 to 128 in steps of 16, 160 to 256 in steps of 32)
        _P,                  # stream
    ],
    "aether_flash_online_wide": [
        _P, _P, _P, _P,      # q_hi, q_lo (folded), k_hi, k_lo: f32 [B*H, sq | skv, dp]
        _P, _P,              # vt_hi, vt_lo: f32 [B*H, dp, skv rounded up to 8], kv-permuted
        _P,                  # out: f32 [B*H, sq, dp]
        _I, _I, _I, _I,      # BH, sq, skv (any lengths), kv_len
        _I,                  # dp (160 to 256 in steps of 32, then multiples of 64; zero-padded)
        _I, _I,              # the plan (flash_attention._wide_plan): cluster, groups
        _P,                  # stream
    ],
    "aether_flash_online_wide_bf16": [
        _P, _P, _P, _P,      # q (unfolded), k, v, out: bf16 [B*H, sq | skv, dp]
        _I, _I, _I, _I,      # BH, sq, skv (any lengths), kv_len
        _F,                  # q fold sm_scale * log2e (the "vpu" denominator)
        _I,                  # dp (a multiple of 64: head dims above 256, zero-padded)
        _I, _I,              # the plan (flash_attention._wide_plan): cluster, groups
        _P,                  # stream
    ],
    "aether_flash_fixed_max": [
        _P, _P, _P,          # q, k (int8 or folded bf16), v (bf16): [B*H, sq | skv, D]
        _P, _P,              # shift, scale (f32, [G])
        _P, _P,              # out (bf16, [B*H, sq, D]), l (f32, [B*H, sq]) or null
        _I, _I, _I, _I, _I,  # BH, sq, skv (any lengths), kv_len, hper
        _I, _I,              # qk_int8, D (16 to 128 in steps of 16)
        _P,                  # stream
    ],
    "aether_flash_fixed_max_f32": [
        _P, _P, _P, _P,      # q_hi, q_lo, k_hi, k_lo: f32 [B*H, sq | skv, D], folded, split
                             # (qk_int8: the int8 codes in q_hi and k_hi)
        _P, _P,              # vt_hi, vt_lo: f32 [B*H, D, skv rounded up to 8], kv-permuted
        _P, _P,              # shift, scale (f32, [G])
        _P, _P,              # out (f32, [B*H, sq, D]), l (f32, [B*H, sq]) or null
        _I, _I, _I, _I, _I,  # BH, sq, skv (any lengths), kv_len, hper
        _I, _I,              # qk_int8, D (16 to 128 in steps of 16)
        _P,                  # stream
    ],
    "aether_flash_pv8": [
        _P, _P, _P,          # q8, k8 [B*H, sq | skv, D], v8 transposed [B*H, D, skv]
        _P, _P,              # scale, vscale (f32, [G])
        _P,                  # out (f32 or bf16, [B*H, sq, D])
        _I, _I, _I, _I, _I,  # BH, sq, skv, kv_len, hper
        _I, _I,              # span (kv columns per running-max update), dtype
        _I,                  # D (16 to 128 in steps of 16)
        _P,                  # stream
    ],
    "aether_flash_variants": [
        _P, _P, _P, _P,      # q (unscaled), k (rows, or K^T [B*H, 64, k_row]), v, out (bf16)
        _I, _I, _I, _I, _I,  # BH, sq, skv (any lengths), kv_end, pad (padfix)
        _I, _I, _I, _I,      # hper (0: one head a CTA), use_exp2, mask (0 all, 1 tail,
                             # 2 padfix), k_row (0: K as rows)
        _F,                  # qscale, folded into q in the kernel
        _P,                  # stream
    ],
    "aether_groupnorm_moments": [
        _P, _P,              # x ([B, C, n] or [B, n, C]), c0 (f32, [B, C])
        _P, _P, _P, _P,      # p1, p2 (f32, [B, splits, C]), m1, m2 (f32, [B, C])
        _I, _I, _L,          # B, C, n = T*H*W
        _I, _I, _L,          # channels_last, splits, chunk
        _I, _I, _I,          # vec, g_tile, dtype (0 f32, 1 bf16, 2 f16)
        _P,                  # stream
    ],
}

_LIB: Optional[ctypes.CDLL] = None
# what the last build printed (ptxas register/spill report), for smoke runs
BUILD_LOG = {"path": None, "ptxas": ""}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest(cu, cuh) -> str:
    h = hashlib.sha256()
    for path in list(cu) + list(cuh):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands concurrently; raise with nvcc's output if one fails.
    Returns their stderr (ptxas's report), in order."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    for cmd, proc, (stdout, stderr) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc {proc.returncode}):\n{' '.join(cmd)}\n"
                f"{stderr}{stdout}")
    return "".join(stderr for _, stderr in outs)


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` into ``_build/libaether_<hash>.so`` unless it exists."""
    cu, cuh = _sources()
    digest = _digest(cu, cuh)
    out = BUILD_DIR / f"libaether_{digest}.so"
    if out.exists():
        BUILD_LOG.update(path=str(out))
        return out
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"{digest}.{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    objs = [obj_dir / f"{p.stem}.o" for p in cu]
    ptxas = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
                      for src, obj in zip(cu, objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    shutil.rmtree(obj_dir, ignore_errors=True)
    BUILD_LOG.update(path=str(out), ptxas=ptxas)
    return out


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with every argtype declared."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of its kernel's launches.
    The counts are process-wide (one launching thread, such as a server's
    worker, and another reading them see the same numbers); the lock keeps
    launches from several threads from losing an increment."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream

"""Native host runtime: threaded .npz prefetch loader (C++ + ctypes).

Port of ``aether_tpu/runtime/__init__.py`` over the port's own copy of the
C++ source. ``npz_prefetch.cpp`` is built at first use, never at import:

    g++ -O2 -std=c++17 -shared -fPIC runtime/npz_prefetch.cpp \\
        -o _build/libnpz_prefetch_<hash>.so -lz -pthread

The library lands in ``aether_tpu_torch/_build/`` (ignored by git), named by
a hash of the source and the command, as ``ops/_build.py`` names the kernel
library; it is written to a private temporary file and renamed into place,
so processes that build at once never load half a library. Exposes:

- :func:`available` — whether the native loader could be built and loaded.
- :func:`build_error` — why not, when it could not.
- :func:`load_npz` — one-shot native .npz read (a drop-in for ``np.load`` on
  the latent files written by :mod:`aether_tpu_torch.train.data`).
- :class:`NpzPrefetcher` — submit paths, get dicts of arrays back in submit
  order while worker threads read and inflate the next files. The zip walk,
  zlib inflate and npy header parse all run outside the GIL, so decoding
  overlaps both Python work and device steps.

There is no quiet fallback: :func:`load_npz` and :class:`NpzPrefetcher`
raise with the build's reason, and so does the training loader
(``latent_batches(native_prefetch=True)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

from aether_tpu_torch.ops._build import BUILD_DIR  # beside the kernel library

_SRC = pathlib.Path(__file__).resolve().parent / "npz_prefetch.cpp"
CXX = "g++"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
LINK_FLAGS = ["-lz", "-pthread"]

_MAX_ARRAYS = 32
_MAX_DIMS = 8


class _NpzArray(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char * 64),
        ("dtype", ctypes.c_char * 16),
        ("ndim", ctypes.c_int64),
        ("shape", ctypes.c_int64 * _MAX_DIMS),
        ("data", ctypes.c_void_p),
        ("nbytes", ctypes.c_int64),
    ]


class _NpzBatch(ctypes.Structure):
    _fields_ = [
        ("n_arrays", ctypes.c_int64),
        ("arrays", _NpzArray * _MAX_ARRAYS),
        ("status", ctypes.c_int64),
        ("error", ctypes.c_char * 256),
        ("path", ctypes.c_char * 1024),
    ]


_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def library_path() -> pathlib.Path:
    """Where the built library goes: ``_build/libnpz_prefetch_<hash>.so``,
    the hash over the source and the build command."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join([CXX, *CXX_FLAGS, *LINK_FLAGS]).encode())
    return BUILD_DIR / f"libnpz_prefetch_{h.hexdigest()[:16]}.so"


def _build(so: pathlib.Path) -> None:
    """Compile to a private temporary path, then rename it into place:
    concurrent first users must never load a partly written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(_SRC), "-o", str(tmp), *LINK_FLAGS],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({proc.returncode}): {proc.stderr.strip()}")
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load_lib():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.npzp_create.restype = ctypes.c_void_p
            lib.npzp_create.argtypes = [ctypes.c_int]
            lib.npzp_destroy.restype = None
            lib.npzp_destroy.argtypes = [ctypes.c_void_p]
            lib.npzp_submit.restype = ctypes.c_long
            lib.npzp_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.npzp_wait.restype = ctypes.POINTER(_NpzBatch)
            lib.npzp_wait.argtypes = [ctypes.c_void_p]
            lib.npzp_release.restype = None
            lib.npzp_release.argtypes = [ctypes.POINTER(_NpzBatch)]
            lib.npzp_load.restype = ctypes.POINTER(_NpzBatch)
            lib.npzp_load.argtypes = [ctypes.c_char_p]
            _lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            # no compiler, no zlib headers, a bad source: kept for the callers
            _build_error = f"{type(exc).__name__}: {exc}"
            _lib = None
        return _lib


def available() -> bool:
    """True when the native loader is built and loadable on this machine."""
    return _load_lib() is not None


def build_error() -> Optional[str]:
    """Why the native loader could not be built or loaded; None when it was."""
    _load_lib()
    return _build_error


def _require_lib():
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"native npz loader unavailable: {_build_error}")
    return lib


def _batch_to_dict(lib, batch_ptr) -> Dict[str, np.ndarray]:
    batch = batch_ptr.contents
    try:
        if batch.status != 0:
            raise IOError(
                f"native npz load failed for {batch.path.decode()}: "
                f"{batch.error.decode()}"
            )
        out: Dict[str, np.ndarray] = {}
        for i in range(batch.n_arrays):
            arr = batch.arrays[i]
            dtype = np.dtype(arr.dtype.decode())
            shape = tuple(arr.shape[j] for j in range(arr.ndim))
            if arr.nbytes:
                view = np.ctypeslib.as_array(
                    ctypes.cast(arr.data, ctypes.POINTER(ctypes.c_uint8)),
                    shape=(arr.nbytes,),
                )
                out[arr.name.decode()] = (
                    view.view(dtype)[: arr.nbytes // dtype.itemsize]
                    .reshape(shape).copy()  # one copy; C buffer freed on release
                )
            else:
                out[arr.name.decode()] = np.zeros(shape, dtype)
        return out
    finally:
        lib.npzp_release(batch_ptr)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Synchronous native .npz read; raises if the native library is
    unavailable (with the build's reason) or the file cannot be read
    (``IOError``)."""
    lib = _require_lib()
    return _batch_to_dict(lib, lib.npzp_load(os.fsencode(path)))


class NpzPrefetcher:
    """Threaded in-order .npz prefetcher.

    >>> pf = NpzPrefetcher(n_threads=2)
    >>> for p in paths: pf.submit(p)
    >>> batch = pf.get()   # dict of arrays, in submit order
    >>> pf.close()         # joins the worker threads
    """

    def __init__(self, n_threads: int = 2):
        self._lib = _require_lib()
        self._ctx = self._lib.npzp_create(int(n_threads))
        self._in_flight = 0

    def submit(self, path: str) -> None:
        self._lib.npzp_submit(self._ctx, os.fsencode(path))
        self._in_flight += 1

    @property
    def in_flight(self) -> int:
        return self._in_flight

    def get(self) -> Dict[str, np.ndarray]:
        if self._in_flight <= 0:
            raise RuntimeError("NpzPrefetcher.get() with nothing submitted")
        ptr = self._lib.npzp_wait(self._ctx)
        if not ptr:
            raise RuntimeError("prefetcher returned no batch")
        self._in_flight -= 1
        return _batch_to_dict(self._lib, ptr)

    def close(self) -> None:
        if getattr(self, "_ctx", None):
            self._lib.npzp_destroy(self._ctx)
            self._ctx = None

    def __del__(self):
        self.close()

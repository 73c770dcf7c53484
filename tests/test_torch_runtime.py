"""The port's native .npz loader (``aether_tpu_torch.runtime``) against
``np.load``: the cases of ``tests/test_runtime.py`` through the port's own
build, where the library lands, and the error a failed build raises."""

import os
import threading

import numpy as np
import pytest

from aether_tpu_torch import runtime
from aether_tpu_torch.config import DiTConfig
from aether_tpu_torch.train.data import latent_batches

DTYPES = (np.float16, np.float32, np.float64, np.int8, np.int16, np.int32, np.int64,
          np.uint8, np.uint16, np.uint32, np.uint64, np.bool_, np.complex64,
          np.complex128)


def _arrays(rng):
    ref = {
        "clean_latents": rng.normal(size=(3, 56, 8, 12)).astype(np.float16),
        "num_frames": np.asarray(17),
        "height": np.asarray(64),
        "fps": np.asarray(12),
        "text_embeds": np.zeros((0,), np.float16),
    }
    for dt in DTYPES:
        ref[f"a_{np.dtype(dt).name}"] = (rng.normal(size=(5, 3)) * 50).astype(dt)
    return ref


@pytest.mark.parametrize("save", [np.savez_compressed, np.savez], ids=["deflate", "stored"])
def test_load_npz_matches_numpy(tmp_path, save):
    """Compressed (zip method 8) and stored (method 0) containers, every
    numeric dtype, scalars and empty arrays: equal to np.load bit for bit."""
    ref = _arrays(np.random.default_rng(0))
    path = tmp_path / "clip.npz"
    save(path, **ref)
    got = runtime.load_npz(str(path))
    with np.load(path) as want:
        assert set(got) == set(want.files) == set(ref)
        for key in ref:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].shape == want[key].shape, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("n_threads,n_files", [(3, 8), (16, 64)])
def test_prefetcher_delivers_in_submit_order(tmp_path, n_threads, n_files):
    """In-order delivery whatever order the threads finish in (files of
    different sizes); the larger case runs more threads than this host's
    cores, under a time limit."""
    rng = np.random.default_rng(1)
    paths = []
    for i in range(n_files):
        p = tmp_path / f"c{i}.npz"
        size = int(rng.integers(1, 200))
        np.savez_compressed(p, x=np.full((size, 64), i, np.float32))
        paths.append(str(p))
    result = {}

    def run():
        pf = runtime.NpzPrefetcher(n_threads=n_threads)
        try:
            for p in paths:
                pf.submit(p)
            result["seen"] = [int(pf.get()["x"][0, 0]) for _ in paths]
            result["left"] = pf.in_flight
        finally:
            pf.close()

    worker = threading.Thread(target=run)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive(), "the prefetcher did not deliver within 60 s"
    assert result["seen"] == list(range(n_files))
    assert result["left"] == 0


def test_load_errors_surface(tmp_path):
    bad = tmp_path / "not_a_zip.npz"
    bad.write_bytes(b"garbage")
    with pytest.raises(IOError, match="EOCD"):
        runtime.load_npz(str(bad))
    with pytest.raises(IOError, match="cannot open"):
        runtime.load_npz(str(tmp_path / "missing.npz"))
    pf = runtime.NpzPrefetcher(n_threads=2)
    try:
        pf.submit(str(bad))
        with pytest.raises(IOError):
            pf.get()
        with pytest.raises(RuntimeError, match="nothing submitted"):
            pf.get()
    finally:
        pf.close()


def test_library_lands_in_the_build_directory():
    """The .so is built into the port's git-ignored ``_build/`` under a name
    hashed from the source and the command, never beside the source."""
    assert runtime.available(), runtime.build_error()
    assert runtime.build_error() is None
    so = runtime.library_path()
    assert so.parent == runtime.BUILD_DIR
    assert runtime.BUILD_DIR.name == "_build" and runtime.BUILD_DIR.parent.name == "aether_tpu_torch"
    assert so.name.startswith("libnpz_prefetch_") and so.suffix == ".so"
    assert so.is_file()
    assert not list(runtime.BUILD_DIR.glob(f"{so.name}.{os.getpid()}.*.tmp"))
    assert not list(runtime._SRC.parent.glob("*.so"))


@pytest.mark.parametrize("broken", ["compiler", "source"])
def test_failed_build_raises_with_its_reason(tmp_path, monkeypatch, broken):
    """With no compiler, or a source that does not compile, the loader
    reports why, and ``latent_batches(native_prefetch=True)`` raises with
    that reason instead of reading with np.load."""
    if broken == "compiler":
        monkeypatch.setattr(runtime, "CXX", "aether-no-such-compiler")
        reason = "aether-no-such-compiler"
    else:
        src = tmp_path / "npz_prefetch.cpp"
        src.write_text(runtime._SRC.read_text() + "\nthis is not C++;\n")
        monkeypatch.setattr(runtime, "_SRC", src)
        reason = "failed"
    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_build_error", None)
    assert not runtime.available()
    assert reason in runtime.build_error()
    with pytest.raises(RuntimeError, match="native npz loader unavailable"):
        runtime.load_npz(str(tmp_path / "x.npz"))
    np.savez_compressed(
        tmp_path / "clip.npz", clean_latents=np.zeros((2, 56, 4, 6), np.float16),
        num_frames=np.asarray(5), height=np.asarray(32), width=np.asarray(48),
        fps=np.asarray(12), text_embeds=np.zeros((0,), np.float16))
    with pytest.raises(RuntimeError, match="failed to build") as err:
        next(latent_batches(str(tmp_path), DiTConfig.tiny()))
    assert runtime.build_error() in str(err.value)
    assert "no_native_prefetch" in str(err.value)
    # the np.load route is still there when asked for
    batch = next(latent_batches(str(tmp_path), DiTConfig.tiny(), native_prefetch=False))
    assert batch["clean_latents"].shape == (1, 2, 56, 4, 6)
    assert not list(runtime.BUILD_DIR.glob(f"*.{os.getpid()}.*.tmp"))

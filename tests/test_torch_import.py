"""The PyTorch port imports without JAX and builds nothing at import time."""

import pathlib
import subprocess
import sys

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_PKG = _ROOT / "aether_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["jaxlib"] = None
import aether_tpu_torch
names = [m.name for m in pkgutil.walk_packages(aether_tpu_torch.__path__,
                                               "aether_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("aether_tpu_torch.train.step", "aether_tpu_torch.train.trainer",
             "aether_tpu_torch.train.data", "aether_tpu_torch.eval.sharding",
             "aether_tpu_torch.ops.chunked_attention", "aether_tpu_torch.ops.groupnorm",
             "aether_tpu_torch.geometry.raymap", "aether_tpu_torch.geometry.rays",
             "aether_tpu_torch.geometry.transforms", "aether_tpu_torch.geometry.edges",
             "aether_tpu_torch.geometry.alignment", "aether_tpu_torch.geometry.smoothing",
             "aether_tpu_torch.pipeline.windowing", "aether_tpu_torch.viz.glb",
             "aether_tpu_torch.viz.ply", "aether_tpu_torch.viz.video",
             "aether_tpu_torch.viz.colorize", "aether_tpu_torch.apps.demo",
             "aether_tpu_torch.ops.flash_variants", "aether_tpu_torch.bench._harness",
             "aether_tpu_torch.bench.flash_variants",
             "aether_tpu_torch.bench.flash_multihead",
             "aether_tpu_torch.bench.flash_bisect", "aether_tpu_torch.io.safetensors",
             "aether_tpu_torch.io.weights", "aether_tpu_torch.io.convert",
             "aether_tpu_torch.utils.profiling", "aether_tpu_torch.apps.actions",
             "aether_tpu_torch.apps.serve", "aether_tpu_torch.eval.pose_metrics",
             "aether_tpu_torch.eval.datasets", "aether_tpu_torch.eval.depth_metrics",
             "aether_tpu_torch.eval.video_depth", "aether_tpu_torch.eval.rel_pose",
             "aether_tpu_torch.runtime", "aether_tpu_torch.parallel",
             "aether_tpu_torch.parallel.distributed", "aether_tpu_torch.parallel.mesh",
             "aether_tpu_torch.parallel.launch", "aether_tpu_torch.parallel.pipeline",
             "aether_tpu_torch.parallel.jobs"):
    assert name in names, name
import torch.distributed as dist
assert not dist.is_initialized(), "a process group was joined at import time"
from aether_tpu_torch.parallel import initialize, make_mesh, shard_params
from aether_tpu_torch.parallel.pipeline import (
    make_pipeline_block_scan, make_pp_mesh, shard_blocks_pp)
from aether_tpu_torch.parallel.mesh import ParamLayout, fsdp_shard
from aether_tpu_torch.parallel.jobs import JobChannel
from aether_tpu_torch.parallel.launch import Ranks, start
from aether_tpu_torch.pipeline import DeferredOutput, iter_resolved
from aether_tpu_torch.apps.serve import follow, job_calls, serve, validate_job
assert not dist.is_initialized(), "a process group was joined at import time"
from aether_tpu_torch import runtime
assert runtime._lib is None and runtime._build_error is None, "the npz loader was built at import"
from aether_tpu_torch.train.data import LatentNoise, latent_batches, precompute_latents
from aether_tpu_torch.ops.groupnorm import groupnorm_moments
assert groupnorm_moments.launches == 0
from aether_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_fixed_max, flash_attention_pv8)
assert flash_attention.launches == 0
assert flash_attention_fixed_max.launches == flash_attention_pv8.launches == 0
from aether_tpu_torch.ops.flash_variants import flash_mh, flash_v2, flash_x
assert flash_v2.launches == flash_mh.launches == flash_x.launches == 0
from aether_tpu_torch.models.dit import int8_mm
assert int8_mm.launches == 0
from aether_tpu_torch.ops import _build
assert _build._LIB is None, "a kernel library was loaded at import time"
import threading
assert threading.active_count() == 1, "a module started a thread at import time"
for lazy in ("PIL", "imageio", "cv2", "matplotlib"):
    assert lazy not in sys.modules, f"{lazy} was imported at import time"
assert not any(m.startswith("aether_tpu.") or m == "aether_tpu"
               for m in sys.modules), "the JAX package was imported"
print(len(names))
"""


def test_package_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 53


def test_no_source_file_imports_jax():
    offenders = []
    for path in _PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:2] in (["import", "jax"], ["from", "jax"]) or (
                    len(words) >= 2 and words[0] in ("import", "from")
                    and (words[1].startswith("jax.")
                         or words[1].startswith("aether_tpu.")
                         or words[1] == "aether_tpu")):
                offenders.append(f"{path.relative_to(_ROOT)}: {line.strip()}")
    assert not offenders, offenders


def test_native_loader_is_the_ports_own_copy():
    """The npz loader builds from the port's own C++ source, which names
    nothing of the JAX package."""
    from aether_tpu_torch import runtime

    assert runtime._SRC == _PKG / "runtime" / "npz_prefetch.cpp"
    assert runtime.BUILD_DIR == _PKG / "_build"
    src = runtime._SRC.read_text()
    assert "aether_tpu/" not in src and "aether_tpu_torch/runtime/__init__.py" in src


def test_kernel_sources_ship_with_the_package():
    names = sorted(p.name for p in (_PKG / "csrc").glob("*.cu"))
    assert names == ["attn_prologue.cu", "flash_fixed_max.cu",
                     "flash_fixed_max_hd.cu", "flash_online.cu", "flash_online_bf16.cu",
                     "flash_online_wide.cu", "flash_online_wide_bf16.cu",
                     "flash_prepacked.cu", "flash_pv8.cu", "flash_variants.cu",
                     "groupnorm_moments.cu"]
    assert sorted(p.name for p in (_PKG / "csrc").glob("*.cuh")) == [
        "fixed_cell.cuh", "hopper.cuh", "online_cell.cuh", "tf32x3_cell.cuh"]
    from aether_tpu_torch.ops import _build

    assert set(_build.SIGNATURES) == {"aether_qkv_prologue", "aether_qkv_prologue_occupancy",
                                      "aether_flash_prepacked",
                                      "aether_flash_online", "aether_flash_online_bf16",
                                      "aether_flash_online_wide",
                                      "aether_flash_online_wide_bf16",
                                      "aether_flash_fixed_max", "aether_flash_fixed_max_f32",
                                      "aether_flash_pv8",
                                      "aether_flash_variants", "aether_groupnorm_moments"}
    for name in _build.SIGNATURES:
        src = "".join(p.read_text() for p in (_PKG / "csrc").glob("*.cu"))
        assert f'extern "C" int {name}(' in src
    assert "--use_fast_math" not in _build.NVCC_FLAGS

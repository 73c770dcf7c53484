"""K7, K8 and K9 against the benchmark scripts' Pallas kernels (CPU).

``aether_tpu_torch.ops.flash_variants.flash_v2_plain`` / ``flash_mh_plain`` /
``flash_x_plain`` and their wrappers on CPU tensors are held against
``scripts/bench_flash_variants.py::flash_v2``,
``bench_flash_multihead.py::flash_mh`` and ``bench_flash_bisect.py::flash_x``
run unmodified under ``force_tpu_interpret_mode()``, on the same numpy-seeded
bf16 inputs at (1, 4, 300, 64) with blocks of 128 to 256, so both sides walk
the same kv blocks with the same running max.

``scripts/`` is not a package, so the scripts load from their files; loading
them sets JAX's compilation-cache directory and minimum compile time and puts
the repository on ``sys.path``, which the loader restores.

Tolerance: one bf16 ulp of the output scale, 2**(floor(log2 max|ref|) - 7),
as in ``test_torch_flash_online.py``: p is rounded to bf16 at the same running
max on both sides, so only order-of-sum noise and the final rounding separate
them. The CUDA kernel is held against the same plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).

The kernel's side that the CPU reaches: the launch arguments of every
configuration of the three sweeps at the full bench shape, against the
padding, q scale, exponent and grid that the scripts' own wrappers trace to
(``jax.make_jaxpr``, no kernel run); and the kernel's tiling (128-column kv
tiles with a running max) through ``_online_loop`` at 128-column blocks,
against the Pallas kernels at 1024-column blocks, within the card's
``bf16_gates`` bounds.
"""

import functools
import importlib.util
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from aether_tpu_torch.bench import _harness
from aether_tpu_torch.bench import flash_bisect, flash_multihead, flash_variants
from aether_tpu_torch.ops.flash_attention import flash_attention
from aether_tpu_torch.ops.flash_variants import (
    _MASK_ALL,
    _MASK_LAST,
    _MASK_NONE,
    _finish,
    _mh_args,
    _mh_config,
    _online_loop,
    _scaled_padded,
    _v2_args,
    _v2_config,
    _v2_seq_pad,
    _x_args,
    _x_config,
    flash_mh,
    flash_mh_plain,
    flash_v2,
    flash_v2_plain,
    flash_x,
    flash_x_plain,
)

torch.set_num_threads(1)

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_SCRIPT_CONFIG = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
SHAPE = (1, 4, 300, 64)


def _load_scripts():
    """The three bench scripts as modules, with JAX's config and sys.path as
    they were before."""
    saved = {name: getattr(jax.config, name) for name in _SCRIPT_CONFIG}
    path = list(sys.path)
    mods = {}
    try:
        for name in ("bench_flash_variants", "bench_flash_multihead", "bench_flash_bisect"):
            spec = importlib.util.spec_from_file_location(
                f"_bench_script_{name}", _ROOT / "scripts" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods[name] = mod
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
        sys.path[:] = path
    return mods


@pytest.fixture(scope="module")
def scripts():
    return _load_scripts()


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _interpret(fn, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args, **kw).astype(jnp.float32))


def _assert_close(out, ref):
    out = out.float().numpy()
    assert out.shape == ref.shape
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    np.testing.assert_allclose(out, ref, atol=ulp, rtol=0)


def test_loading_the_scripts_restores_jax_config():
    before = {name: getattr(jax.config, name) for name in _SCRIPT_CONFIG}
    path = list(sys.path)
    mods = _load_scripts()
    assert {name: getattr(jax.config, name) for name in _SCRIPT_CONFIG} == before
    assert sys.path == path
    assert all(hasattr(mods[n], f) for n, f in (("bench_flash_variants", "flash_v2"),
                                                ("bench_flash_multihead", "flash_mh"),
                                                ("bench_flash_bisect", "flash_x")))


# (block_q, block_k, kt, mask_last_only)
V2_CASES = [
    (128, 128, False, True),    # pad 84 in the last block, masked there only
    (128, 128, True, True),     # K pre-transposed
    (128, 128, False, False),   # every block masked
    (128, 128, True, False),
    (128, 256, False, True),    # seq_pad rounds to block_k: 512, pad 212 < 256
    (256, 128, False, False),   # pad 212 spans two kv blocks, every block masked
]


@pytest.mark.parametrize("block_q,block_k,kt,mask_last_only", V2_CASES)
def test_flash_v2_matches_pallas(scripts, block_q, block_k, kt, mask_last_only):
    (jq, jk, jv), (tq, tk, tv) = _inputs(seed=block_q + block_k + kt)
    kw = dict(block_q=block_q, block_k=block_k, kt=kt, mask_last_only=mask_last_only)
    ref = _interpret(scripts["bench_flash_variants"].flash_v2, jq, jk, jv, **kw)
    out = flash_v2_plain(tq, tk, tv, **kw)
    assert out.dtype == torch.bfloat16
    _assert_close(out, ref)
    assert torch.equal(flash_v2(tq, tk, tv, **kw), out)  # the CPU wrapper is the plain version


def test_flash_v2_mask_last_only_assertion_on_both_sides(scripts):
    """seq 300 at 256 x 128 pads to 512: a pad of 212 >= block_k 128, which
    mask_last_only refuses on both sides; with pad < block_k both run."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(seed=3)
    assert _v2_seq_pad(300, 256, 128) - 300 == 212
    with pytest.raises(AssertionError):
        _interpret(scripts["bench_flash_variants"].flash_v2, jq, jk, jv,
                   block_q=256, block_k=128)
    for fn in (flash_v2, flash_v2_plain):
        with pytest.raises(ValueError, match="mask_last_only"):
            fn(tq, tk, tv, block_q=256, block_k=128)
    # 256 x 256: the same pad of 212 now fits the last block
    ref = _interpret(scripts["bench_flash_variants"].flash_v2, jq, jk, jv,
                     block_q=256, block_k=256)
    _assert_close(flash_v2(tq, tk, tv, block_q=256, block_k=256), ref)


# (hper, block_q, block_k)
MH_CASES = [
    (1, 128, 128),
    (2, 256, 128),
    (4, 128, 192),   # lcm 384: seq_pad 384
    (2, 128, 256),   # lcm 256: seq_pad 512, pad 212 across the last block
]


@pytest.mark.parametrize("hper,block_q,block_k", MH_CASES)
def test_flash_mh_matches_pallas(scripts, hper, block_q, block_k):
    (jq, jk, jv), (tq, tk, tv) = _inputs(seed=10 * hper + block_k)
    kw = dict(block_q=block_q, block_k=block_k, hper=hper)
    assert -(-300 // math.lcm(block_q, block_k)) * math.lcm(block_q, block_k) > 300
    ref = _interpret(scripts["bench_flash_multihead"].flash_mh, jq, jk, jv, **kw)
    out = flash_mh_plain(tq, tk, tv, **kw)
    _assert_close(out, ref)
    assert torch.equal(flash_mh(tq, tk, tv, **kw), out)


def test_flash_mh_refuses_hper_not_dividing_heads():
    """The JAX grid (bh // hper) would leave the last heads unwritten; the
    port raises instead."""
    _, (tq, tk, tv) = _inputs(seed=4)
    for fn in (flash_mh, flash_mh_plain):
        with pytest.raises(ValueError, match="divisible by hper"):
            fn(tq, tk, tv, block_q=128, block_k=128, hper=3)


@pytest.mark.parametrize("mode", ["fold", "fold2", "padfix", "padfix_exp"])
@pytest.mark.parametrize("blocks", [(128, 128), (256, 128)])
def test_flash_x_matches_pallas(scripts, mode, blocks):
    """(256, 128) pads 300 to 512: the padding spans two kv blocks, which
    padfix corrects once at the end."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(seed=sum(blocks) + len(mode))
    kw = dict(block_q=blocks[0], block_k=blocks[1], mode=mode)
    ref = _interpret(scripts["bench_flash_bisect"].flash_x, jq, jk, jv, **kw)
    out = flash_x_plain(tq, tk, tv, **kw)
    _assert_close(out, ref)
    assert torch.equal(flash_x(tq, tk, tv, **kw), out)


@pytest.mark.parametrize("mode", ["fold", "fold2", "padfix", "padfix_exp"])
def test_flash_x_deeply_negative_scores(scripts, mode):
    """Every real score far below 0 (-200 in the exp domain). The masking
    modes give the mean of v. padfix masks nothing: the pad keys score 0, so
    m ends at 0, the real p underflow to 0, the correction cancels l to 0
    and the guard leaves the output at 0, as in JAX."""
    b, h, s, d = 1, 2, 300, 64
    q = np.full((b, h, s, d), 5.0, np.float32)
    k = np.full((b, h, s, d), -5.0, np.float32)
    v = np.random.default_rng(5).standard_normal((b, h, s, d)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    kw = dict(block_q=256, block_k=128, mode=mode)
    ref = _interpret(scripts["bench_flash_bisect"].flash_x, jq, jk, jv, **kw)
    out = flash_x_plain(tq, tk, tv, **kw)
    if mode.startswith("padfix"):
        assert not out.any() and not np.any(ref)
    else:
        _assert_close(out, ref)
        mean_v = tv.float().mean(dim=2, keepdim=True).expand(b, h, s, d)
        assert (out.float() - mean_v).abs().max().item() <= 1e-2


def test_flash_x_refuses_unknown_mode():
    _, (tq, tk, tv) = _inputs(seed=6)
    with pytest.raises(ValueError, match="mode"):
        flash_x(tq, tk, tv, mode="padfix2")


# ---- the bench entry points on the CPU ----

def _parse(lines):
    parsed = [_harness.LINE.match(line) for line in lines]
    assert all(parsed), [ln for ln, m in zip(lines, parsed) if not m]
    return parsed


@pytest.mark.parametrize("module,expected", [
    (flash_variants, 1 + len(flash_variants.SWEEP) + 1),
    (flash_multihead, 1 + sum(_harness.CPU_HEADS % hp == 0 for hp, _, _ in flash_multihead.SWEEP)),
    (flash_bisect, 1 + 4 + len(flash_bisect.BLOCKS)),
])
def test_bench_entry_points_run_on_cpu(module, expected):
    lines = module.main(["--device", "cpu", "--iters", "1"])
    parsed = _parse(lines)
    assert len(lines) == expected
    failed = {m["name"] for m in parsed if m["exc"]}
    if module is flash_variants:
        # exactly where the JAX wrapper's assertion refuses: pad >= block_k
        want = {f"v2 {bq}x{bk} kt={int(kt)}" for bq, bk, kt in flash_variants.SWEEP
                if _v2_seq_pad(_harness.CPU_SEQ, bq, bk) - _harness.CPU_SEQ >= bk}
        assert failed == want and "v2 2048x1024 kt=0" in want
        assert all(m["exc"] == "ValueError" for m in parsed if m["exc"])
    else:
        assert not failed
    # every variant computes the baseline's attention: within four bf16 ulps
    # of the scale of the part of the baseline that maxdiff reads
    q, k, v = _harness.make_qkv(torch.device("cpu"))
    top = module.compared(flash_attention(q, k, v, block_q=1024, block_k=1024)).float()
    bar = 4 * 2.0 ** (np.floor(np.log2(top.abs().max().item())) - 7)
    assert all(float(m["err"]) <= bar for m in parsed if m["err"] is not None)


def test_bench_inputs_follow_the_device_and_a_fixed_seed():
    q, k, v = _harness.make_qkv(torch.device("cpu"))
    assert q.shape == k.shape == v.shape == (1, _harness.CPU_HEADS, _harness.CPU_SEQ,
                                             _harness.HEAD_DIM)
    assert q.dtype == torch.bfloat16 and not torch.equal(q, k)
    assert all(torch.equal(a, b) for a, b in zip((q, k, v), _harness.make_qkv("cpu")))


def test_bench_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        flash_bisect.main([])


# ---- the kernel's launch arguments against the scripts' own arithmetic ----

FULL = (1, _harness.FULL_HEADS, _harness.FULL_SEQ, _harness.HEAD_DIM)
SWEEP_CASES = (
    [("v2", dict(block_q=bq, block_k=bk, kt=kt)) for bq, bk, kt in flash_variants.SWEEP]
    + [("mh", dict(block_q=bq, block_k=bk, hper=hp)) for hp, bq, bk in flash_multihead.SWEEP]
    + [("x", dict(block_q=1024, block_k=1024, mode=m)) for m in
       ("fold", "fold2", "padfix", "padfix_exp")]
    + [("x", dict(block_q=bq, block_k=bk, mode="padfix")) for bq, bk in flash_bisect.BLOCKS])


def _traced(fn, **kw):
    """What the JAX wrapper traces to at the full bench shape: (q scale,
    seq_pad, K's operand shape, grid, the kernel's exponent primitive)."""
    x = jax.ShapeDtypeStruct(FULL, jnp.bfloat16)
    jaxpr = jax.make_jaxpr(functools.partial(fn, **kw))(x, x, x).jaxpr
    found = {}

    def walk(jp):
        for e in jp.eqns:
            if e.primitive.name == "mul" and "scale" not in found:
                lit = [v for v in e.invars if hasattr(v, "val")]  # a Literal
                if lit:
                    found["scale"] = np.float32(lit[0].val)
            if e.primitive.name == "pallas_call":
                found["seq_pad"] = e.outvars[0].aval.shape[1]
                found["k_shape"] = e.invars[1].aval.shape
                found["grid"] = e.params["grid_mapping"].grid
                prims = {q.primitive.name for q in e.params["jaxpr"].eqns}
                found["exp2"] = "exp2" in prims and "exp" not in prims
                continue
            for param in e.params.values():
                if hasattr(param, "jaxpr"):
                    walk(param.jaxpr)

    walk(jaxpr)
    return found


@pytest.mark.parametrize("kind,kw", SWEEP_CASES,
                         ids=[f"{k}-{'-'.join(map(str, kw.values()))}" for k, kw in SWEEP_CASES])
def test_launch_args_follow_the_scripts(scripts, kind, kw):
    """sq, kv_end, pad, qscale, exponent, mask, K^T row pad and hper of each
    sweep configuration at (1, 48, 15076, 64), against the JAX wrapper traced
    at that shape. Where the JAX wrapper's assertion refuses (v2 2048x1024),
    the port refuses too."""
    seq, bh = FULL[2], FULL[0] * FULL[1]
    q = torch.empty(FULL, dtype=torch.bfloat16, device="meta")
    script, args_of = {"v2": (scripts["bench_flash_variants"].flash_v2, _v2_args),
                       "mh": (scripts["bench_flash_multihead"].flash_mh, _mh_args),
                       "x": (scripts["bench_flash_bisect"].flash_x, _x_args)}[kind]
    if kind == "v2" and _v2_seq_pad(seq, kw["block_q"], kw["block_k"]) - seq >= kw["block_k"]:
        with pytest.raises(AssertionError):
            _traced(script, **kw)
        with pytest.raises(ValueError, match="mask_last_only"):
            args_of(q, **kw)
        return
    ref = _traced(script, **kw)
    args = args_of(q, **kw)
    seq_pad = ref["seq_pad"]
    padfix = kw.get("mode", "").startswith("padfix")
    assert args.sq == seq
    assert (args.kv_end, args.pad) == ((seq_pad, seq_pad - seq) if padfix else (seq, 0))
    assert np.float32(args.qscale) == ref["scale"]
    assert args.exp2 == ref["exp2"]
    assert args.mask == {"v2": _MASK_LAST, "mh": _MASK_ALL}.get(
        kind, _MASK_NONE if padfix else _MASK_ALL)
    if kw.get("kt"):
        assert ref["k_shape"] == (bh, FULL[3], seq_pad)
        assert args.k_row == -(-seq // 8) * 8 and args.k_row % 8 == 0
    else:
        assert ref["k_shape"] == (bh, seq_pad, FULL[3]) and args.k_row == 0
    # the JAX grid walks bh // hper head groups; the kernel's heads walk
    # takes hper heads an item (0: one head a CTA on K4's grid)
    assert args.hper == (bh // ref["grid"][0] if kind == "mh" else 0)


# ---- the kernel's tiling: 128-column kv tiles against the TPU's 1024 ----

TILING_SHAPE = (1, 2, 1100, 64)  # 1024x1024 blocks pad to 2048: pad 948
TILING_CASES = [
    ("x", dict(mode="fold")), ("x", dict(mode="fold2")), ("x", dict(mode="padfix")),
    ("x", dict(mode="padfix_exp")), ("v2", dict()), ("v2", dict(kt=True)),
    ("mh", dict(hper=2)),
]


@pytest.mark.parametrize("kind,kw", TILING_CASES,
                         ids=[f"{k}-{'-'.join(map(str, kw.values()))}" for k, kw in TILING_CASES])
def test_kernel_tiling_within_the_card_gates(scripts, kind, kw):
    """``_online_loop`` over 128-column kv blocks (the kernel's tile, with its
    running max moving every 128 columns) against the Pallas kernel at its
    1024-column blocks, on the same padded operands: within the gates
    ``chip_smoke.py`` holds the kernel to (``bf16_gates``: max abs two bf16
    ulps of the output's scale, mean abs 2**-9 of its mean magnitude). The
    masking variants mask every 128-column tile, which is the function of
    the kernel's tail mask with the tiles past kv_end skipped."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(seed=17 + len(kw), shape=TILING_SHAPE)
    blocks = dict(block_q=1024, block_k=1024)
    seq, dim = TILING_SHAPE[2], TILING_SHAPE[3]
    if kind == "x":
        ref = _interpret(scripts["bench_flash_bisect"].flash_x, jq, jk, jv, **blocks, **kw)
        seq_pad, scale, var = _x_config(seq, dim, 1024, 1024, kw["mode"])
    elif kind == "v2":
        # the JAX assertion (pad < block_k) does not hold at 1100: mask every block
        kw = dict(kw, mask_last_only=False)
        ref = _interpret(scripts["bench_flash_variants"].flash_v2, jq, jk, jv, **blocks, **kw)
        seq_pad, scale, var = _v2_config(seq, dim, None, 1024, 1024, False, kw.get("kt", False))
    else:
        ref = _interpret(scripts["bench_flash_multihead"].flash_mh, jq, jk, jv, **blocks, **kw)
        seq_pad, scale, var = _mh_config(TILING_SHAPE, 1024, 1024, kw["hper"])
    assert seq_pad == 2048
    qp, kp, vp = _scaled_padded(tq, tk, tv, scale, seq_pad)
    if var.kt:
        kp = kp.transpose(1, 2).contiguous()
    if var.mask != _MASK_NONE:
        var = var._replace(mask=_MASK_ALL)
    out = _finish(_online_loop(qp, kp, vp, seq=seq, block_q=1024, block_k=128, var=var),
                  TILING_SHAPE).float().numpy()
    top = np.abs(ref)
    err = np.abs(out - ref)
    assert err.max() <= 2.0 * 2.0 ** (np.floor(np.log2(top.max())) - 7)
    assert err.mean() <= top.mean() * 2.0 ** -9

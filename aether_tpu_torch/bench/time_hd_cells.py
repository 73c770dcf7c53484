"""Time K2, K3, K4 and K6 at every head dim, one checkout against another, on an
NVIDIA GPU.

    python aether_tpu_torch/bench/time_hd_cells.py unpack REV DIR
    python aether_tpu_torch/bench/time_hd_cells.py ab DIR [--json OUT]
        [--only f32|spread|wide|split] [--rounds N]
    python aether_tpu_torch/bench/time_hd_cells.py run [CHECKOUT] [--json OUT]
        [--only f32|spread|wide|split]
    python aether_tpu_torch/bench/time_hd_cells.py digests [CHECKOUT] [--json OUT]

``unpack`` (in a git checkout) writes revision REV's ``aether_tpu_torch`` and
``chip_smoke.py`` into DIR with ``git archive``; make DIR a git-ignored
directory of this repository (``_checkout/parent``) so that a copy of the
working tree carries it to the card. ``ab`` runs DIR, this checkout, this
checkout, DIR (``--rounds`` times over, default once), each in its own
process (each package builds its kernels into its own ``_build/``), prints
every case's times side by side and fails unless the head_dim-64 outputs of
the bf16 and int8 kernels are bit-identical across the runs and each f32
output is bit-identical between the runs of one checkout (the f32 kernels' outputs are held to their plain
version instead: a redesign of them moves their last bits); it also says
which f32 outputs the two checkouts share bit for bit.
``run`` times one checkout (default: this one) and prints, for that package:

- on a fresh build, the registers and spill of every kernel of the sources
  ``flash_prepacked*``, ``flash_fixed_max*``, ``flash_online*``,
  ``flash_variants`` and ``flash_pv8`` (ptxas);
- at head_dim 64: K2 (``flash_attention_prepacked``) at (48, 15360, 64) over
  K1's operands with 15076 valid tokens, int8 and float; K4 bf16 at (1, 48,
  15076, 64) through the wrapper and alone, and K7 (``flash_v2``, K rows and
  K^T) and K8 (``flash_mh``, hper 2) at the same shape; K3 int8 and bf16
  QK^T and K6 at the CFG pair's (2, 48, 15076, 64) bf16, through the wrapper
  and alone on the operands it prepares; a digest of each output;
- at head_dim 16, 32, 48, 80, 96 and 112: K2 int8 and float over K1's
  operands at (48, 15360, D) with 15076 valid tokens; K3 int8 and bf16 QK^T
  and K6 at (1, 48, 15076, D) bf16, through the wrapper and alone, and K3
  unnormalized (int8 and bf16 QK^T) on one ring step of ``chip_smoke.py``
  phase 27e, a (1, 48, 3840, D) q stripe against a kv stripe of the same
  size with a shared score bound; K4 bf16 at (1, 48, 15076, D) through the
  wrapper and alone, also at 128 ("vpu");
- the f32 kernels (the training forward and the f32 request): K4 f32 at
  (1, 48, 15076, D), D 16 to 128 (64 included, 128 "vpu"), and K3 f32 with
  f32 and int8 QK^T at D 16 to 112, through the wrapper and alone on the
  operands the wrapper prepares (either checkout's form), each output held
  to its plain version at max abs 1e-4 (the run fails otherwise), beside one
  f32 ``scaled_dot_product_attention`` call at each D. ``--only f32`` runs
  these alone.

``digests`` prints (and writes to ``--json``) the digests of K4 bf16 and f32
through ``flash_attention`` at (1, 48, 15076, D) for D in ``DIGEST_DIMS`` (64,
72 on the padded instance of 80, and the instances 160 and 256 above 128) on
inputs drawn on the card from seed D
(:func:`k4_digests`), for one checkout (default: this one): the outputs that
``chip_smoke.py`` phase 29d holds, bit for bit, to a parent's.

``--only wide`` runs K4 bf16 and f32 above head_dim 256 (the wide kernels,
``csrc/flash_online_wide_bf16.cu`` and ``flash_online_wide.cu``) at (1, 48,
15076, D) for D in ``WIDE_DIMS`` (320 and 512), through the wrapper and alone
on the operands it prepares (three means of 3 calls in bf16, of 1 in f32),
each output held to its plain version at ``chip_smoke.py``'s gates (bf16
``bf16_gates``, f32 ``K4_F32_128_BARS``; the run fails otherwise), beside
one ``scaled_dot_product_attention`` call of the same shape and dtype.

``--only split`` runs the same cases at D in ``SPLIT_DIMS`` (144, 160, 192,
200, 224 and 256: K4 f32 above 128 up to 256, on ``csrc/flash_online_wide.cu``'s
CTA pairs since they replaced ``split_kernel``; 144 and 200 on the padded
widths 160 and 224), the f32 means over 2 calls, and K4 bf16
(``online_cell<D>``) beside it, whose outputs ``ab`` shows bit-identical
across the checkouts where bf16 did not move: ``ab _checkout/parent --only
split`` is K4 f32 at 129-256, the parent against the change in one call.

``--only spread`` runs the head_dim-64 cases of K2, K4, K7 and K8 above and
then only the cells whose parent / change ratio spreads most from call to
call, each through the wrapper and alone: K4 bf16 at every head dim 16 to
128, K6 and the K3 ring step at every head dim other than 64 and 128, and
K3 f32 at 32 and 48; K4 and K6 over 15 calls a mean, the ring step over 50.

Every time is three CUDA-event means of 5 calls (10 for K2) unless said. Timing and the
ptxas names are ``chip_smoke.py``'s, as in ``time_prologue.py`` (K1). Needs
CUDA for ``run`` and ``ab``; imports no JAX.
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
HEAD_DIMS = (16, 32, 48, 80, 96, 112)
H, S, S_PAD, STRIPE = 48, 15076, 15360, 3840


def unpack(rev: str, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    archive = subprocess.run(["git", "archive", rev, "aether_tpu_torch", "chip_smoke.py"],
                             cwd=ROOT, check=True, capture_output=True).stdout
    subprocess.run(["tar", "-x", "-C", out], input=archive, check=True)
    print(f"unpacked {rev} into {out}")


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the sha256 of the tensor's bytes."""
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


DIGEST_DIMS = (64, 72, 160, 256)


def k4_digests(fa, dev) -> dict:
    """{name: digest} of K4 bf16 and f32 through ``fa.flash_attention`` (the
    module of any checkout) at (1, 48, 15076, D), D in ``DIGEST_DIMS``, on q,
    k and v drawn on the card from seed D (the same values in both dtypes;
    drawing them with numpy on the host took most of the seconds)."""
    out = {}
    for hd in DIGEST_DIMS:
        gen = torch.Generator(device=dev)
        gen.manual_seed(hd)
        drawn = [torch.randn((1, H, S, hd), generator=gen, device=dev) for _ in range(3)]
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            q, k, v = (t.to(dtype) for t in drawn)
            out[f"K4 {tag} hd{hd}"] = digest(fa.flash_attention(q, k, v))
            del q, k, v
        del drawn
        torch.cuda.empty_cache()
    return out


def digests(checkout: str, out_json) -> None:
    sys.path.insert(0, checkout)
    from aether_tpu_torch.ops import _build, flash_attention as fa

    if not _build.__file__.startswith(checkout):
        raise SystemExit(f"imported {_build.__file__}, not the package under {checkout}")
    if not torch.cuda.is_available():
        raise SystemExit("time_hd_cells.py needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    result = {"checkout": checkout, "device": smi,
              "digests": k4_digests(fa, torch.device("cuda", 0))}
    print(json.dumps(result), flush=True)
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f)


def run(checkout: str, out_json, only=None) -> None:
    # the package of that checkout, not one imported already, and the helpers
    # of its chip_smoke.py
    sys.path.insert(0, checkout)
    import chip_smoke as cs
    from aether_tpu_torch.ops import _build, flash_attention as fa, flash_variants as fv
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue

    if not _build.__file__.startswith(checkout):
        raise SystemExit(f"imported {_build.__file__}, not the package under {checkout}")
    if not torch.cuda.is_available():
        raise SystemExit("time_hd_cells.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"checkout {checkout}; {smi}", flush=True)
    _build.lib()
    kernel, regs = "?", {}
    for line in _build.BUILD_LOG["ptxas"].splitlines():
        if "Compiling entry function" in line:
            kernel = cs.ptxas_kernel_name(line.split("'")[1])
        elif kernel.startswith(("flash_pv8", "flash_fixed_max", "flash_prepacked",
                                "flash_online", "flash_variants")) and (
                "registers" in line or "spill" in line):
            print(f"  ptxas {kernel}: {line.strip()}", flush=True)
            regs.setdefault(kernel, []).append(line.strip())
    result = {"device": smi, "ms": {}, "digests": {}, "ptxas": regs}

    def times(name, fn, iters=5):
        ms = [cs.cuda_time_ms(fn, iters) for _ in range(3)]
        result["ms"][name] = ms
        return " ".join(f"{m:.4f}" for m in ms)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    if only in ("f32", "wide", "split"):
        if only == "f32":
            f32_cases(cs, fa, _build, dev, gen, result, times)
        elif only == "wide":
            wide_cases(cs, fa, dev, gen, result, times)
        else:
            wide_cases(cs, fa, dev, gen, result, times, SPLIT_DIMS, f32_iters=2)
        if out_json:
            with open(out_json, "w") as f:
                json.dump(result, f)
        return

    def k2_cases(hd):
        """K2 int8 and float over K1's operands at (48, 15360, hd), 15076 valid."""
        d = H * hd
        for quantize in (True, False):
            y = torch.randn((1, S_PAD, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
            y[:, S:] = 0
            norms = [1.0 + 0.1 * torch.randn(hd, generator=gen, device=dev),
                     0.1 * torch.randn(hd, generator=gen, device=dev),
                     1.0 + 0.1 * torch.randn(hd, generator=gen, device=dev),
                     0.1 * torch.randn(hd, generator=gen, device=dev)]
            q, k, v, qsc, qn, ksc, kn, _ = qkv_prologue(
                y[..., :d], y[..., d:2 * d], y[..., 2 * d:], *norms, None, None,
                num_heads=H, head_dim=hd, eps=1e-6, s_valid=S, quantize=quantize)
            kw = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=S)
            name = f"K2 {'int8' if quantize else 'float'} hd{hd}"
            result["digests"][name] = digest(fa.flash_attention_prepacked(q, k, v, **kw))
            print(f"{name}: "
                  f"{times(name, lambda: fa.flash_attention_prepacked(q, k, v, **kw), 10)}"
                  f" ms", flush=True)
            del y, q, k, v
            torch.cuda.empty_cache()

    def k4_case(q, k, v, hd, iters=5):
        """K4 bf16 through the wrapper and alone (uncounted at 64, counted
        on flash_attention_hd at the others: the launches both checkouts
        have)."""
        name = f"K4 bf16 hd{hd}"
        result["digests"][name] = digest(fa.flash_attention(q, k, v))
        qh, kh, vh = (t.reshape(H, S, hd).contiguous() for t in (q, k, v))
        buf = torch.empty_like(qh)
        launch = fa._online_bf16_launch if hd == 64 else fa.flash_attention_hd
        args = (qh, kh, vh, buf, S, hd < 128, fa._online_fold(None, hd))
        print(f"{name}: wrapper {times(name, lambda: fa.flash_attention(q, k, v), iters)} ms, "
              f"alone {times(name + ' alone', lambda: launch(*args), iters)} ms", flush=True)
        del qh, kh, vh, buf

    # ---- head_dim 64: K2 over K1's operands; K4 bf16, K7 and K8; K3 and K6
    # at batch 2 ----
    k2_cases(64)
    q, k, v = (torch.randn((1, H, S, 64), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    k4_case(q, k, v, 64)
    for name, fn in (("K7 hd64", lambda: fv.flash_v2(q, k, v)),
                     ("K7 kt hd64", lambda: fv.flash_v2(q, k, v, kt=True)),
                     ("K8 hper2 hd64", lambda: fv.flash_mh(q, k, v))):
        result["digests"][name] = digest(fn())
        print(f"{name}: {times(name, fn)} ms", flush=True)
    del q, k, v
    torch.cuda.empty_cache()

    def fixed_cases(q, k, v, hd, tag):
        b = q.shape[0]
        for qk8 in (True, False):
            name = f"K3 {'int8' if qk8 else 'bf16'} hd{hd}{tag}"
            out = fa.flash_attention_fixed_max(q, k, v, qk_int8=qk8)
            result["digests"][name] = digest(out)
            ops = fa._fixed_max_operands(
                q, k, v, sm_scale=None, kv_valid=None, heads_per_cell=4, noshift=False,
                qk_int8=qk8, pv_int8=False, score_bound=None, unnormalized=False)
            buf = torch.empty((b * H, S, hd), dtype=torch.bfloat16, device=dev)
            launch = fa._fixed_max_launch if hd == 64 else fa.flash_attention_fixed_max_hd
            print(f"{name}: wrapper "
                  f"{times(name, lambda: fa.flash_attention_fixed_max(q, k, v, qk_int8=qk8))}"
                  f" ms, alone {times(name + ' alone', lambda: launch(ops, buf, None))} ms",
                  flush=True)
            del out, ops, buf
        pv8_case(q, k, v, hd, tag)

    def pv8_case(q, k, v, hd, tag, iters=5):
        b = q.shape[0]
        name = f"K6 hd{hd}{tag}"
        result["digests"][name] = digest(fa.flash_attention_pv8(q, k, v))
        qp, kp, vt, ops, span = fa._pv8_operands(q, k, v, sm_scale=None, kv_valid=None,
                                                 block_k=1024, heads_per_cell=4)
        buf = torch.empty((b * H, qp.shape[1], hd), dtype=torch.bfloat16, device=dev)
        launch = fa._pv8_launch if hd == 64 else fa.flash_attention_pv8_hd
        print(f"{name}: wrapper "
              f"{times(name, lambda: fa.flash_attention_pv8(q, k, v), iters)} ms, alone "
              f"{times(name + ' alone', lambda: launch(qp, kp, vt, ops, span, buf), iters)} ms",
              flush=True)
        del qp, kp, vt, ops, buf

    def ring_cases(q, k, v, hd, iters=5, alone=False):
        """K3 unnormalized on one ring step (a q stripe against a kv stripe
        with a shared score bound), through the wrapper and, with ``alone``,
        the kernel alone on the operands it prepares."""
        qs, ks, vs = (t[:, :, :STRIPE].contiguous() for t in (q, k, v))
        bound = (fa._row_norm_max(qs) * fa._row_norm_max(ks) * (hd ** -0.5 * fa._LOG2E))
        for qk8 in (True, False):
            name = f"K3 unnormalized {'int8' if qk8 else 'bf16'} hd{hd} ring step"
            kw = dict(qk_int8=qk8, score_bound=bound, unnormalized=True)
            line = (f"{name}: "
                    f"{times(name, lambda: fa.flash_attention_fixed_max(qs, ks, vs, **kw), iters)}"
                    f" ms")
            if alone:
                ops = fa._fixed_max_operands(
                    qs, ks, vs, sm_scale=None, kv_valid=None, heads_per_cell=4,
                    noshift=False, qk_int8=qk8, pv_int8=False, score_bound=bound,
                    unnormalized=True)
                buf = torch.empty((H, STRIPE, hd), dtype=torch.bfloat16, device=dev)
                l_buf = torch.empty((H, STRIPE, 1), dtype=torch.float32, device=dev)
                line += (", alone " + times(name + " alone", lambda: fa.flash_attention_fixed_max_hd(
                    ops, buf, l_buf), iters) + " ms")
                del ops, buf, l_buf
            print(line, flush=True)
        del qs, ks, vs

    if only == "spread":
        # the cells whose parent / change ratio spreads most between calls,
        # each through the wrapper and alone, over more calls a mean
        for hd in (64,) + HEAD_DIMS + (128,):
            q, k, v = (torch.randn((1, H, S, hd), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(3))
            k4_case(q, k, v, hd, iters=15)
            if hd not in (64, 128):
                pv8_case(q, k, v, hd, "", iters=15)
                ring_cases(q, k, v, hd, iters=50, alone=True)
            del q, k, v
            torch.cuda.empty_cache()
        f32_cases(cs, fa, _build, dev, gen, result, times, dims=(32, 48), k4=False)
        if out_json:
            with open(out_json, "w") as f:
                json.dump(result, f)
        return

    q, k, v = (torch.randn((2, H, S, 64), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    fixed_cases(q, k, v, 64, " b2")
    del q, k, v
    torch.cuda.empty_cache()

    # ---- the other head dims at batch 1, and one ring step ----
    for hd in HEAD_DIMS + (128,):
        q, k, v = (torch.randn((1, H, S, hd), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        k4_case(q, k, v, hd)
        if hd == 128:  # K2, K3 and K6 stop at 112
            break
        fixed_cases(q, k, v, hd, "")
        ring_cases(q, k, v, hd)
        del q, k, v
        torch.cuda.empty_cache()
        k2_cases(hd)
    f32_cases(cs, fa, _build, dev, gen, result, times)
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f)


F32_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)


def f32_cases(cs, fa, _build, dev, gen, result, times, dims=F32_DIMS, k4=True) -> None:
    """K4 f32 (unless not ``k4``) at ``dims`` and K3 f32 (f32 and int8 QK^T)
    at those below 128, through the wrapper and alone, against their plain
    versions at max abs 1e-4, beside one f32 SDPA call a head dim. Takes
    either form of the kernels: the 3xTF32 cell's split operands
    (``_tf32_operands``) or the FMA kernels they replaced."""
    split_form = hasattr(fa, "_tf32_operands")
    print(f"f32 kernels: {'the 3xTF32 cell' if split_form else 'the FMA kernels'}", flush=True)

    def k4_alone(q, k, v, hd):
        """(launch, output view) of K4 f32 alone on its wrapper's operands."""
        qf, kf, vf, kv_len = fa._online_operands(q, k, v, None, None)
        heads = [t.reshape(H, S, hd) for t in (qf, kf, vf)]
        if split_form:
            split = fa._tf32_operands(*heads)
            buf = torch.empty((H, S, hd), device=dev)
            return lambda: fa._online_f32_launch(split, buf, kv_len), buf
        if hd != 64:
            qh, kh, vh = (t.contiguous() for t in heads)
            buf = torch.empty((H, S, hd), device=dev)
            return lambda: fa.flash_attention_f32_hd(qh, kh, vh, buf, kv_len), buf
        pad = -(-S // 64) * 64  # the FMA kernel's 64-row tiles
        qp, kp, vp = (fa._pad_rows(t, pad) for t in heads)
        buf = torch.empty((H, pad, hd), device=dev)
        lib = _build.lib()

        def launch():
            _build.check(lib.aether_flash_online(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                                                 buf.data_ptr(), H, pad, pad, kv_len,
                                                 _build.stream_ptr(dev)), "aether_flash_online")
        return launch, buf[:, :S]

    def k3_alone(q, k, v, qk8):
        ops = fa._fixed_max_operands(q, k, v, sm_scale=None, kv_valid=None, heads_per_cell=4,
                                     noshift=False, qk_int8=qk8, pv_int8=False,
                                     score_bound=None, unnormalized=False)
        buf = torch.empty(q.shape[1:], device=dev)
        if split_form:
            split = fa._tf32_operands(ops.q, ops.k, ops.v)
            return lambda: fa._fixed_max_f32_launch(split, ops, buf, None), buf
        return lambda: fa.flash_attention_fixed_max_f32(ops, buf, None), buf

    def case(name, wrapper, plain, alone):
        out, again = wrapper(), wrapper()
        ref = plain()
        err = (out - ref).abs()
        e_max, e_mean = err.max().item(), err.mean().item()
        del ref, err
        result["digests"][name] = digest(out)
        result.setdefault("f32_err", {})[name] = (e_max, e_mean)
        launch, view = alone()
        t_wrap = times(name, wrapper)
        t_alone = times(name + " alone", launch)
        torch.cuda.synchronize()
        same = torch.equal(again, out) and torch.equal(view.reshape(out.shape), out)
        print(f"{name}: wrapper {t_wrap} ms, alone {t_alone} ms; max abs err {e_max:.3e}, "
              f"mean {e_mean:.3e} against the plain version; repeats and alone "
              f"bit-identical: {'yes' if same else 'NO'}", flush=True)
        if e_max > 1e-4 or e_mean > 1e-4 or not same:
            raise SystemExit(f"{name}: max abs err {e_max:.3e} / mean {e_mean:.3e} against "
                             f"the plain version (bar 1e-4), bit-identical repeats {same}")

    for hd in dims:
        q, k, v = (torch.randn((1, H, S, hd), generator=gen, device=dev) for _ in range(3))
        sdpa = cs.sdpa_ms(dev, gen, 1, torch.float32, hd)
        result["ms"][f"SDPA f32 hd{hd}"] = [sdpa]
        print(f"SDPA f32 hd{hd}: {sdpa:.4f} ms", flush=True)
        if k4:
            case(f"K4 f32 hd{hd}", lambda: fa.flash_attention(q, k, v),
                 lambda: fa.flash_attention_plain(q, k, v), lambda: k4_alone(q, k, v, hd))
        if hd < 128:
            for qk8 in (False, True):
                kw = dict(fixed_max=True, qk_int8=qk8)
                case(f"K3 f32 {'int8' if qk8 else 'f32'} QK hd{hd}",
                     lambda: fa.flash_attention(q, k, v, **kw),
                     lambda: fa.flash_attention_fixed_max_plain(q, k, v, qk_int8=qk8),
                     lambda: k3_alone(q, k, v, qk8))
        del q, k, v
        torch.cuda.empty_cache()


WIDE_DIMS = (320, 512)
SPLIT_DIMS = (144, 160, 192, 200, 224, 256)


def wide_cases(cs, fa, dev, gen, result, times, dims=WIDE_DIMS, f32_iters=1) -> None:
    """K4 bf16 and f32 at (1, 48, 15076, D), D in ``dims``: the kernels
    through the wrapper and alone (means of 3 bf16 and ``f32_iters`` f32
    calls), against the plain version at ``chip_smoke.py``'s gates, beside
    one SDPA call of the dtype."""
    for hd in dims:
        for dtype, tag, iters in ((torch.bfloat16, "bf16", 3), (torch.float32, "f32", f32_iters)):
            name = f"K4 {tag} hd{hd}"
            q, k, v = (torch.randn((1, H, S, hd), generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            out = fa.flash_attention(q, k, v)
            ref = fa.flash_attention_plain(q, k, v)
            err = (out.float() - ref.float()).abs()
            e_max, e_mean = err.max().item(), err.mean().item()
            bars = cs.bf16_gates(ref) if dtype == torch.bfloat16 else cs.K4_F32_128_BARS
            del ref, err
            result["digests"][name] = digest(out)
            result.setdefault("f32_err", {})[name] = (e_max, e_mean)
            qh, kh, vh, kv_len, fold = fa._online_kernel_operands(q, k, v, None, None)
            buf = torch.empty_like(qh)
            if dtype == torch.bfloat16:
                def launch():
                    fa._online_bf16_launch(qh, kh, vh, buf, kv_len, False, fold)
            else:
                split = fa._tf32_operands((qh * fold).to(qh.dtype), kh, vh)

                def launch():
                    fa._online_f32_launch(split, buf, kv_len)
            t_wrap = times(name, lambda: fa.flash_attention(q, k, v), iters)
            t_alone = times(name + " alone", launch, iters)
            torch.cuda.synchronize()
            same = torch.equal(buf[..., :hd].reshape(out.shape), out)
            del qh, kh, vh, buf
            lib = cs.sdpa_or_none(q, k, v, iters)
            if lib is not None:
                result["ms"][f"SDPA {tag} hd{hd}"] = [lib]
            print(f"{name}: wrapper {t_wrap} ms, alone {t_alone} ms; max abs err {e_max:.3e}, "
                  f"mean {e_mean:.3e} against the plain version (gates {bars[0]:.3e} / "
                  f"{bars[1]:.3e}); alone bit-identical: {'yes' if same else 'NO'}; SDPA "
                  + (f"{lib:.4f} ms" if lib is not None else "none"), flush=True)
            del q, k, v, out
            torch.cuda.empty_cache()
            if e_max > bars[0] or e_mean > bars[1] or not same:
                raise SystemExit(f"{name}: max abs err {e_max:.3e} / mean {e_mean:.3e} against "
                                 f"the plain version (gates {bars}), alone identical {same}")


def ab(other: str, out_json, only=None, rounds: int = 1) -> None:
    """DIR, this checkout, this checkout, DIR (``rounds`` times over), each
    in its own process."""
    order = [("parent", os.path.abspath(other)), ("change", ROOT), ("change", ROOT),
             ("parent", os.path.abspath(other))] * rounds
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, checkout) in enumerate(order):
            path = os.path.join(tmp, f"{i}.json")
            print(f"---- run {i}: {label} ({checkout})", flush=True)
            subprocess.run([sys.executable, os.path.abspath(__file__), "run", checkout,
                            "--json", path] + (["--only", only] if only else []), check=True)
            with open(path) as f:
                runs.append((label, json.load(f)))
    print(f"---- {', '.join(label for label, _ in order)} (ms, the least of three means "
          "each); parent / change of the least of each side's runs, and of their medians")
    for name in runs[1][1]["ms"]:
        cells = [min(r["ms"][name]) if name in r["ms"] else float("nan") for _, r in runs]
        sides = {side: sorted(c for c, (label, _) in zip(cells, runs) if label == side)
                 for side in ("parent", "change")}
        parent, change = sides["parent"][0], sides["change"][0]
        mid = {side: (v[(len(v) - 1) // 2] + v[len(v) // 2]) / 2 for side, v in sides.items()}
        print(f"{name}: " + " / ".join(f"{c:.4f}" for c in cells)
              + f"; parent / change {parent / change:.3f}x, medians "
              f"{mid['parent'] / mid['change']:.3f}x", flush=True)
    same, repeat = {}, {}
    for name, want in runs[1][1]["digests"].items():
        if " f32" in name:  # the f32 kernels: each checkout against itself
            repeat[name] = all(
                len({r["digests"].get(name) for label, r in runs if label == side}) == 1
                for side in ("parent", "change"))
        elif "hd64" in name:
            same[name] = all(r["digests"].get(name) == want for _, r in runs)
    print("head_dim-64 outputs bit-identical across the runs: "
          + ", ".join(f"{n} {'yes' if ok else 'NO'}" for n, ok in same.items()), flush=True)
    others = {name: all(r["digests"].get(name) == want for _, r in runs)
              for name, want in runs[1][1]["digests"].items()
              if "hd64" not in name and " f32" not in name}
    print("the other head dims' outputs bit-identical across the runs (the parent's "
          "too): " + ", ".join(f"{n} {'yes' if ok else 'no'}" for n, ok in others.items()),
          flush=True)
    print("f32 outputs bit-identical between the runs of one checkout: "
          + ", ".join(f"{n} {'yes' if ok else 'NO'}" for n, ok in repeat.items()), flush=True)
    across = {name: all(r["digests"].get(name) == want for _, r in runs)
              for name, want in runs[1][1]["digests"].items() if " f32" in name}
    print("f32 outputs bit-identical across the runs (the parent's too): "
          + ", ".join(f"{n} {'yes' if ok else 'no'}" for n, ok in across.items()), flush=True)
    for name, (e_max, e_mean) in runs[1][1].get("f32_err", {}).items():
        print(f"{name}: change max abs err {e_max:.3e}, mean {e_mean:.3e} against the plain "
              f"version; parent {runs[0][1].get('f32_err', {}).get(name)}", flush=True)
    if out_json:
        with open(out_json, "w") as f:
            json.dump({"order": [label for label, _ in order], "runs": [r for _, r in runs],
                       "hd64_identical": same, "f32_repeat_identical": repeat}, f, indent=1)
    if not all(same.values()):
        raise SystemExit("a head_dim-64 output differs between the checkouts")
    if not all(repeat.values()):
        raise SystemExit("an f32 output differs between two runs of one checkout")


def main(argv) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    u = sub.add_parser("unpack")
    u.add_argument("rev")
    u.add_argument("dir")
    a = sub.add_parser("ab")
    a.add_argument("dir")
    a.add_argument("--json")
    a.add_argument("--only", choices=["f32", "spread", "wide", "split"])
    a.add_argument("--rounds", type=int, default=1)
    r = sub.add_parser("run")
    r.add_argument("checkout", nargs="?", default=ROOT)
    r.add_argument("--json")
    r.add_argument("--only", choices=["f32", "spread", "wide", "split"])
    d = sub.add_parser("digests")
    d.add_argument("checkout", nargs="?", default=ROOT)
    d.add_argument("--json")
    args = p.parse_args(argv)
    if args.cmd == "unpack":
        unpack(args.rev, args.dir)
    elif args.cmd == "digests":
        digests(os.path.abspath(args.checkout), args.json)
    elif args.cmd == "ab":
        ab(args.dir, args.json, args.only, args.rounds)
    else:
        run(os.path.abspath(args.checkout), args.json, args.only)


if __name__ == "__main__":
    main(sys.argv[1:])

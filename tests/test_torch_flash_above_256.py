"""K4 above head_dim 256 against the Pallas kernel in interpret mode (CPU).

The JAX ``flash_attention`` sends every head dim >= 128 to ``_flash_kernel``
with the "vpu" denominator and the fixed max, ``qk_int8`` and ``pv_int8``
off, with no upper limit (``aether_tpu/ops/flash_attention.py:538-548``).
Above 256 the port runs K4 on the card through its wide kernels
(``csrc/flash_online_wide_bf16.cu``, ``csrc/flash_online_wide.cu``), which
read the width at run time: the head dim rounded up to a multiple of 64,
zero-padded by the wrapper. Here, on the same numpy-seeded inputs, at
head_dim 257, 272, 320, 384, 512 and 1000, bf16 and f32:
- ``flash_attention_plain`` and ``flash_attention`` (which a CPU tensor
  routes to it) against ``aether_tpu.ops.flash_attention.flash_attention(...,
  interpret=True)``, as ``tests/test_torch_flash_wide_head_dims.py`` holds
  them at 136-256: "mxu" asked and "vpu" taken, ``kv_valid`` inside a kv
  block, Sq != Skv, B*H odd (head groups of 3), one kv block and several;
- at 320 and 512 the fixed-max flags the wrapper turns off, and the JAX
  wrapper's skipped fold under ``qk_int8`` (ROADMAP "Deliberate departures")
  asserted both ways: the port against the JAX K4 with the fixed max off,
  and the port at ``sm_scale = ln 2`` against JAX as called;
- the operands the CUDA path hands the wide kernels
  (``_online_kernel_operands`` at the width rule above 256: the next
  multiple of 64, the fold of the true D) through the plain loop at the
  width, cut to D, against the unpadded plain result and JAX at D.
Tolerances, those of ``tests/test_torch_flash_wide_head_dims.py``: max abs
2e-5 with f32 operands; one bf16 ulp of the output scale with bf16 operands.
The CUDA kernels are held against the plain version on the card
(``chip_smoke.py`` phase 30, ``tests/test_torch_cuda.py``); the f32 kernel's
arithmetic is emulated in ``tests/test_torch_tf32x3_wide.py``.
"""

import pytest
import torch

from aether_tpu_torch.ops import flash_attention as fa
from aether_tpu_torch.ops.flash_attention import flash_attention_plain
from test_torch_flash_wide_head_dims import (
    FIXED_CASES,
    K4_CASES,
    _assert_close,
    _bf16_ulp,
    _fixed_max_off,
    _inputs,
    _k4,
    _pair,
    _pallas,
)

torch.set_num_threads(1)

HEAD_DIMS = (257, 272, 320, 384, 512, 1000)

CASES = ([("K4", hd, c) for hd in HEAD_DIMS for c in K4_CASES]
         + [("fixed max off", hd, c) for hd in (320, 512) for c in FIXED_CASES])
RUN = {"K4": _k4, "fixed max off": _fixed_max_off}


@pytest.mark.parametrize("kernel,hd,case", CASES,
                         ids=[f"{k}-hd{hd}-{i}" for i, (k, hd, _) in enumerate(CASES)])
def test_k4_above_256_matches_pallas_interpret(kernel, hd, case):
    RUN[kernel](hd, case)


# head dims above 256 and the width the wide kernels run them at; one case
# each: (B, H, S), dtype, kv_valid
PADDED = [(257, 320, (1, 3, 200), "bf16", 170), (272, 320, (1, 2, 150), "f32", 141),
          (320, 320, (2, 2, 130), "bf16", None), (330, 384, (1, 3, 130), "f32", 120),
          (500, 512, (1, 2, 150), "bf16", 149), (1000, 1024, (1, 3, 70), "f32", 66)]


@pytest.mark.parametrize("d,width,bhs,dtype,kv_valid", PADDED)
def test_wide_operands_match_pallas_interpret(d, width, bhs, dtype, kv_valid):
    """The wide kernels' operands through the plain loop at the width, cut
    to D, against the unpadded plain version and the JAX K4 at D. The
    default ``sm_scale`` is used, so a fold taken from the width fails."""
    assert fa.head_dim_width(d) == width and width % 64 == 0 and width - 64 < d <= width
    shape = (*bhs, d)
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(shape, d + sum(shape)), dtype)
    ref = _pallas(jq, jk, jv, block_q=128, block_k=128, kv_valid=kv_valid, fixed_max=False)
    atol = 2e-5 if dtype == "f32" else _bf16_ulp(ref)
    plain = flash_attention_plain(tq, tk, tv, kv_valid=kv_valid, block_q=128, block_k=128)
    _assert_close(plain, ref, atol)
    qh, kh, vh, kv_len, fold = fa._online_kernel_operands(tq, tk, tv, None, kv_valid)
    assert qh.shape == (bhs[0] * bhs[1], bhs[2], width) and fold == fa._online_fold(None, d)
    assert not any(t[..., d:].any() for t in (qh, kh, vh))
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (qh, kh, vh))
    padded = fa._online_loop(qh, kh, vh, kv_len, fold, "vpu", 128, 128, 4)
    padded = padded[..., :d].reshape(shape)
    _assert_close(padded, ref, atol)
    plain = plain.float().numpy()
    _assert_close(padded, plain, 2e-6 if dtype == "f32" else _bf16_ulp(plain))


@pytest.mark.parametrize("d,width", [(129, 160), (256, 256), (257, 320), (320, 320),
                                     (321, 384), (512, 512), (513, 576), (1000, 1024)])
def test_head_dim_width_rule(d, width):
    """Up to 256 the instances' widths (multiples of 32 above 128); above,
    the next multiple of 64, which the wide kernels read at run time."""
    assert fa.head_dim_width(d) == width

"""The port's DiT at the full AetherV1 width on the CPU.

One block at 3072 wide, 48 heads x 64, 4096 text dims, 512-dim temb and
96 -> 56 channels, over 108 video and 226 text tokens, built from the
upstream-named torch reference (``fill_state_dict_deterministic(
TorchDiTRef(cfg))``) through the port's converter
(``aether_tpu_torch/io/weights.py::convert_dit_state_dict``, the fused qkv
at 48 heads), and held against ``tests/fixtures/dit_fullwidth_goldens.npz``
at the bar ``tests/test_fullwidth_parity.py`` holds the JAX DiT to (1e-4),
through both of the port's float attention paths on the CPU: the fused
prologue + fixed-shift attention (the plain K1 and K2, the served path) and
the unfused exact softmax.
"""

import pathlib

import numpy as np
import pytest
import torch

from aether_tpu_torch.config import DiTConfig
from aether_tpu_torch.io.weights import convert_dit_state_dict
from aether_tpu_torch.models.dit import DiT

torch.set_num_threads(1)

_GOLDEN = pathlib.Path(__file__).parent / "fixtures" / "dit_fullwidth_goldens.npz"


@pytest.fixture(scope="module")
def fullwidth():
    from test_fullwidth_parity import fullwidth_config, fullwidth_inputs
    from test_torch_parity import TorchDiTRef, fill_state_dict_deterministic

    jcfg = fullwidth_config()
    ref = fill_state_dict_deterministic(TorchDiTRef(jcfg)).eval()
    cfg = DiTConfig(num_layers=1)
    model = DiT(cfg)
    model.load_state_dict(convert_dit_state_dict(ref.state_dict(), cfg))
    del ref
    inputs = tuple(torch.from_numpy(np.asarray(a)) for a in fullwidth_inputs(jcfg))
    return cfg, model.eval(), inputs, np.load(_GOLDEN)


def test_fullwidth_geometry(fullwidth):
    cfg, model, (hidden, text, cos, sin), _ = fullwidth
    assert (cfg.hidden_size, cfg.num_heads, cfg.text_embed_dim) == (3072, 48, 4096)
    assert (cfg.in_channels, cfg.out_channels, cfg.time_embed_dim) == (96, 56, 512)
    assert model.blocks[0].attn.qkv.weight.shape == (3 * 3072, 3072)
    assert hidden.shape == (1, 2, 96, 12, 18) and text.shape == (1, 226, 4096)
    assert cos.shape == (108, 64)


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_fullwidth_block_golden(fullwidth, attn_impl):
    _, model, (hidden, text, cos, sin), golden = fullwidth
    with torch.no_grad():
        out, blocks = model(hidden, text, torch.tensor([999]), cos, sin,
                            qk_int8=False, attn_impl=attn_impl, collect_blocks=True)
    vid, txt = blocks[0]
    diffs = {"vid_0": np.abs(vid.numpy() - golden["vid_0"]).max(),
             "txt_0": np.abs(txt.numpy() - golden["txt_0"]).max(),
             "out": np.abs(out.numpy() - golden["out"]).max()}
    assert max(diffs.values()) < 1e-4, diffs

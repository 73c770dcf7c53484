"""Convert the JAX package's parameter trees into the port's state dicts.

The trees come in as nested dicts/lists of numpy arrays (``np.asarray`` of
``aether_tpu.models.init_dit_params`` / ``init_vae_params`` or of a converted
checkpoint); nothing here imports JAX. Layout changes:

- linear weights ``[in, out]`` -> ``[out, in]``;
- the DiT's stacked per-layer leaves (leading layer axis) -> one entry per
  ``blocks.{i}``; q/k/v projections -> one fused ``attn.qkv`` ``[3D, D]``
  weight in [q | k | v] order;
- conv kernels DHWIO ``[kt, kh, kw, in, out]`` -> ``[out, in, kt, kh, kw]``;
  1x1x1 kernels -> ``[out, in]``.

Float leaves become f32. A quantized leaf ``{"q": codes [in, out], "s": (out,)}``
(``quantize_dit_params``) becomes ``<name>.q`` [out, in] in its own dtype (int8
or float8_e4m3fn, never dequantized) and ``<name>.s``; the fused qkv stacks the
codes and the scales of q, k and v. :func:`~aether_tpu_torch.models.dit.dit_from_state_dict`
builds the matching model.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from aether_tpu_torch.config import DiTConfig

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _codes(q) -> torch.Tensor:
    """Quantized codes in their own dtype. ``torch.from_numpy`` rejects the
    ml_dtypes float8 type, so fp8 codes cross as their bytes."""
    q = np.ascontiguousarray(q)
    if q.dtype == np.int8:
        return torch.from_numpy(q.copy())
    if q.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(q.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    raise TypeError(f"quantized codes must be int8 or float8_e4m3fn, got {q.dtype}")


def _lin(sd: StateDict, name: str, w, b) -> None:
    if isinstance(w, Mapping):
        sd[f"{name}.q"] = _codes(np.asarray(w["q"]).T)
        sd[f"{name}.s"] = _t(w["s"])
    else:
        sd[f"{name}.weight"] = _t(np.asarray(w).T)
    sd[f"{name}.bias"] = _t(b)


def _layer(w, i: int):
    """Layer ``i`` of a stacked leaf, plain or ``{"q", "s"}``."""
    if isinstance(w, Mapping):
        return {"q": np.asarray(w["q"])[i], "s": np.asarray(w["s"])[i]}
    return np.asarray(w)[i]


def _cat_out(ws):
    """Leaves [in, out] joined along out; codes and scales alike."""
    if isinstance(ws[0], Mapping):
        return {"q": np.concatenate([w["q"] for w in ws], axis=1),
                "s": np.concatenate([w["s"] for w in ws])}
    return np.concatenate(ws, axis=1)


def dit_state_dict_from_jax(params: Mapping[str, Any], cfg: DiTConfig) -> StateDict:
    """``init_dit_params`` (or ``quantize_dit_params``) tree -> ``models.dit.DiT``
    state dict: floats in f32, quantized codes in their dtype."""
    sd: StateDict = {}
    pe = params["patch_embed"]
    _lin(sd, "proj", pe["proj_w"], pe["proj_b"])
    _lin(sd, "text_proj", pe["text_w"], pe["text_b"])
    te = params["time_embed"]
    _lin(sd, "time_embed.w1", te["w1"], te["b1"])
    _lin(sd, "time_embed.w2", te["w2"], te["b2"])
    if "ofs_embed" in params:  # CogVideoX-1.5 (``ofs_embed_dim`` set)
        oe = params["ofs_embed"]
        _lin(sd, "ofs_embed.w1", oe["w1"], oe["b1"])
        _lin(sd, "ofs_embed.w2", oe["w2"], oe["b2"])
    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        for n in ("norm1", "norm2"):
            p = blocks[n]
            _lin(sd, f"{pre}.{n}.linear", _layer(p["w"], i), p["b"][i])
            sd[f"{pre}.{n}.ln_scale"] = _t(p["ln_scale"][i])
            sd[f"{pre}.{n}.ln_bias"] = _t(p["ln_bias"][i])
        a = blocks["attn"]
        w_qkv = _cat_out([_layer(a[n], i) for n in ("q_w", "k_w", "v_w")])
        b_qkv = np.concatenate([a["q_b"][i], a["k_b"][i], a["v_b"][i]])
        _lin(sd, f"{pre}.attn.qkv", w_qkv, b_qkv)
        _lin(sd, f"{pre}.attn.o", _layer(a["o_w"], i), a["o_b"][i])
        for n in ("norm_q_scale", "norm_q_bias", "norm_k_scale", "norm_k_bias"):
            sd[f"{pre}.attn.{n}"] = _t(a[n][i])
        m = blocks["mlp"]
        _lin(sd, f"{pre}.mlp.w1", _layer(m["w1"], i), m["b1"][i])
        _lin(sd, f"{pre}.mlp.w2", _layer(m["w2"], i), m["b2"][i])
    sd["norm_final_scale"] = _t(params["norm_final"]["scale"])
    sd["norm_final_bias"] = _t(params["norm_final"]["bias"])
    no = params["norm_out"]
    _lin(sd, "norm_out", no["w"], no["b"])
    sd["norm_out_ln_scale"] = _t(no["ln_scale"])
    sd["norm_out_ln_bias"] = _t(no["ln_bias"])
    _lin(sd, "proj_out", params["proj_out"]["w"], params["proj_out"]["b"])
    return sd


def _conv(w) -> torch.Tensor:
    """DHWIO -> [out, in, kt, kh, kw]."""
    return _t(np.asarray(w).transpose(4, 3, 0, 1, 2))


def _pointwise(w) -> torch.Tensor:
    """(1, 1, 1, in, out) or (in, out) -> [out, in]."""
    w = np.asarray(w)
    return _t(w.reshape(w.shape[-2], w.shape[-1]).T)


def _norm(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.norm_scale"] = _t(p["norm_scale"])
    sd[f"{name}.norm_bias"] = _t(p["norm_bias"])
    if "conv_y_w" in p:
        sd[f"{name}.conv_y.weight"] = _pointwise(p["conv_y_w"])
        sd[f"{name}.conv_y.bias"] = _t(p["conv_y_b"])
        sd[f"{name}.conv_b.weight"] = _pointwise(p["conv_b_w"])
        sd[f"{name}.conv_b.bias"] = _t(p["conv_b_b"])


def _resnet(sd: StateDict, name: str, p: Mapping[str, Any]) -> None:
    _norm(sd, f"{name}.norm1", p["norm1"])
    _norm(sd, f"{name}.norm2", p["norm2"])
    for c in ("conv1", "conv2"):
        sd[f"{name}.{c}.weight"] = _conv(p[f"{c}_w"])
        sd[f"{name}.{c}.bias"] = _t(p[f"{c}_b"])
    if "shortcut_w" in p:
        sd[f"{name}.shortcut.weight"] = _pointwise(p["shortcut_w"])
        sd[f"{name}.shortcut.bias"] = _t(p["shortcut_b"])


def vae_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """``init_vae_params`` tree -> ``models.vae.VAE`` state dict (f32)."""
    sd: StateDict = {}
    enc, dec = params["encoder"], params["decoder"]
    for side, tree in (("encoder", enc), ("decoder", dec)):
        for c in ("conv_in", "conv_out"):
            sd[f"{side}.{c}.weight"] = _conv(tree[f"{c}_w"])
            sd[f"{side}.{c}.bias"] = _t(tree[f"{c}_b"])
        for j, p in enumerate(tree["mid"]):
            _resnet(sd, f"{side}.mid.{j}", p)
    for i, block in enumerate(enc["down_blocks"]):
        for j, p in enumerate(block["resnets"]):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", p)
        if "downsampler" in block:
            sd[f"encoder.down_blocks.{i}.downsampler.weight"] = _conv(
                block["downsampler"]["conv_w"])
            sd[f"encoder.down_blocks.{i}.downsampler.bias"] = _t(
                block["downsampler"]["conv_b"])
    sd["encoder.norm_out.norm_scale"] = _t(enc["norm_out_scale"])
    sd["encoder.norm_out.norm_bias"] = _t(enc["norm_out_bias"])
    for i, block in enumerate(dec["up_blocks"]):
        for j, p in enumerate(block["resnets"]):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", p)
        if "upsampler" in block:
            sd[f"decoder.up_blocks.{i}.upsampler.weight"] = _conv(
                block["upsampler"]["conv_w"])
            sd[f"decoder.up_blocks.{i}.upsampler.bias"] = _t(
                block["upsampler"]["conv_b"])
    _norm(sd, "decoder.norm_out", dec["norm_out"])
    return sd

"""Checkpoint IO: upstream HF state dicts -> the port's state dicts, and the
port's converted-checkpoint files.

Port of ``aether_tpu/io/weights.py``. The name maps follow the upstream module
trees, as the JAX ones do (``convert_dit_state_dict`` :51,
``convert_vae_state_dict`` :148), but land on the port's own modules:

- CogVideoXTransformer3DModel -> ``models.dit.DiT``. HF linears are already
  [out, in]; the patch conv [D, C, p, p] flattens to [D, C*p*p] (the
  (c, ph, pw) token layout of ``DiT._patch_tokens``), and CogVideoX-1.5's
  patch Linear [D, C*pt*p*p] is taken as it is (its (c, pt, ph, pw) layout);
  to_q/to_k/to_v stack into the fused ``attn.qkv`` [3D, D] in [q | k | v]
  order; a 1.5 checkpoint's ``ofs_embedding`` becomes ``ofs_embed``.
- AutoencoderKLCogVideoX -> ``models.vae.VAE``. Causal convs drop their
  ``.conv`` level; the stride-2 / upsampling conv2d kernels gain a unit time
  axis; 1x1x1 kernels (shortcut, spatial-norm modulators) become [out, in].

Tensors keep their dtype (bf16 stays bf16); nothing goes through numpy.

A converted checkpoint is a directory ``<out>/{dit.pt, vae.pt,
text_embeds.npy}``, the JAX layout ``<out>/{dit, vae, text_embeds.npy}``
with ``torch.save`` of the state dicts (read back with ``weights_only=True``)
in place of orbax, which needs jax. A quantized DiT saves its codes and
scales (``<name>.q`` / ``<name>.s``) and loads back quantized.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from aether_tpu_torch.config import DiTConfig, PipelineConfig, VAEConfig
from aether_tpu_torch.io.safetensors import load_hf_safetensors  # noqa: F401
from aether_tpu_torch.models.dit import DiT, dit_from_state_dict
from aether_tpu_torch.models.vae import VAE

StateDict = Dict[str, torch.Tensor]


def convert_dit_state_dict(sd: Mapping[str, torch.Tensor], cfg: DiTConfig) -> StateDict:
    """Upstream CogVideoXTransformer3DModel state dict -> ``DiT`` state dict."""
    out: StateDict = {}

    def linear(dst: str, src: str) -> None:
        out[f"{dst}.weight"] = sd[f"{src}.weight"]
        out[f"{dst}.bias"] = sd[f"{src}.bias"]

    proj = sd["patch_embed.proj.weight"]
    out["proj.weight"] = proj.reshape(proj.shape[0], -1)
    out["proj.bias"] = sd["patch_embed.proj.bias"]
    linear("text_proj", "patch_embed.text_proj")
    linear("time_embed.w1", "time_embedding.linear_1")
    linear("time_embed.w2", "time_embedding.linear_2")
    # CogVideoX-1.5 ofs conditioning (present only when the checkpoint has it)
    if "ofs_embedding.linear_1.weight" in sd:
        linear("ofs_embed.w1", "ofs_embedding.linear_1")
        linear("ofs_embed.w2", "ofs_embedding.linear_2")
    for i in range(cfg.num_layers):
        src, dst = f"transformer_blocks.{i}", f"blocks.{i}"
        for n in ("norm1", "norm2"):
            linear(f"{dst}.{n}.linear", f"{src}.{n}.linear")
            out[f"{dst}.{n}.ln_scale"] = sd[f"{src}.{n}.norm.weight"]
            out[f"{dst}.{n}.ln_bias"] = sd[f"{src}.{n}.norm.bias"]
        a = f"{src}.attn1"
        for part in ("weight", "bias"):
            out[f"{dst}.attn.qkv.{part}"] = torch.cat(
                [sd[f"{a}.to_{n}.{part}"] for n in ("q", "k", "v")])
        linear(f"{dst}.attn.o", f"{a}.to_out.0")
        for n in ("q", "k"):
            out[f"{dst}.attn.norm_{n}_scale"] = sd[f"{a}.norm_{n}.weight"]
            out[f"{dst}.attn.norm_{n}_bias"] = sd[f"{a}.norm_{n}.bias"]
        linear(f"{dst}.mlp.w1", f"{src}.ff.net.0.proj")
        linear(f"{dst}.mlp.w2", f"{src}.ff.net.2")
    out["norm_final_scale"] = sd["norm_final.weight"]
    out["norm_final_bias"] = sd["norm_final.bias"]
    linear("norm_out", "norm_out.linear")
    out["norm_out_ln_scale"] = sd["norm_out.norm.weight"]
    out["norm_out_ln_bias"] = sd["norm_out.norm.bias"]
    linear("proj_out", "proj_out")
    return out


def dit_config_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: DiTConfig) -> DiTConfig:
    """``cfg`` with the CogVideoX-1.5 fields a converted DiT state dict
    carries: ``ofs_embed_dim`` from ``ofs_embed`` where it holds one, and
    ``patch_size_t`` from the patch embedding's width,
    ``in_channels * pt * p * p`` (None where pt is 1). The other fields,
    which the tensors do not fix, stay ``cfg``'s."""
    def width(name: str, dim: int) -> int:
        t = sd[f"{name}.weight"] if f"{name}.weight" in sd else sd[f"{name}.q"]
        return t.shape[dim]

    ofs = width("ofs_embed.w1", 0) if any(k.startswith("ofs_embed.") for k in sd) else None
    per_frame = cfg.in_channels * cfg.patch_size ** 2
    pt, rem = divmod(width("proj", 1), per_frame)
    if rem or pt < 1:
        raise ValueError(f"patch embedding width {width('proj', 1)} is not a multiple of "
                         f"in_channels * patch_size**2 = {per_frame}")
    return dataclasses.replace(cfg, ofs_embed_dim=ofs, patch_size_t=pt if pt > 1 else None)


def convert_vae_state_dict(sd: Mapping[str, torch.Tensor], cfg: VAEConfig) -> StateDict:
    """Upstream AutoencoderKLCogVideoX state dict -> ``VAE`` state dict."""
    out: StateDict = {}

    def conv(dst: str, src: str) -> None:  # causal conv3d: [out, in, kt, kh, kw]
        out[f"{dst}.weight"] = sd[f"{src}.conv.weight"]
        out[f"{dst}.bias"] = sd[f"{src}.conv.bias"]

    def pointwise(dst: str, src: str) -> None:  # 1x1x1 conv3d -> [out, in]
        w = sd[f"{src}.weight"]
        out[f"{dst}.weight"] = w.reshape(w.shape[0], w.shape[1])
        out[f"{dst}.bias"] = sd[f"{src}.bias"]

    def norm(dst: str, src: str, spatial: bool) -> None:
        base = f"{src}.norm_layer" if spatial else src
        out[f"{dst}.norm_scale"] = sd[f"{base}.weight"]
        out[f"{dst}.norm_bias"] = sd[f"{base}.bias"]
        if spatial:
            pointwise(f"{dst}.conv_y", f"{src}.conv_y.conv")
            pointwise(f"{dst}.conv_b", f"{src}.conv_b.conv")

    def resnet(dst: str, src: str, spatial: bool) -> None:
        norm(f"{dst}.norm1", f"{src}.norm1", spatial)
        conv(f"{dst}.conv1", f"{src}.conv1")
        norm(f"{dst}.norm2", f"{src}.norm2", spatial)
        conv(f"{dst}.conv2", f"{src}.conv2")
        if f"{src}.conv_shortcut.weight" in sd:
            pointwise(f"{dst}.shortcut", f"{src}.conv_shortcut")

    def resample(dst: str, src: str) -> None:  # conv2d [out, in, kh, kw] -> unit time axis
        if f"{src}.weight" in sd:
            out[f"{dst}.weight"] = sd[f"{src}.weight"].unsqueeze(2)
            out[f"{dst}.bias"] = sd[f"{src}.bias"]

    n_blocks = len(cfg.block_out_channels)
    for side in ("encoder", "decoder"):
        conv(f"{side}.conv_in", f"{side}.conv_in")
        conv(f"{side}.conv_out", f"{side}.conv_out")
        for j in range(2):
            resnet(f"{side}.mid.{j}", f"{side}.mid_block.resnets.{j}", side == "decoder")
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}",
                   f"encoder.down_blocks.{i}.resnets.{j}", False)
        resample(f"encoder.down_blocks.{i}.downsampler",
                 f"encoder.down_blocks.{i}.downsamplers.0.conv")
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}",
                   f"decoder.up_blocks.{i}.resnets.{j}", True)
        resample(f"decoder.up_blocks.{i}.upsampler",
                 f"decoder.up_blocks.{i}.upsamplers.0.conv")
    norm("encoder.norm_out", "encoder.norm_out", False)
    norm("decoder.norm_out", "decoder.norm_out", True)
    return out


def save_checkpoint(out_dir: str, dit: StateDict, vae: StateDict, text_embeds) -> None:
    """Write ``<out_dir>/{dit.pt, vae.pt, text_embeds.npy}``. ``text_embeds``
    is the (max_text_seq_length, text_embed_dim) empty-prompt embedding."""
    os.makedirs(out_dir, exist_ok=True)
    torch.save(dict(dit), os.path.join(out_dir, "dit.pt"))
    torch.save(dict(vae), os.path.join(out_dir, "vae.pt"))
    np.save(os.path.join(out_dir, "text_embeds.npy"), np.asarray(text_embeds, np.float32))


def load_state_dicts(ckpt_dir: str) -> Tuple[StateDict, StateDict, np.ndarray]:
    """(dit, vae, text_embeds) of a converted checkpoint, the state dicts on
    the CPU (memory-mapped, ``weights_only``)."""
    def load(name: str) -> StateDict:
        return torch.load(os.path.join(ckpt_dir, name), map_location="cpu",
                          weights_only=True, mmap=True)

    return load("dit.pt"), load("vae.pt"), np.load(os.path.join(ckpt_dir, "text_embeds.npy"))


def load_checkpoint(ckpt_dir: str, cfg: PipelineConfig,
                    device: Optional[torch.device] = None) -> Tuple[DiT, VAE, np.ndarray]:
    """(DiT, VAE, text_embeds) of a converted checkpoint on ``device``, each
    tensor in its saved dtype; a quantized DiT comes back quantized. ``cfg``
    gives the topology, its CogVideoX-1.5 fields read from the checkpoint's
    own tensors (:func:`dit_config_from_state_dict`)."""
    dit_sd, vae_sd, text = load_state_dicts(ckpt_dir)
    dit = dit_from_state_dict(dit_sd, dit_config_from_state_dict(dit_sd, cfg.dit), device)
    with torch.device("meta"):
        vae = VAE(cfg.vae)
    vae.load_state_dict(vae_sd, strict=True, assign=True)
    return dit, (vae if device is None else vae.to(device)), text

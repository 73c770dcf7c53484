"""Causal 3D video VAE (AutoencoderKLCogVideoX equivalent) in PyTorch.

Port of ``aether_tpu/models/vae.py``: 8x spatial / 4x temporal compression, 16
latent channels, temporally causal convolutions whose front padding replicates
the first frame (or the previous chunk's conv cache), first-frame-preserving
temporal down- and upsampling, and the MoVQ spatially modulated GroupNorm (zq
conditioning) in the decoder.

The trunk runs NCTHW with ``torch.nn.functional.conv3d``; the T-major layout
of the JAX trunk was an XLA relayout workaround and is not carried over. The
public functions keep the JAX package's channels-last 5-D contract:
``encode_moments`` takes ``[B, T, H, W, 3]`` and ``decode_frames`` returns it.

Checkpoint numerics are kept: GroupNorm is the shifted single-pass form with
f32 statistics over (T, H, W, C/g) per chunk, conv caches make chunked
processing exact for every convolution, and zq is nearest-resized with the
first-frame split.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aether_tpu_torch.config import VAEConfig
from aether_tpu_torch.ops.groupnorm import groupnorm_moments


class ConvCache:
    """Threads per-conv temporal context across frame chunks: each causal conv
    keeps its last (kt - 1) input frames, keyed by the conv's path, so chunked
    encode/decode equals full-clip processing for every convolution (norm
    statistics stay per chunk, as in the reference's framewise mode)."""

    def __init__(self, cache_in: Optional[Dict[str, torch.Tensor]] = None):
        self.cache_in = cache_in or {}
        self.cache_out: Dict[str, torch.Tensor] = {}


class CausalConv3d(nn.Module):
    """Conv3d with causal temporal padding and zero spatial padding."""

    def __init__(self, cin: int, cout: int, k: Tuple[int, int, int], name: str):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.name = name

    def forward(self, x: torch.Tensor, cache: ConvCache) -> torch.Tensor:
        kt, kh, kw = self.weight.shape[2:]
        if kt > 1:
            prev = cache.cache_in.get(self.name)
            if prev is None:
                front = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1)
            else:
                front = prev.to(x.dtype)
            x = torch.cat([front, x], dim=2)
            cache.cache_out[self.name] = x[:, :, -(kt - 1):]
        return F.conv3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=(0, kh // 2, kw // 2))


class Pointwise(nn.Module):
    """1x1x1 conv as a channel matmul on NCTHW tensors."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.einsum("bcthw,oc->bothw", x, self.weight.to(x.dtype))
        return y + self.bias.to(x.dtype)[:, None, None, None]


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over (T, H, W, C/g) per (batch, group) on NCTHW, with the JAX
    numerics: single-pass moments around c0 (the group's first channel at voxel
    (0, 0, 0)) in f32, applied subtract-first; returns x's dtype. The
    per-channel moments come from K5 (``ops/groupnorm.py``): the Hopper kernel
    on CUDA, its plain version on the CPU."""
    b, c = x.shape[:2]
    cg = c // groups
    first = x[:, :, 0, 0, 0].float()  # [B, C]
    c0 = first.reshape(b, groups, cg)[:, :, :1].expand(b, groups, cg).reshape(b, c)
    m1c, m2c = groupnorm_moments(x, c0)

    def per_group(v):  # [B, C] -> group-uniform [B, C]
        return v.reshape(b, groups, cg).mean(dim=-1, keepdim=True).expand(
            b, groups, cg).reshape(b, c)

    m1, m2 = per_group(m1c), per_group(m2c)
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    gain = torch.rsqrt(var + eps) * scale.float()
    shift = c0 + m1
    out = (x.float() - shift[:, :, None, None, None]) * gain[:, :, None, None, None]
    return (out + bias.float()[:, None, None, None]).to(x.dtype)


def _nearest_resize(z: torch.Tensor, shape: Tuple[int, int, int]) -> torch.Tensor:
    """torch-style nearest resize of NCTHW to (t, h, w): idx = floor(i*in/out)."""
    for axis, out_n in zip((2, 3, 4), shape):
        in_n = z.shape[axis]
        if in_n == out_n:
            continue
        if out_n % in_n == 0:
            z = z.repeat_interleave(out_n // in_n, dim=axis)
        else:
            idx = torch.arange(out_n, device=z.device) * in_n // out_n
            z = z.index_select(axis, idx)
    return z


def _resize_zq(zq: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    """zq nearest resize with the upstream first-frame temporal split."""
    t_zq = zq.shape[2]
    if t_zq > 1 and t % 2 == 1 and t > 1:
        first = _nearest_resize(zq[:, :, :1], (1, h, w))
        rest = _nearest_resize(zq[:, :, 1:], (t - 1, h, w))
        return torch.cat([first, rest], dim=2)
    return _nearest_resize(zq, (t, h, w))


class GroupNorm(nn.Module):
    def __init__(self, ch: int, cfg: VAEConfig):
        super().__init__()
        self.norm_scale = nn.Parameter(torch.empty(ch))
        self.norm_bias = nn.Parameter(torch.empty(ch))
        self.groups, self.eps = cfg.norm_num_groups, cfg.norm_eps

    def forward(self, x, zq=None):
        return group_norm(x, self.norm_scale, self.norm_bias, self.groups, self.eps)


class SpatialNorm(GroupNorm):
    """MoVQ spatial norm: GroupNorm(f) * conv_y(zq) + conv_b(zq). The 1x1x1
    modulators run at latent resolution and are nearest-resized after (the
    two commute exactly)."""

    def __init__(self, ch: int, zq_ch: int, cfg: VAEConfig):
        super().__init__(ch, cfg)
        self.conv_y = Pointwise(zq_ch, ch)
        self.conv_b = Pointwise(zq_ch, ch)

    def forward(self, x, zq=None):
        t, h, w = x.shape[2:]
        y = _resize_zq(self.conv_y(zq), t, h, w)
        b = _resize_zq(self.conv_b(zq), t, h, w)
        return super().forward(x) * y + b


def _silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


class Resnet(nn.Module):
    """CogVideoX 3D resnet block; decoder blocks modulate norms with zq."""

    def __init__(self, cin: int, cout: int, cfg: VAEConfig, zq_ch: Optional[int],
                 path: str):
        super().__init__()

        def norm(ch):
            return GroupNorm(ch, cfg) if zq_ch is None else SpatialNorm(ch, zq_ch, cfg)

        self.norm1 = norm(cin)
        self.conv1 = CausalConv3d(cin, cout, (3, 3, 3), path + "/conv1")
        self.norm2 = norm(cout)
        self.conv2 = CausalConv3d(cout, cout, (3, 3, 3), path + "/conv2")
        self.shortcut = Pointwise(cin, cout) if cin != cout else None

    def forward(self, x, cache: ConvCache, zq=None):
        h = self.conv1(_silu(self.norm1(x, zq)), cache)
        h = self.conv2(_silu(self.norm2(h, zq)), cache)
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class Downsample(nn.Module):
    """Temporal pair-average (first frame kept when odd) + spatial stride-2
    3x3 conv with the asymmetric (0, 1) pad."""

    def __init__(self, ch: int, compress_time: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(ch, ch, 1, 3, 3))
        self.bias = nn.Parameter(torch.empty(ch))
        self.compress_time = compress_time

    def forward(self, x):
        t = x.shape[2]
        if self.compress_time and t > 1:
            if t % 2 == 1:
                rest = (x[:, :, 1::2] + x[:, :, 2::2]) * 0.5
                x = torch.cat([x[:, :, :1], rest], dim=2)
            else:
                x = (x[:, :, 0::2] + x[:, :, 1::2]) * 0.5
        x = F.pad(x, (0, 1, 0, 1))
        return F.conv3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        stride=(1, 2, 2))


class Upsample(nn.Module):
    """Nearest 2x upsample (first-frame-preserving temporally) + 3x3 conv."""

    def __init__(self, ch: int, compress_time: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(ch, ch, 1, 3, 3))
        self.bias = nn.Parameter(torch.empty(ch))
        self.compress_time = compress_time

    def forward(self, x):
        t = x.shape[2]
        if self.compress_time and t > 1:
            if t % 2 == 1:
                x = torch.cat([x[:, :, :1], x[:, :, 1:].repeat_interleave(2, dim=2)],
                              dim=2)
            else:
                x = x.repeat_interleave(2, dim=2)
        x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        return F.conv3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=(0, 1, 1))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        self.conv_in = CausalConv3d(cfg.in_channels, chs[0], (3, 3, 3), "enc/conv_in")
        self.down_blocks = nn.ModuleList()
        ch_in = chs[0]
        for i, ch_out in enumerate(chs):
            block = nn.Module()
            block.resnets = nn.ModuleList(
                Resnet(ch_in if j == 0 else ch_out, ch_out, cfg, None,
                       f"enc/down{i}/res{j}")
                for j in range(cfg.layers_per_block))
            block.downsampler = (Downsample(ch_out, i < cfg.temporal_compress_level)
                                 if i < len(chs) - 1 else None)
            self.down_blocks.append(block)
            ch_in = ch_out
        self.mid = nn.ModuleList(Resnet(chs[-1], chs[-1], cfg, None, f"enc/mid{j}")
                                 for j in range(2))
        self.norm_out = GroupNorm(chs[-1], cfg)
        self.conv_out = CausalConv3d(chs[-1], 2 * cfg.latent_channels, (3, 3, 3),
                                     "enc/conv_out")


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        lat = cfg.latent_channels
        self.conv_in = CausalConv3d(lat, rev[0], (3, 3, 3), "dec/conv_in")
        self.mid = nn.ModuleList(Resnet(rev[0], rev[0], cfg, lat, f"dec/mid{j}")
                                 for j in range(2))
        self.up_blocks = nn.ModuleList()
        ch_in = rev[0]
        for i, ch_out in enumerate(rev):
            block = nn.Module()
            block.resnets = nn.ModuleList(
                Resnet(ch_in if j == 0 else ch_out, ch_out, cfg, lat,
                       f"dec/up{i}/res{j}")
                for j in range(cfg.layers_per_block + 1))
            block.upsampler = (Upsample(ch_out, i < cfg.temporal_compress_level)
                               if i < len(rev) - 1 else None)
            self.up_blocks.append(block)
            ch_in = ch_out
        self.norm_out = SpatialNorm(rev[-1], lat, cfg)
        self.conv_out = CausalConv3d(rev[-1], cfg.out_channels, (3, 3, 3),
                                     "dec/conv_out")


class VAE(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)


def encode_moments(
    vae: VAE,
    video: torch.Tensor,
    cache_in: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Encoder trunk: [B, T, H, W, 3] -> (mean, logvar [B, T', h, w, C],
    conv_cache_out)."""
    enc = vae.encoder
    cache = ConvCache(cache_in)
    x = enc.conv_in(video.permute(0, 4, 1, 2, 3), cache)
    for block in enc.down_blocks:
        for rn in block.resnets:
            x = rn(x, cache)
        if block.downsampler is not None:
            x = block.downsampler(x)
    for rn in enc.mid:
        x = rn(x, cache)
    x = enc.conv_out(_silu(enc.norm_out(x)), cache)
    mean, logvar = x.permute(0, 2, 3, 4, 1).chunk(2, dim=-1)
    return mean, logvar, cache.cache_out


def decode_frames(
    vae: VAE,
    latents: torch.Tensor,
    cache_in: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decoder trunk: [B, T_lat, h, w, C_lat] -> (video [B, T, H, W, 3],
    conv_cache_out). zq is the chunk's own latents."""
    dec = vae.decoder
    cache = ConvCache(cache_in)
    zq = latents.permute(0, 4, 1, 2, 3)
    x = dec.conv_in(zq, cache)
    for rn in dec.mid:
        x = rn(x, cache, zq)
    for block in dec.up_blocks:
        for rn in block.resnets:
            x = rn(x, cache, zq)
        if block.upsampler is not None:
            x = block.upsampler(x)
    x = dec.conv_out(_silu(dec.norm_out(x, zq)), cache)
    return x.permute(0, 2, 3, 4, 1), cache.cache_out


@torch.no_grad()
def init_vae(cfg: VAEConfig, *, device="cpu", dtype=torch.float32,
             seed: int = 1) -> VAE:
    """Seeded random VAE on ``device`` with the JAX init's distributions: conv
    weights and biases uniform(+-1/sqrt(fan_in)), norm scales 1, biases 0."""
    with torch.device("meta"):
        model = VAE(cfg).to(dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (CausalConv3d, Pointwise, Downsample, Upsample)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            mod.weight.uniform_(-bound, bound, generator=gen)
            mod.bias.uniform_(-bound, bound, generator=gen)
        if isinstance(mod, GroupNorm):
            mod.norm_scale.fill_(1.0)
            mod.norm_bias.zero_()
    return model

"""AetherV1 pipeline, three tasks, in PyTorch.

Port of ``aether_tpu/pipeline/aether.py`` (``AetherPipeline.__call__``):
uint8 upload -> tiled, 8-frame-chunked VAE encode of the conditions with
latent-space feathered seams and one posterior draw each -> condition packing
(16 content + 24 camera channels: zeros, or the packed raymap) ->
SDE-DPM-Solver++(2M) denoise of the DiT, with a batch-2 ``[uncond, cond]``
CFG pair when the guidance exceeds 1 -> stacked RGB + disparity VAE decode in
2-latent-frame chunks, tiled with pixel-space seams -> RGB clip, disparity
square, raymap unfold.

Per task (reference ``pipeline:256-272, 839-855``): reconstruction encodes a
video (4 steps, guidance 1); prediction encodes one image into the first
latent frame (50 steps, guidance 3, dynamic CFG; the uncond stream zeroes that
frame's content); planning encodes an image and a goal into the first and
last latent frames (50 steps, guidance 3, dynamic CFG; the uncond stream
zeroes all content channels).

The port runs eagerly: the denoise loop is a Python loop over steps, the DiT a
loop over blocks. Every random draw goes through a noise source
(:class:`TorchNoise` by default, a ``torch.Generator`` on the pipeline's
device), which tests replace with the JAX pipeline's key streams.

``batch_reconstruct`` runs B reconstruction windows through one DiT denoise
at batch B, every window with the noise stream of a serial call with the
same seed (one draw broadcast over the batch); the VAE encodes and decodes
them window by window.

A quantized DiT (``models.dit.quantize_dit`` / ``init_quantized_dit``) runs
as it is; ``act_quant=True`` gives its int8 codes int8 activations (w8a8), as
the JAX pipeline's ``act_quant`` does.

Each stage runs inside a ``utils.profiling.stage_timer`` under the JAX
pipeline's stage name (``vae_encode``, ``denoise``, ``vae_decode``), so a
front-end's stage listeners see it; ``stage_seconds`` keeps the short keys.

With a mesh (``AetherPipeline(..., mesh=parallel.make_mesh(...))``, one
process per card, every rank running the same calls with the same seed): the
DiT is split by ``parallel.shard_params`` (tp) and runs its batch rows and
token stripes by itself (dp, sp); the VAE is whole on every rank; the CFG
pair's batch rides dp inside the DiT; the windows of ``batch_reconstruct``
ride dp through the encode and the DiT (a short batch padded to a dp
multiple by repeating its last window); the stacked RGB + disparity decode
rides dp where dp divides its 2B streams. Every rank ends with the whole
outputs.

The outputs reach the host through a wire (JAX ``compact_transfer``): on a
card the decoded RGB moves as uint8 codes (``wire_rgb="yuv420"``: BT.601
4:2:0, 1.5 bytes a pixel), the disparity as fp16 (``wire_disparity="u8"``:
its square root in 8 bits), the raymap as f32; on the CPU, or with
``compact_transfer=False``, everything moves as f32. ``wire_input="yuv420"``
packs the uint8 pixels on the host and unpacks them on the device.
``defer_host=True`` returns a :class:`DeferredOutput` as soon as the call's
work is queued: the copies to the host ride a stream of their own into pinned
buffers, ordered after the decode by an event, and ``resolve()`` waits for
them and builds the outputs. No stage then ends in a synchronize, so
``stage_seconds`` holds host enqueue seconds (as the JAX timers do).
:func:`iter_resolved` keeps one such dispatch in flight ahead of its
consumer. The CFG prefix skip is not ported (ROADMAP.md, "Do not port").
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from aether_tpu_torch.config import PipelineConfig
from aether_tpu_torch.models.dit import DiT, all_gather_cat
from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings
from aether_tpu_torch.models.vae import VAE, decode_frames, encode_moments
from aether_tpu_torch.schedule.dpm import (
    SamplingPlan,
    dpm_step,
    make_sampling_plan,
    set_timesteps,
)
from aether_tpu_torch.utils.preprocess import preprocess_image_u8, preprocess_video_u8
from aether_tpu_torch.utils.profiling import (
    has_stage_listeners,
    notify_stage_progress,
    stage_timer,
)


@dataclasses.dataclass
class AetherPipelineOutput:
    rgb: np.ndarray  # (F, H, W, 3) in [0, 1]
    disparity: np.ndarray  # (F, H, W)
    raymap: np.ndarray  # (F, 6, H/8, W/8)
    # host-clock seconds per stage (encode, denoise, decode), each ended by a
    # device synchronize; under ``defer_host`` the seconds to queue the stage
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


class DeferredOutput:
    """A pipeline output whose device->host copies have been started but not
    waited for. ``resolve()`` waits for them and returns the
    :class:`AetherPipelineOutput` (a list of them for ``batch_reconstruct``);
    it is idempotent. A window loop can queue window i+1's work before it
    pays for window i's transfer (JAX ``DeferredOutput``)."""

    def __init__(self, resolve_fn):
        self._resolve_fn = resolve_fn
        self._result = None

    def resolve(self):
        if self._result is None:
            self._result = self._resolve_fn()
            self._resolve_fn = None
        return self._result


def iter_resolved(dispatches):
    """Pipelined resolve over zero-argument callables, each dispatching one
    pipeline call (``defer_host=True``) and returning a
    :class:`DeferredOutput` or a plain output. Yields the resolved outputs in
    order while one dispatch is always in flight ahead of the consumer: call
    i+1's device work overlaps call i's host transfer and whatever the
    consumer does between ``next()`` calls (JAX ``iter_resolved``)."""
    pending = None
    for make in dispatches:
        out = make()
        if pending is not None:
            yield pending.resolve() if hasattr(pending, "resolve") else pending
        pending = out
    if pending is not None:
        yield pending.resolve() if hasattr(pending, "resolve") else pending


class TorchNoise:
    """The pipeline's own draws: one ``torch.Generator`` on the device, seeded
    per call, consumed in a fixed order (posterior, then the goal's posterior
    for planning, initial, then one SDE draw per step), so equal seeds give
    equal outputs. ``batch_reconstruct`` asks for one window's shapes (a
    leading 1) in the same order and broadcasts each draw over the windows,
    so a batch of windows sees the noise of a serial call per window."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def _normal(self, shape):
        return torch.randn(tuple(shape), generator=self.gen, device=self.device,
                           dtype=torch.float32)

    def posterior(self, shape):
        """Channels-last (1, F_lat, h, w, C) posterior noise of the video or
        image condition."""
        return self._normal(shape)

    def goal(self, shape):
        """Channels-last (1, 1, h, w, C) posterior noise of planning's goal."""
        return self._normal(shape)

    def initial(self, shape):
        """(1, F_lat, 56, h, w) initial latent noise."""
        return self._normal(shape)

    def sde(self, step: int, shape):
        """(1, F_lat, 56, h, w) SDE noise of denoise step ``step``."""
        return self._normal(shape)


# the stage names the stage listeners see: the JAX pipeline's (its
# ``stage_timer`` calls), where ``stage_seconds`` keeps the port's short keys
_LISTENER_NAMES = {"encode": "vae_encode", "denoise": "denoise", "decode": "vae_decode"}


@contextlib.contextmanager
def _stage(name: str, times: Dict[str, float], device: torch.device, sync: bool = True):
    """Time one pipeline stage on the host clock, ended by a device
    synchronize unless ``sync`` is False (``defer_host``: the seconds to
    queue it), inside a profiler range ``aether.<name>`` (free unless a
    profiler is running) and a ``stage_timer`` under the JAX stage name,
    which tells the stage listeners where it begins and ends."""
    with torch.profiler.record_function(f"aether.{name}"), \
            stage_timer(_LISTENER_NAMES[name], log=False):
        t0 = time.perf_counter()
        yield
        if sync and device.type == "cuda":
            torch.cuda.synchronize(device)
        times[name] = time.perf_counter() - t0


def _upload(array, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. A card gets it through pinned memory and
    an asynchronous copy: a copy from pageable memory synchronizes the
    stream, which would wait for all the work queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _u8_to_unit(pixels_u8: np.ndarray, dtype, device) -> torch.Tensor:
    """uint8 pixels -> [-1, 1] on the device (the upload moves uint8)."""
    return _upload(pixels_u8, torch.device(device)).to(dtype) / 127.5 - 1.0


# Full-range BT.601 coefficients of the four yuv420 wire codecs (the JAX
# package's; device/host x pack/unpack stay exact inverses of each other)
_YR, _YG, _YB = 0.299, 0.587, 0.114
_CB_SCALE, _CR_SCALE = 0.564, 0.713


def _to_u8(v: torch.Tensor) -> torch.Tensor:
    """[0, 1] f32 -> uint8 codes, rounded half to even (``jnp.round``)."""
    return torch.round(torch.clamp(v, 0.0, 1.0) * 255.0).to(torch.uint8)


def _subsample(c: torch.Tensor) -> torch.Tensor:
    """2x2 mean over the last two axes."""
    *lead, h, w = c.shape
    return c.reshape(*lead, h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def _rgb_to_yuv420_wire(rgb01: torch.Tensor):
    """[..., H, W, 3] in [0, 1] -> (Y u8 [..., H, W], Cb, Cr u8 [..., H/2,
    W/2]) on the device: full-range BT.601 with 2x2-averaged chroma, 1.5
    bytes a pixel on the D2H wire (JAX ``_rgb_to_yuv420_wire``). H and W
    must be even."""
    rf, gf, bf = (rgb01[..., i].float() for i in range(3))
    y = _YR * rf + _YG * gf + _YB * bf
    cb = (bf - y) * _CB_SCALE + 0.5
    cr = (rf - y) * _CR_SCALE + 0.5
    return _to_u8(y), _to_u8(_subsample(cb)), _to_u8(_subsample(cr))


def _yuv420_wire_to_rgb(y_u8, cb_u8, cr_u8) -> np.ndarray:
    """Host inverse of :func:`_rgb_to_yuv420_wire` -> f32 RGB in [0, 1]
    (JAX ``_yuv420_wire_to_rgb``)."""
    y = np.asarray(y_u8).astype(np.float32) / 255.0
    cb = np.asarray(cb_u8).astype(np.float32) / 255.0 - 0.5
    cr = np.asarray(cr_u8).astype(np.float32) / 255.0 - 0.5
    cb = cb.repeat(2, axis=-2).repeat(2, axis=-1)
    cr = cr.repeat(2, axis=-2).repeat(2, axis=-1)
    r = y + cr / _CR_SCALE
    b = y + cb / _CB_SCALE
    g = (y - _YR * r - _YB * b) / _YG
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def _rgb_u8_to_yuv420_host(pixels_u8: np.ndarray):
    """Host pack for the H2D wire: (..., H, W, 3) u8 -> (Y, Cb, Cr) u8 numpy,
    :func:`_rgb_to_yuv420_wire` on the CPU (bit for bit JAX's numpy
    ``_rgb_u8_to_yuv420_host``)."""
    rgb01 = torch.from_numpy(np.ascontiguousarray(pixels_u8)).float() / 255.0
    return tuple(t.numpy() for t in _rgb_to_yuv420_wire(rgb01))


def _yuv420_to_unit(y_u8: torch.Tensor, cb_u8: torch.Tensor, cr_u8: torch.Tensor,
                    dtype) -> torch.Tensor:
    """Device unpack of the H2D yuv420 wire -> [-1, 1] RGB (..., H, W, 3),
    the chroma upsampled nearest (JAX ``_yuv420_to_unit``)."""
    y = y_u8.float() / 255.0
    cb = cb_u8.float() / 255.0 - 0.5
    cr = cr_u8.float() / 255.0 - 0.5

    def up(c):
        *lead, h2, w2 = c.shape
        return c[..., :, None, :, None].expand(*lead, h2, 2, w2, 2).reshape(
            *lead, h2 * 2, w2 * 2)

    cb, cr = up(cb), up(cr)
    r = y + cr / _CR_SCALE
    b = y + cb / _CB_SCALE
    g = (y - _YR * r - _YB * b) / _YG
    rgb01 = torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)
    return (rgb01 * 2.0 - 1.0).to(dtype)


def dynamic_cfg_schedule(timesteps: np.ndarray, num_inference_steps: int,
                         guidance_scale: float) -> np.ndarray:
    """Reference dynamic-CFG ramp, evaluated per *timestep value* in float64.

    1 + g * (1 - cos(pi * ((steps - t)/steps)^5)) / 2 -- reference
    ``pipeline:879-893`` uses ``t.item()`` (the 0..999 timestep, not the
    index), which makes the exponent huge and the scale jump around [1, 1+g]
    rather than ramp. That quirk is the checkpoint's sampler and is kept.
    Copy of ``aether_tpu/pipeline/aether.py::dynamic_cfg_schedule``."""
    out = np.zeros(len(timesteps), dtype=np.float64)
    for i, t in enumerate(timesteps):
        frac = (num_inference_steps - float(int(t))) / num_inference_steps
        out[i] = 1.0 + guidance_scale * (1.0 - math.cos(math.pi * frac**5.0)) / 2.0
    return out.astype(np.float32)


def pack_raymap(raymap: torch.Tensor, temporal_ratio: int = 4) -> torch.Tensor:
    """(B, F, 6, h, w) -> (B, F/4, 24, h, w) via the strided "(n t) c -> t (n c)"
    fold; front-pads by repeating the first frames when F % 4 != 0."""
    b, f = raymap.shape[:2]
    if f % temporal_ratio != 0:
        pad = temporal_ratio - f % temporal_ratio
        raymap = torch.cat([raymap[:, :pad], raymap], dim=1)
        f = f + pad
    t = f // temporal_ratio
    x = raymap.reshape(b, temporal_ratio, t, *raymap.shape[2:])
    x = x.movedim(1, 2)
    return x.reshape(b, t, temporal_ratio * raymap.shape[2], *raymap.shape[3:])


def unpack_raymap(camera_latents: torch.Tensor, num_frames: int) -> torch.Tensor:
    """(B, T, 24, h, w) -> (B, F, 6, h, w): inverse fold, keep the last F frames."""
    b, t, nc, h, w = camera_latents.shape
    n = 4
    x = camera_latents.reshape(b, t, n, nc // n, h, w).movedim(2, 1)
    return x.reshape(b, n * t, nc // n, h, w)[:, -num_frames:]


def _chunk_bounds(t: int, frame_batch_size: int):
    """Chunk spans of diffusers' framewise mode: the first chunk absorbs the
    remainder."""
    n_chunks = max(t // frame_batch_size, 1)
    remaining = t % frame_batch_size if t > frame_batch_size else 0
    start = 0
    for i in range(n_chunks):
        end = min(frame_batch_size + remaining if i == 0 else
                  start + frame_batch_size, t)
        yield start, end
        start = end


def _encode_moments_chunked(vae: VAE, video: torch.Tensor,
                            frame_batch_size: int = 8):
    """(B, F, H, W, 3) in [-1, 1] -> channels-last (mean, logvar), 8-frame
    chunks with conv caches (per-chunk GroupNorm statistics are the
    checkpoint's numerics)."""
    means, logvars, cache = [], [], None
    for start, end in _chunk_bounds(video.shape[1], frame_batch_size):
        mean, logvar, cache = encode_moments(vae, video[:, start:end], cache)
        means.append(mean)
        logvars.append(logvar)
    return torch.cat(means, dim=1), torch.cat(logvars, dim=1)


def _finish_encode(config: PipelineConfig, dtype, mean, logvar,
                   noise: Optional[torch.Tensor]) -> torch.Tensor:
    """Posterior sample + latent scaling -> (B, F_lat, C, h, w)."""
    if noise is not None:
        logvar = torch.clamp(logvar.float(), -30.0, 20.0)
        lat = mean.float() + torch.exp(0.5 * logvar) * noise
    else:
        lat = mean.float()
    lat = lat.movedim(-1, 2)
    scale = config.vae.scaling_factor
    if config.vae.invert_scale_latents:
        return (lat / scale).to(dtype)
    return (lat * scale).to(dtype)


def _tile_spans(n: int, tile: int, min_overlap: int) -> list:
    """Uniform-size tile spans covering [0, n) with >= min_overlap overlap."""
    if n <= tile:
        return [(0, n)]
    count = math.ceil((n - tile) / (tile - min_overlap)) + 1
    stride = (n - tile) / (count - 1)
    return [
        (min(int(round(i * stride)), n - tile),
         min(int(round(i * stride)), n - tile) + tile)
        for i in range(count)
    ]


def _feather(prev: torch.Tensor, curr: torch.Tensor, prev_end: int,
             span: Tuple[int, int], axis: int) -> torch.Tensor:
    """Stitch ``curr`` (covering span) onto ``prev`` (covering [0, prev_end))
    along ``axis`` with a linear cross-fade over the overlap."""
    start, end = span
    overlap = prev_end - start
    w_shape = [1] * prev.ndim
    w_shape[axis] = overlap
    weight = torch.linspace(1.0, 0.0, overlap, device=prev.device).reshape(
        w_shape).to(prev.dtype)
    blended = (prev.narrow(axis, start, overlap) * weight
               + curr.narrow(axis, 0, overlap) * (1.0 - weight))
    return torch.cat([prev.narrow(axis, 0, start), blended,
                      curr.narrow(axis, overlap, end - start - overlap)], dim=axis)


def _tiled_moments(config: PipelineConfig, vae: VAE, video: torch.Tensor,
                   frame_batch_size: int, tile_latent: Tuple[int, int],
                   min_overlap: Tuple[int, int]):
    """Spatially tiled moment encode with latent-space feathered seams;
    None when one tile covers the frame."""
    s = config.vae_scale_factor_spatial
    h, w = video.shape[2:4]
    row_spans = _tile_spans(h // s, tile_latent[0], min_overlap[0])
    col_spans = _tile_spans(w // s, tile_latent[1], min_overlap[1])
    if len(row_spans) == 1 and len(col_spans) == 1:
        return None
    merged, rows_prev_end = None, 0
    for r0, r1 in row_spans:
        row, prev_end = None, 0
        for c0, c1 in col_spans:
            tile = video[:, :, r0 * s:r1 * s, c0 * s:c1 * s]
            moments = _encode_moments_chunked(vae, tile, frame_batch_size)
            row = moments if row is None else tuple(
                _feather(a, b, prev_end, (c0, c1), axis=3)
                for a, b in zip(row, moments))
            prev_end = c1
        merged = row if merged is None else tuple(
            _feather(a, b, rows_prev_end, (r0, r1), axis=2)
            for a, b in zip(merged, row))
        rows_prev_end = r1
    return merged


def _dp_rows(mesh, n: int):
    """(this dp rank's rows of a batch of ``n``, the dp group) when the
    mesh's dp axis (> 1) divides ``n``; None otherwise (every rank runs the
    whole batch)."""
    if mesh is None:
        return None
    from aether_tpu_torch.parallel.mesh import axis_rank, axis_size

    dp = axis_size(mesh, "dp")
    if dp <= 1 or n % dp:
        return None
    m, r = n // dp, axis_rank(mesh, "dp")
    return slice(r * m, (r + 1) * m), mesh.get_group("dp")


def _encode_pixels(config: PipelineConfig, dtype, vae: VAE, frames: torch.Tensor,
                   draw, tiling: bool, **kw) -> torch.Tensor:
    """One window's encode: (F, H, W, 3) -> (1, F_lat, C, h, w), as
    :func:`_encode_windows`."""
    return _encode_windows(config, dtype, vae, frames[None], draw, tiling, **kw)


def _encode_windows(config: PipelineConfig, dtype, vae: VAE, video: torch.Tensor,
                    draw, tiling: bool, frame_batch_size: int = 8,
                    tile_latent: Tuple[int, int] = (32, 90),
                    min_overlap: Tuple[int, int] = (4, 6), mesh=None) -> torch.Tensor:
    """Encode of (B, F, H, W, 3) in [-1, 1] -> scaled (B, F_lat, C, h, w):
    per window, 8-frame chunks, tiled with feathered latent seams when
    ``tiling`` (and more than one tile covers the frame); then ONE posterior
    draw over the blended moments (the untiled path's noise shape), drawn for
    one window and shared by the batch (JAX ``_finish_encode_keys`` with one
    key for every window). ``draw(shape)`` gives the posterior noise;
    ``draw=None`` returns the posterior mean.

    The windows are encoded one at a time, where the JAX package stacks them
    on the VAE's batch axis: on one H100 a batch-2 encode is no faster than
    two batch-1 encodes, and cuDNN picks other algorithms (and output
    layouts) at batch 2, so one window at a time gives each window the
    moments of a serial call bit for bit. Under a mesh whose dp axis divides
    B, each dp rank encodes its windows and the moments are gathered before
    the draw (JAX: the window batch sharded over dp, :477, :549)."""
    split = _dp_rows(mesh, video.shape[0])
    means, logvars = [], []
    for window in (video if split is None else video[split[0]]):
        moments = None
        if tiling:
            moments = _tiled_moments(config, vae, window[None], frame_batch_size,
                                     tile_latent, min_overlap)
        if moments is None:
            moments = _encode_moments_chunked(vae, window[None], frame_batch_size)
        means.append(moments[0])
        logvars.append(moments[1])
    mean, logvar = torch.cat(means), torch.cat(logvars)
    if split is not None:
        mean, logvar = (all_gather_cat(t, 0, split[1]) for t in (mean, logvar))
    noise = None if draw is None else _draw(draw, mean.shape, True)
    return _finish_encode(config, dtype, mean, logvar, noise)


def _decode_pixels(config: PipelineConfig, dtype, vae: VAE,
                   latents_16: torch.Tensor, frame_batch_size: int = 2) -> torch.Tensor:
    """(B, F_lat, C, h, w) scaled latents -> (B, F, H, W, 3) in ``dtype``;
    2-latent-frame chunks with conv caches and per-chunk statistics."""
    z = (latents_16.float() / config.vae.scaling_factor).movedim(2, -1)
    outs, cache = [], None
    for start, end in _chunk_bounds(z.shape[1], frame_batch_size):
        video, cache = decode_frames(vae, z[:, start:end].to(dtype), cache)
        outs.append(video)
    return torch.cat(outs, dim=1)


def _decode_pixels_tiled(config: PipelineConfig, dtype, vae: VAE,
                         latents_16: torch.Tensor, frame_batch_size: int = 2,
                         tile_latent: Tuple[int, int] = (32, 90),
                         min_overlap: Tuple[int, int] = (4, 6)) -> torch.Tensor:
    """Spatially tiled decode, seams feather-blended in pixel space."""
    s = config.vae_scale_factor_spatial
    h_lat, w_lat = latents_16.shape[-2:]
    row_spans = _tile_spans(h_lat, tile_latent[0], min_overlap[0])
    col_spans = _tile_spans(w_lat, tile_latent[1], min_overlap[1])
    merged_rows, rows_prev_end = None, 0
    for r0, r1 in row_spans:
        merged, prev_end = None, 0
        for c0, c1 in col_spans:
            tile = _decode_pixels(config, dtype, vae,
                                  latents_16[:, :, :, r0:r1, c0:c1],
                                  frame_batch_size)
            merged = tile if merged is None else _feather(
                merged, tile, prev_end * s, (c0 * s, c1 * s), axis=3)
            prev_end = c1
        merged_rows = merged if merged_rows is None else _feather(
            merged_rows, merged, rows_prev_end * s, (r0 * s, r1 * s), axis=2)
        rows_prev_end = r1
    return merged_rows


def _decode_rgb_and_disparity(config: PipelineConfig, dtype, vae: VAE,
                              latents: torch.Tensor, tiling: bool, mesh=None):
    """RGB and disparity 16-channel streams decoded as ONE batch-2B pass.
    Under a mesh whose dp axis divides 2B, each dp rank decodes its streams
    (at dp = 2 and B = 1, RGB on one rank and disparity on the other) and the
    ranks gather them (JAX :914-921). Returns (rgb, disparity_raw), each
    (B, F, H, W, 3) in ``dtype``."""
    lat_c = config.vae.latent_channels
    b = latents.shape[0]
    both = torch.cat([latents[:, :, :lat_c], latents[:, :, lat_c:2 * lat_c]], dim=0)
    decode = _decode_pixels_tiled if tiling else _decode_pixels
    split = _dp_rows(mesh, 2 * b)
    if split is None:
        out = decode(config, dtype, vae, both)
    else:
        out = all_gather_cat(decode(config, dtype, vae, both[split[0]]), 0, split[1])
    return out[:b], out[b:]


def _finish_rgb(rgb_decoded: torch.Tensor, mode: str) -> tuple:
    """Decoded RGB -> its wire: clip to [0, 1], then (y, cb, cr) u8 for
    ``"yuv420"``, (u8,) for ``"u8"``, (f32,) otherwise (JAX ``_finish_rgb``)."""
    rgb01 = torch.clamp(rgb_decoded.float() * 0.5 + 0.5, 0.0, 1.0)
    if mode == "yuv420":
        return _rgb_to_yuv420_wire(rgb01)
    if mode == "u8":
        return (torch.round(rgb01 * 255.0).to(torch.uint8),)
    return (rgb01,)


def _finish_disparity(disp_decoded: torch.Tensor, mode: str) -> torch.Tensor:
    """Decoded disparity -> its wire: channel mean, affine, square (f32, or
    fp16 for ``"fp16"``), or for ``"u8"`` the pre-square value in 8 bits
    (JAX ``_finish_disparity``)."""
    ds = disp_decoded.float().mean(dim=-1) * 0.5 + 0.5
    if mode == "u8":
        return _to_u8(ds)
    d = torch.square(ds)
    return d.half() if mode == "fp16" else d


class _HostCopies:
    """The device->host copies of a call's wire tensors. On a card they run
    on the pipeline's copy stream into pinned buffers of its pool, after an
    event recorded behind the decode on the current stream; each source is
    marked used by the copy stream (``record_stream``) and kept until
    :meth:`arrays` returns, so that the allocator cannot hand its memory to
    the next call while the copy reads it. On the CPU the tensors are the
    host arrays."""

    def __init__(self, tensors: list, pool: "_PinnedPool"):
        self._pool, self._src, self._bufs, self.event = pool, tensors, None, None
        if not tensors or tensors[0].device.type != "cuda":
            return
        dev = tensors[0].device
        decoded = torch.cuda.Event()
        decoded.record(torch.cuda.current_stream(dev))
        stream = pool.stream(dev)
        stream.wait_event(decoded)
        self._bufs = []
        with torch.cuda.stream(stream):
            for t in tensors:
                buf = pool.acquire(t.shape, t.dtype)
                buf.copy_(t, non_blocking=True)
                t.record_stream(stream)
                self._bufs.append(buf)
        self.event = torch.cuda.Event()
        self.event.record(stream)

    def arrays(self) -> list:
        """The host arrays (views of the pinned buffers on a card: copy what
        you keep before :meth:`release`)."""
        if self.event is None:
            return [t.numpy() for t in self._src]
        self.event.synchronize()
        return [b.numpy() for b in self._bufs]

    def release(self) -> None:
        """Hand the pinned buffers back to the pool and drop the sources."""
        for buf in self._bufs or ():
            self._pool.release(buf)
        self._src = self._bufs = None


class _PinnedPool:
    """Pinned host buffers by (shape, dtype), allocated once and reused call
    after call (two are out at once while one deferred call is resolved and
    the next is in flight), and the copy stream of each card."""

    def __init__(self):
        self._free: Dict[tuple, list] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def stream(self, device: torch.device):
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def acquire(self, shape, dtype) -> torch.Tensor:
        free = self._free.get((tuple(shape), dtype))
        if free:
            return free.pop()
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)

    def release(self, buf: torch.Tensor) -> None:
        self._free.setdefault((tuple(buf.shape), buf.dtype), []).append(buf)


def _host_output(rgb, disparity, raymap, rgb_mode: str, disp_mode: str,
                 times: Dict[str, float]) -> AetherPipelineOutput:
    """One window's host output from its wire arrays, as JAX ``_resolve``
    builds it: u8 codes / 255 in f32, yuv420 unpacked on the host, u8
    disparity squared after / 255; every array a copy of its wire."""
    if rgb_mode == "yuv420":
        rgb_np = _yuv420_wire_to_rgb(*rgb)
    elif rgb_mode == "u8":
        rgb_np = rgb[0].astype(np.float32) / 255.0
    else:
        rgb_np = np.array(rgb[0], dtype=np.float32)
    disp_np = disparity.astype(np.float32)
    if disp_mode == "u8":
        disp_np = np.square(disp_np / 255.0)
    return AetherPipelineOutput(rgb=rgb_np.astype(np.float32, copy=False), disparity=disp_np,
                                raymap=np.array(raymap, dtype=np.float32),
                                stage_seconds=times)


def _draw(draw, shape, broadcast: bool) -> torch.Tensor:
    """One draw of ``shape``, or, with ``broadcast``, one batch element's draw
    broadcast over the batch (JAX ``broadcast_noise``, :1104-1114)."""
    if not broadcast:
        return draw(shape)
    return draw((1, *shape[1:])).expand(shape)


def _denoise(config: PipelineConfig, dtype, dit: DiT, text: torch.Tensor,
             condition_latents: torch.Tensor, plan: SamplingPlan,
             rope_cos: torch.Tensor, rope_sin: torch.Tensor, noise_source,
             task: str, guidance: Optional[torch.Tensor],
             broadcast_noise: bool = False, act_quant: bool = False,
             sync: bool = True) -> torch.Tensor:
    """SDE-DPM-Solver++(2M) loop (JAX ``_denoise_segment``, :1010-1050).
    Latents are carried in the compute dtype, ``old_x0`` in f32.

    ``guidance`` (per-step f32 scales on the device) runs classifier-free
    guidance: the DiT takes the batch-2 pair ``[uncond, cond]``, where the
    uncond condition zeroes the content channels of every frame (planning)
    or of the first latent frame (prediction), and ``uncond + g_i * (cond -
    uncond)`` is formed in f32. ``None`` runs the condition alone.
    ``broadcast_noise`` draws the initial and SDE noise for one batch element
    and broadcasts it, so every window of a batch gets the noise stream of a
    serial call with the same seed. ``act_quant`` reaches the DiT (w8a8
    where its codes are int8). With a stage listener registered, each step
    ends with ``notify_stage_progress("denoise", (i + 1) / n)``, after a
    device synchronize unless ``sync`` is False (``defer_host``: the event
    then marks the step's enqueue); without one, nothing. Returns (B, F_lat,
    56, h, w)."""
    b, f_lat, _, h_lat, w_lat = condition_latents.shape
    shape = (b, f_lat, 56, h_lat, w_lat)
    lat = (_draw(noise_source.initial, shape, broadcast_noise)
           * plan.init_noise_sigma).to(dtype)
    old_x0 = torch.zeros(shape, dtype=torch.float32, device=lat.device)
    latent_condition = condition_latents
    if guidance is not None:
        lat_c = config.vae.latent_channels
        uncond = condition_latents.clone()
        if task == "planning":
            uncond[:, :, :lat_c] = 0.0
        elif task == "prediction":
            uncond[:, :1, :lat_c] = 0.0
        latent_condition = torch.cat([uncond, condition_latents], dim=0)
    n = latent_condition.shape[0]
    text = text.expand(n, *text.shape[1:])
    for i in range(plan.num_steps):
        model_in = lat if guidance is None else torch.cat([lat, lat], dim=0)
        model_in = torch.cat([model_in, latent_condition], dim=2)
        t_batch = plan.timesteps[i].expand(n)
        noise_pred = dit(model_in, text, t_batch, rope_cos, rope_sin,
                         act_quant=act_quant).float()
        if guidance is not None:
            uncond_pred, cond_pred = noise_pred.chunk(2, dim=0)
            noise_pred = uncond_pred + guidance[i] * (cond_pred - uncond_pred)
        sde_noise = _draw(lambda shp: noise_source.sde(i, shp), shape, broadcast_noise)
        new_lat, old_x0 = dpm_step(plan, i, lat.float(), noise_pred, old_x0,
                                   sde_noise)
        lat = new_lat.to(dtype)
        _step_progress(lat, i + 1, plan.num_steps, sync)
    return lat


def _step_progress(lat: torch.Tensor, done: int, total: int, sync: bool = True) -> None:
    """Live step progress for a front-end (JAX ``_denoise``, :1153-1166, one
    event a segment): only when a stage listener is registered, since the
    event waits for the step on the device (unless ``sync`` is False);
    otherwise nothing."""
    if not has_stage_listeners():
        return
    if sync and lat.is_cuda:
        torch.cuda.synchronize(lat.device)
    notify_stage_progress("denoise", done / total)


class AetherPipeline:
    """The three-task sampler over a :class:`DiT` and a :class:`VAE` on one
    device. ``empty_prompt_embeds`` is the cached (1, 226, 4096) empty-prompt
    T5 embedding. ``act_quant`` runs the DiT's int8 codes with int8
    activations (w8a8); the models move to ``device`` with their dtypes kept
    (a quantized DiT keeps its codes and f32 scales). ``mesh`` (a
    ``parallel.make_mesh`` mesh holding this rank) splits the DiT by
    ``parallel.shard_params`` and runs the pipeline over the mesh (see the
    module docstring); every rank of it must make the same calls.

    The wires (JAX :1188-1242): ``compact_transfer`` None means on for a
    CUDA device and off on the CPU; compact, the RGB moves as ``wire_rgb``
    ("u8", the default, or "yuv420") and the disparity as ``wire_disparity``
    ("fp16", the default, or "u8"); ``wire_input`` ("u8" or "yuv420") is
    the pixels' upload, compact or not."""

    def __init__(self, config: PipelineConfig, dit: DiT, vae: VAE,
                 empty_prompt_embeds, *, device=None, compute_dtype=torch.bfloat16,
                 act_quant: bool = False, mesh=None, compact_transfer: Optional[bool] = None,
                 wire_rgb: Optional[str] = None, wire_input: str = "u8",
                 wire_disparity: str = "fp16"):
        if wire_rgb not in (None, "u8", "yuv420"):
            raise ValueError(f"wire_rgb must be 'u8' or 'yuv420', got {wire_rgb}")
        if wire_input not in ("u8", "yuv420"):
            raise ValueError(f"wire_input must be 'u8' or 'yuv420', got {wire_input}")
        if wire_disparity not in ("fp16", "u8"):
            raise ValueError(
                f"wire_disparity must be 'fp16' or 'u8', got {wire_disparity}")
        self.compact_transfer = compact_transfer
        self.wire_rgb = wire_rgb
        self.wire_input = wire_input
        self.wire_disparity = wire_disparity
        self._pinned = _PinnedPool()
        self.config = config
        self.device = torch.device(device) if device is not None else next(
            dit.parameters()).device
        self.dit = dit.to(self.device).eval()
        self.mesh = mesh
        if mesh is not None:
            from aether_tpu_torch.parallel.mesh import shard_params

            shard_params(self.dit, mesh)
        self.vae = vae.to(self.device).eval()
        self.compute_dtype = compute_dtype
        self.act_quant = act_quant
        text = torch.as_tensor(empty_prompt_embeds).to(device=self.device,
                                                       dtype=compute_dtype)
        self.empty_prompt_embeds = text[None] if text.ndim == 2 else text

    def _wire_modes(self, compact: bool, height: int, width: int):
        """(rgb_mode, disp_mode) of the D2H wire (JAX :1265-1274): f32 unless
        compact; compact, u8 RGB (yuv420 when asked and H and W are even) and
        fp16 disparity (u8 when asked)."""
        if not compact:
            return "f32", "f32"
        rgb_mode = "u8"
        if self.wire_rgb == "yuv420" and height % 2 == 0 and width % 2 == 0:
            rgb_mode = "yuv420"
        return rgb_mode, ("u8" if self.wire_disparity == "u8" else "fp16")

    def _modes(self, height: int, width: int):
        compact = self.compact_transfer
        if compact is None:
            compact = self.device.type == "cuda"
        return self._wire_modes(compact, height, width)

    def _upload_pixels(self, pixels_u8: np.ndarray, height: int, width: int) -> torch.Tensor:
        """uint8 pixels -> [-1, 1] on the device through the input wire: u8,
        or yuv420 packed on the host and unpacked on the device (u8 for an
        odd H or W; JAX :1405-1409)."""
        dev, dtype = self.device, self.compute_dtype
        if self.wire_input == "yuv420" and height % 2 == 0 and width % 2 == 0:
            return _yuv420_to_unit(*(_upload(p, dev) for p in _rgb_u8_to_yuv420_host(pixels_u8)),
                                   dtype)
        return _u8_to_unit(pixels_u8, dtype, dev)

    def _pull(self, wires: list, modes, times: Dict[str, float]):
        """Start the host copies of ``wires`` (one (rgb tuple, disparity,
        raymap) a window); returns the function that waits for them and
        builds the windows' :class:`AetherPipelineOutput`."""
        flat = [t for rgb, disp, ray in wires for t in (*rgb, disp, ray)]
        copies = _HostCopies(flat, self._pinned)
        n_rgb = len(wires[0][0]) if wires else 0

        def resolve() -> list:
            arrays, k, outs = copies.arrays(), n_rgb + 2, []
            for i in range(len(wires)):
                a = arrays[i * k:(i + 1) * k]
                outs.append(_host_output(a[:n_rgb], a[n_rgb], a[n_rgb + 1], *modes, times))
            copies.release()
            return outs

        return resolve

    def check_inputs(self, task, image, video, goal, raymap, height, width,
                     num_frames, fps) -> None:
        """The JAX pipeline's validation (reference ``pipeline:350-449``)."""
        cfg = self.config
        if task not in ("reconstruction", "prediction", "planning"):
            raise ValueError(
                f"`task` has to be one of reconstruction/prediction/planning, got {task}.")
        if image is None and video is None:
            raise ValueError("`image` or `video` has to be provided.")
        if image is not None and video is not None:
            raise ValueError("`image` and `video` cannot both be provided.")
        if image is not None and task == "reconstruction":
            raise ValueError("`image` is not supported for `reconstruction` task.")
        if goal is not None and task != "planning":
            raise ValueError("`goal` is only supported for `planning` task.")
        if video is not None and task != "reconstruction":
            raise ValueError("`video` is only supported for `reconstruction` task.")
        if height % 8 != 0 or width % 8 != 0:
            raise ValueError(
                f"`height` and `width` have to be divisible by 8 but are {height} and {width}.")
        if num_frames is None:
            raise ValueError("`num_frames` is required.")
        if num_frames not in cfg.allowed_num_frames:
            raise ValueError(
                f"`num_frames` has to be one of {list(cfg.allowed_num_frames)}.")
        if fps not in cfg.allowed_fps:
            raise ValueError(f"`fps` has to be one of {list(cfg.allowed_fps)}.")
        if raymap is not None:
            expected = (num_frames, 6, height // cfg.vae_scale_factor_spatial,
                        width // cfg.vae_scale_factor_spatial)
            if tuple(raymap.shape[-4:]) != expected:
                raise ValueError(
                    f"`raymap` shape is not correct. Expected {expected}, "
                    f"got {tuple(raymap.shape)}.")

    @torch.no_grad()
    def __call__(
        self,
        task: Optional[str] = None,
        image=None,
        video=None,
        goal=None,
        raymap=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_frames: Optional[int] = None,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        use_dynamic_cfg: Optional[bool] = None,
        fps: Optional[int] = None,
        seed: Optional[int] = None,
        noise=None,
        defer_host: bool = False,
    ):
        """Run one window of ``task`` (inferred from the inputs when None:
        reconstruction for a video, planning with a goal, else prediction).
        ``noise`` replaces the default :class:`TorchNoise` (it needs
        ``posterior``, ``goal``, ``initial`` and ``sde``). Returns an
        :class:`AetherPipelineOutput`, or with ``defer_host`` a
        :class:`DeferredOutput` as soon as the work and the host copies are
        queued (no stage synchronizes; ``stage_seconds`` holds enqueue
        seconds)."""
        cfg = self.config
        if task is None:
            task = ("reconstruction" if video is not None
                    else "planning" if goal is not None else "prediction")
        height = height or cfg.dit.sample_height * cfg.vae_scale_factor_spatial
        width = width or cfg.dit.sample_width * cfg.vae_scale_factor_spatial
        if num_frames is None:
            num_frames = max(cfg.allowed_num_frames)
        fps = fps or cfg.base_fps
        self.check_inputs(task, image, video, goal, raymap, height, width,
                          num_frames, fps)
        # None means the task default; explicit falsy values are honoured
        if num_inference_steps is None:
            num_inference_steps = dict(cfg.default_num_inference_steps)[task]
        if guidance_scale is None:
            guidance_scale = dict(cfg.default_guidance_scale)[task]
        if use_dynamic_cfg is None:
            use_dynamic_cfg = dict(cfg.default_use_dynamic_cfg)[task]

        dev, dtype = self.device, self.compute_dtype
        if noise is None:
            noise = TorchNoise(seed if seed is not None else 0, dev)
        lat_c = cfg.vae.latent_channels
        h_lat = height // cfg.vae_scale_factor_spatial
        w_lat = width // cfg.vae_scale_factor_spatial
        f_lat = (num_frames - 1) // cfg.vae_scale_factor_temporal + 1
        # tile the VAE when the frame exceeds one 32x48-latent tile
        tiling = h_lat > 32 or w_lat > 48
        times: Dict[str, float] = {}

        # host-side precomputation: pixels, sampling plan, guidance, rope tables
        if video is not None:
            pixels = preprocess_video_u8(video, height, width)
        else:
            pixels = preprocess_image_u8(image, height, width)[None]
        goal_pixels = (None if goal is None
                       else preprocess_image_u8(goal, height, width)[None])
        timesteps, plan, rope_cos, rope_sin = self._schedule(
            num_inference_steps, height, width, f_lat, fps)
        guidance = None
        if guidance_scale > 1.0:
            scales = (dynamic_cfg_schedule(timesteps, num_inference_steps, guidance_scale)
                      if use_dynamic_cfg
                      else np.full(num_inference_steps, guidance_scale, np.float32))
            guidance = _upload(scales, dev)
        sync = not defer_host

        # ---- stage 1: tiled, chunked VAE encode of the pixel conditions ----
        with _stage("encode", times, dev, sync):
            def encode(px, draw):
                return _encode_pixels(cfg, dtype, self.vae,
                                      self._upload_pixels(px, height, width), draw, tiling)

            condition = encode(pixels, noise.posterior)
            if task == "prediction":  # [image | zeros]
                condition = torch.cat([condition, condition.new_zeros(
                    (1, f_lat - 1, lat_c, h_lat, w_lat))], dim=1)
            elif task == "planning":  # [image | zeros | goal], a second draw
                goal_lat = encode(goal_pixels, noise.goal)
                condition = torch.cat([condition, condition.new_zeros(
                    (1, f_lat - 2, lat_c, h_lat, w_lat)), goal_lat], dim=1)
            if raymap is not None:
                camera = pack_raymap(_upload(np.asarray(raymap), dev)[None].to(dtype))
            else:
                camera = torch.zeros((1, f_lat, 24, h_lat, w_lat), dtype=dtype, device=dev)
            condition_latents = torch.cat([condition, camera], dim=2)

        # ---- stage 2: denoise ----
        with _stage("denoise", times, dev, sync):
            latents = _denoise(cfg, dtype, self.dit, self.empty_prompt_embeds,
                               condition_latents, plan, rope_cos, rope_sin, noise,
                               task, guidance, act_quant=self.act_quant, sync=sync)

        # ---- stage 3: stacked decode, the wire transforms, the host copies ----
        modes = self._modes(height, width)
        with _stage("decode", times, dev, sync):
            resolve = self._pull(self._decode_windows(latents, tiling, num_frames, modes),
                                 modes, times)
        out = DeferredOutput(lambda: resolve()[0])
        return out if defer_host else out.resolve()

    def _schedule(self, num_inference_steps: int, height: int, width: int, f_lat: int,
                  fps: int):
        """Host-side precomputation: (timesteps, sampling plan, rope cos, rope
        sin), the plan and tables on the device."""
        cfg, dev = self.config, self.device
        timesteps = set_timesteps(cfg.scheduler, num_inference_steps)
        plan = make_sampling_plan(cfg.scheduler, num_inference_steps,
                                  timesteps=timesteps, device=dev)
        rope_cos, rope_sin = (_upload(t, dev) for t in
                              prepare_rotary_positional_embeddings(
                                  cfg.dit, height, width, f_lat,
                                  vae_scale_factor_spatial=cfg.vae_scale_factor_spatial,
                                  base_fps=cfg.base_fps, fps=fps))
        return timesteps, plan, rope_cos, rope_sin

    def _decode_windows(self, latents: torch.Tensor, tiling: bool, num_frames: int,
                        modes) -> list:
        """(B, F_lat, 56, h, w) latents -> B device wires (rgb tuple,
        disparity, raymap): the RGB and disparity streams in one batch-2B
        decode, each finished into its wire (``modes``), the raymaps
        unfolded."""
        cfg, dtype = self.config, self.compute_dtype
        lat_c = cfg.vae.latent_channels
        rgb, disparity = _decode_rgb_and_disparity(cfg, dtype, self.vae, latents, tiling,
                                                   self.mesh)
        rgb = _finish_rgb(rgb, modes[0])
        disparity = _finish_disparity(disparity, modes[1])
        raymap = unpack_raymap(latents[:, :, 2 * lat_c:].float(), num_frames)
        return [(tuple(p[i].contiguous() for p in rgb), disparity[i].contiguous(),
                 raymap[i].contiguous()) for i in range(latents.shape[0])]

    @torch.no_grad()
    def batch_reconstruct(
        self,
        videos,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_frames: Optional[int] = None,
        num_inference_steps: int = 4,
        fps: int = 12,
        seed: int = 0,
        noise=None,
        defer_host: bool = False,
    ):
        """Reconstruct B windows ``videos`` (B, F, H, W, 3) in ONE batched
        denoise (JAX ``batch_reconstruct``, :1526-1690).

        The windows ride the DiT's batch axis through one denoise; the VAE
        encodes and decodes them one at a time. Every window gets the draws of a
        serial ``__call__`` with the same seed: the posterior, initial and SDE
        noise are drawn once for one window and broadcast over the batch, so
        the result matches a serial loop up to the rounding of the batch-B
        DiT. The encode runs window by window (see :func:`_encode_windows`),
        and so does the decode: the JAX package stacks all 2B streams, which
        at B=2 and 480x720 is four full-frame decodes and about twice the
        activations of the two-stream decode (which already peaks at ~44 GiB
        with the DiT resident), leaving no margin on an 80 GB card; every VAE
        op is per sample, so the outputs are the same. ``noise`` replaces the
        default :class:`TorchNoise` (it needs ``posterior``, ``initial`` and
        ``sde``). Under a mesh the windows ride dp (JAX :1553-1565): a batch
        that dp does not divide is padded by repeating its last window, the
        encode splits the windows over the dp ranks, and so does the stacked
        decode of all 2B streams; the padding's outputs are dropped.
        Returns one :class:`AetherPipelineOutput` per window; each carries the
        batch's stage times. With ``defer_host``, a :class:`DeferredOutput`
        that resolves to that list, as in :meth:`__call__`."""
        cfg = self.config
        videos = np.asarray(videos)
        n_windows = videos.shape[0]
        if self.mesh is not None:
            from aether_tpu_torch.parallel.mesh import axis_size

            # the batch rides dp: a short (tail) batch is padded to a dp
            # multiple by repeating its last window, whose outputs are dropped
            # (every window draws the same noise, so the copies are exact)
            dp = axis_size(self.mesh, "dp")
            if dp > 1 and n_windows % dp:
                videos = np.concatenate(
                    [videos, np.repeat(videos[-1:], dp - n_windows % dp, axis=0)])
        bsz = videos.shape[0]
        height = height or videos.shape[2]
        width = width or videos.shape[3]
        num_frames = num_frames or videos.shape[1]
        self.check_inputs("reconstruction", None, videos[0], None, None, height, width,
                          num_frames, fps)
        dev, dtype = self.device, self.compute_dtype
        if noise is None:
            noise = TorchNoise(seed, dev)
        h_lat = height // cfg.vae_scale_factor_spatial
        w_lat = width // cfg.vae_scale_factor_spatial
        f_lat = (num_frames - 1) // cfg.vae_scale_factor_temporal + 1
        tiling = h_lat > 32 or w_lat > 48
        times: Dict[str, float] = {}

        pixels = np.stack([preprocess_video_u8(v, height, width) for v in videos])
        _, plan, rope_cos, rope_sin = self._schedule(num_inference_steps, height, width,
                                                     f_lat, fps)

        sync = not defer_host
        with _stage("encode", times, dev, sync):
            condition = _encode_windows(cfg, dtype, self.vae,
                                        self._upload_pixels(pixels, height, width),
                                        noise.posterior, tiling, mesh=self.mesh)
            camera = torch.zeros((bsz, f_lat, 24, h_lat, w_lat), dtype=dtype, device=dev)
            condition_latents = torch.cat([condition, camera], dim=2)

        with _stage("denoise", times, dev, sync):
            latents = _denoise(cfg, dtype, self.dit, self.empty_prompt_embeds,
                               condition_latents, plan, rope_cos, rope_sin, noise,
                               "reconstruction", None, broadcast_noise=True,
                               act_quant=self.act_quant, sync=sync)

        modes = self._modes(height, width)
        with _stage("decode", times, dev, sync):
            if _dp_rows(self.mesh, 2 * bsz) is not None:
                # the stacked 2B streams over the dp ranks
                wires = self._decode_windows(latents, tiling, num_frames, modes)
            else:
                wires = [self._decode_windows(latents[i:i + 1], tiling, num_frames, modes)[0]
                         for i in range(bsz)]
            # the padding's outputs are dropped before they are copied
            resolve = self._pull(wires[:n_windows], modes, times)
        out = DeferredOutput(resolve)
        return out if defer_host else out.resolve()

"""The port's device->host wires and ``defer_host`` (CPU, tiny config, f32).

- The codecs and ``_finish_*`` modes against the JAX functions on the same
  seeded inputs: every u8 and fp16 code and every host codec bit for bit
  (the allowance for XLA's CPU fusion, +-1 code on at most 1e-4 of the
  codes, is not needed). Two f32 outputs differ by rounding: XLA's CPU code
  contracts multiply-adds into FMAs and turns a division by a constant into
  a multiply by its f32 reciprocal, where a chain of torch ops rounds each
  step. ``_finish_disparity("f32")`` is held within 2e-7 plus 2 f32 ulps
  relative (one FMA before the square; exact when the FMA is emulated in
  float64; near 0 the square's ulps are tiny, hence the absolute term) and
  ``_yuv420_to_unit`` within 1e-6 on its [-1, 1] output (4.8e-7 seen).
- ``_wire_modes`` and the constructor's validation messages, as JAX's.
- The tiny pipeline with ``compact_transfer=True`` in each wire mode against
  the tiny JAX pipeline in the same mode, with the JAX key streams injected:
  the 5e-3 bar of ``test_torch_serve_parity.py`` plus one quantization step
  of the wire (u8 RGB 1/255, yuv420 RGB one chroma code 1/(255 * 0.564),
  fp16 disparity 1e-3, u8 disparity 2.5/255 in the gamut, JAX's bar of
  ``tests/test_pipeline.py:336-342``); the raymap stays f32 (5e-3).
- ``defer_host`` bit-identical to an undeferred call, ``resolve()``
  idempotent, ``batch_reconstruct(defer_host=True)``, and ``iter_resolved``'s
  order and its one dispatch in flight.

The deferred drivers are ``test_torch_wire_drivers.py``'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aether_tpu.pipeline.aether as jax_aether
import aether_tpu_torch.pipeline.aether as port_aether

torch.set_num_threads(1)

F, H, W = 17, 64, 96
ATOL = 5e-3
FIELDS = ("rgb", "disparity", "raymap")


# ---------------------------------------------------------------------------
# the codecs against the JAX functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoded():
    """A seeded decoder output in [-1.2, 1.2] (some of it out of gamut)."""
    return np.random.default_rng(0).uniform(-1.2, 1.2, (3, 32, 48, 3)).astype(np.float32)


def _codes_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["f32", "u8", "yuv420"])
def test_finish_rgb_matches_jax(decoded, mode):
    got = port_aether._finish_rgb(torch.from_numpy(decoded), mode)
    want = jax_aether._finish_rgb(jnp.asarray(decoded), mode)
    assert len(got) == len(want) == (3 if mode == "yuv420" else 1)
    for g, w in zip(got, want):
        _codes_equal(g.numpy(), w)


@pytest.mark.parametrize("mode", ["f32", "fp16", "u8"])
def test_finish_disparity_matches_jax(decoded, mode):
    got = port_aether._finish_disparity(torch.from_numpy(decoded), mode).numpy()
    want = np.asarray(jax_aether._finish_disparity(jnp.asarray(decoded), mode))
    if mode == "f32":  # XLA's FMA before the square (module docstring)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=2e-7)
    else:
        _codes_equal(got, want)


def test_yuv420_codecs_match_jax(decoded):
    rgb01 = np.clip(decoded * 0.5 + 0.5, 0.0, 1.0)
    wire = port_aether._rgb_to_yuv420_wire(torch.from_numpy(rgb01))
    jwire = jax_aether._rgb_to_yuv420_wire(jnp.asarray(rgb01))
    for g, w in zip(wire, jwire):
        _codes_equal(g.numpy(), w)
    assert wire[0].shape == (3, 32, 48) and wire[1].shape == (3, 16, 24)
    _codes_equal(port_aether._yuv420_wire_to_rgb(*(t.numpy() for t in wire)),
                 jax_aether._yuv420_wire_to_rgb(*jwire))

    px = np.random.default_rng(1).integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
    host = port_aether._rgb_u8_to_yuv420_host(px)
    for g, w in zip(host, jax_aether._rgb_u8_to_yuv420_host(px)):
        _codes_equal(g, w)
    got = port_aether._yuv420_to_unit(*(torch.from_numpy(p) for p in host), torch.float32)
    want = np.asarray(jax_aether._yuv420_to_unit(*host, jnp.float32))
    assert got.shape == want.shape == (2, 32, 48, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)  # reciprocals, FMAs
    _codes_equal(port_aether._u8_to_unit(px, torch.float32, "cpu").numpy(),
                 jax_aether._u8_to_unit(px, jnp.float32))


def test_round_half_to_even_as_jnp():
    """Codes exactly between two integers round to the even one, as
    ``jnp.round`` does (``_to_u8``)."""
    v = (np.arange(256, dtype=np.float32) + 0.5) / 255.0
    v = v[v <= 1.0]
    got = port_aether._to_u8(torch.from_numpy(v)).numpy()
    want = np.asarray(jnp.round(jnp.clip(jnp.asarray(v), 0.0, 1.0) * 255.0).astype(jnp.uint8))
    _codes_equal(got, want)


# ---------------------------------------------------------------------------
# the constructor, _wire_modes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    from test_torch_batch_reconstruct import jax_pipeline, tiny_pipelines

    jcfg, dit_tree, vae_tree, text, port = tiny_pipelines()
    return jcfg, dit_tree, vae_tree, text, port, jax_pipeline(jcfg, dit_tree, vae_tree, text)


def _port_like(port, **kw):
    from aether_tpu_torch.pipeline import AetherPipeline

    return AetherPipeline(port.config, port.dit, port.vae, port.empty_prompt_embeds,
                          device="cpu", compute_dtype=torch.float32, **kw)


def _jax_like(setup, **kw):
    jcfg, dit_tree, vae_tree, text = setup[:4]
    return jax_aether.AetherPipeline(
        jcfg, jax.tree_util.tree_map(jnp.asarray, dit_tree),
        jax.tree_util.tree_map(jnp.asarray, vae_tree), text, attn_impl="xla",
        compute_dtype=jnp.float32, **kw)


def test_wire_modes_and_validation_match_jax(setup):
    port, jax_pipe = setup[4], setup[5]
    for compact in (False, True):
        for h, w in ((64, 96), (63, 96)):
            assert port._wire_modes(compact, h, w) == jax_pipe._wire_modes(compact, h, w)
    lossy = _port_like(port, wire_rgb="yuv420", wire_disparity="u8")
    assert lossy._wire_modes(True, 64, 96) == ("yuv420", "u8")
    assert lossy._wire_modes(True, 63, 96) == ("u8", "u8")  # odd dims fall back
    assert lossy._wire_modes(False, 64, 96) == ("f32", "f32")
    # None: on for a card, off on the CPU (JAX: off for the CPU backend)
    assert port.compact_transfer is None and port._modes(64, 96) == ("f32", "f32")
    for kw in (dict(wire_rgb="rgb565"), dict(wire_input="nv12"), dict(wire_disparity="f32")):
        with pytest.raises(ValueError) as want:
            _jax_like(setup, **kw)
        with pytest.raises(ValueError) as got:
            _port_like(port, **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the tiny pipeline in each wire mode against JAX in the same mode
# ---------------------------------------------------------------------------

_STEP = {"u8": 1 / 255, "yuv420": 1 / (255 * 0.564), "fp16": 1e-3, "u8disp": 2.5 / 255}


@pytest.fixture(scope="module")
def video():
    return np.random.default_rng(4).integers(0, 256, (F, H, W, 3), dtype=np.uint8)


def _request(pipe, video, port: bool, **extra):
    from test_torch_pipeline import JaxKeyNoise

    kw = dict(task="reconstruction", video=video, height=H, width=W, num_frames=F,
              num_inference_steps=1, fps=12, seed=7, **extra)
    if port:
        kw["noise"] = JaxKeyNoise(7)
    return pipe(**kw)


@pytest.mark.parametrize("wires", [
    dict(),
    dict(wire_rgb="yuv420", wire_disparity="u8"),
    dict(wire_input="yuv420"),
], ids=["u8-fp16", "yuv420-u8", "input-yuv420"])
def test_compact_pipeline_matches_jax(setup, video, wires):
    port, jax_pipe = setup[4], setup[5]
    got = _request(_port_like(port, compact_transfer=True, **wires), video, True)
    want = _request(_jax_like(setup, compact_transfer=True, **wires), video, False)
    exact = _request(jax_pipe, video, False)
    rgb_step = _STEP[wires.get("wire_rgb", "u8")]
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and a.dtype == np.float32 == b.dtype, name
    assert np.abs(got.rgb - want.rgb).max() <= ATOL + rgb_step
    np.testing.assert_allclose(got.raymap, want.raymap, atol=ATOL)
    if wires.get("wire_disparity") == "u8":
        gamut = exact.disparity <= 1.0
        err = np.abs(got.disparity - want.disparity)[gamut]
        assert err.max() <= ATOL + _STEP["u8disp"]
        assert np.all(got.disparity <= 1.0 + 1e-6)
    else:
        assert np.abs(got.disparity - want.disparity).max() <= ATOL + _STEP["fp16"]
    if not wires:  # the u8 codes: at most one step from the exact f32 wire
        assert np.abs(got.rgb - exact.rgb).max() <= ATOL + 0.5 / 255 + 1e-6


# ---------------------------------------------------------------------------
# defer_host and iter_resolved
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compact", [False, True])
def test_defer_host_is_identical_and_idempotent(setup, video, compact):
    pipe = _port_like(setup[4], compact_transfer=compact)
    eager = _request(pipe, video, True)
    deferred = _request(pipe, video, True, defer_host=True)
    assert isinstance(deferred, port_aether.DeferredOutput)
    out = deferred.resolve()
    assert deferred.resolve() is out
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(out, name), getattr(eager, name))
    assert set(out.stage_seconds) == {"encode", "denoise", "decode"}


def test_batch_reconstruct_defer_host(setup, video):
    from test_torch_pipeline import JaxKeyNoise

    pipe = setup[4]
    windows = np.stack([video, video[::-1]])
    kw = dict(height=H, width=W, num_frames=F, num_inference_steps=1, fps=12, seed=3)
    sync = pipe.batch_reconstruct(windows, noise=JaxKeyNoise(3), **kw)
    deferred = pipe.batch_reconstruct(windows, noise=JaxKeyNoise(3), defer_host=True, **kw)
    resolved = deferred.resolve()
    assert deferred.resolve() is resolved and len(resolved) == len(sync) == 2
    for a, b in zip(resolved, sync):
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_iter_resolved_keeps_order_and_one_in_flight():
    events = []

    class Deferred:
        def __init__(self, i):
            self.i = i

        def resolve(self):
            events.append(f"resolve{self.i}")
            return self.i

    def dispatch(i):
        def make():
            events.append(f"dispatch{i}")
            return Deferred(i) if i % 2 == 0 else i  # plain outputs pass through
        return make

    got = []
    for out in port_aether.iter_resolved(dispatch(i) for i in range(4)):
        events.append(f"use{out}")
        got.append(out)
    assert got == [0, 1, 2, 3]
    assert events == ["dispatch0", "dispatch1", "resolve0", "use0", "dispatch2", "use1",
                      "dispatch3", "resolve2", "use2", "use3"]
    assert list(port_aether.iter_resolved([])) == []

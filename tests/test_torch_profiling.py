"""Stage timers and stage listeners of the port against ``aether_tpu.utils.profiling``.

- The listener semantics (begin / end / progress order, a raising listener
  swallowed, removal, ``stage_report(reset=True)``) on one call sequence run
  through both modules.
- At the tiny config, with converted weights, the port's windowed
  reconstruction emits the JAX driver's and pipeline's stage events in the
  JAX order: ``dispatch@`` / ``resolve@``, ``vae_encode``, ``denoise`` with
  one progress event a step (the JAX side split into one-step segments,
  ``AETHER_DENOISE_SEG=1``, so that it reports every step too), ``vae_decode``.
- Without a listener the denoise loop adds no device synchronize and no event.
"""

import json

import numpy as np
import pytest
import torch

from aether_tpu.utils import profiling as jax_profiling
from aether_tpu_torch.pipeline import aether as port_aether
from aether_tpu_torch.utils import profiling

torch.set_num_threads(1)


class Recorder:
    """A stage listener that records (name, event, fraction or None)."""

    def __init__(self):
        self.events = []

    def __call__(self, name, event, value):
        self.events.append((name, event, round(value, 6) if event == "progress" else None))


def _script(mod):
    """One call sequence through a profiling module; returns what it saw."""
    mod.stage_report(reset=True)
    rec = Recorder()

    def broken(name, event, value):
        raise RuntimeError("listener failure")

    mod.add_stage_listener(broken)
    mod.add_stage_listener(rec)
    listening = mod.has_stage_listeners()
    with mod.stage_timer("outer", log=False):
        mod.notify_stage_progress("outer", 0.5)
        with mod.stage_timer("inner", log=False):
            pass
    mod.notify_stage_progress("loose", 1.0)
    mod.remove_stage_listener(broken)
    mod.remove_stage_listener(broken)  # a second removal is a no-op
    with pytest.raises(ValueError):
        with mod.stage_timer("failing", log=False):
            raise ValueError("stage body failure")
    mod.remove_stage_listener(rec)
    with mod.stage_timer("outer", log=False):
        pass
    counts = {k: v["count"] for k, v in mod.stage_report(reset=True).items()}
    return rec.events, counts, listening, mod.has_stage_listeners(), mod.stage_report()


def test_listener_semantics_match_jax():
    got = _script(profiling)
    ref = _script(jax_profiling)
    assert got == ref
    events, counts, listening, after, emptied = got
    assert events == [("outer", "begin", None), ("outer", "progress", 0.5),
                      ("inner", "begin", None), ("inner", "end", None),
                      ("outer", "end", None), ("loose", "progress", 1.0),
                      ("failing", "begin", None), ("failing", "end", None)]
    assert counts == {"outer": 2, "inner": 1, "failing": 1}
    assert listening and not after and emptied == {}


def test_stage_report_accumulates():
    profiling.stage_report(reset=True)
    for _ in range(3):
        with profiling.stage_timer("x", log=False):
            pass
    report = profiling.stage_report()
    assert report["x"]["count"] == 3
    assert report["x"]["mean_s"] == pytest.approx(report["x"]["total_s"] / 3)
    assert profiling.stage_report(reset=True) == report
    assert profiling.stage_report() == {}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    profiling.stage_report(reset=True)
    with profiling.device_trace("trace/block", trace_dir=str(tmp_path)):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace_block.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "trace/block" in names
    assert profiling.stage_report(reset=True)["trace/block"]["count"] == 1


class _CudaLike:
    is_cuda = True
    device = "cuda:0"


def test_step_progress_syncs_only_with_a_listener(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
    port_aether._step_progress(_CudaLike(), 1, 4)
    assert syncs == []
    rec = Recorder()
    profiling.add_stage_listener(rec)
    try:
        port_aether._step_progress(_CudaLike(), 3, 4)
    finally:
        profiling.remove_stage_listener(rec)
    assert syncs == [("cuda:0",)] and rec.events == [("denoise", "progress", 0.75)]


@pytest.fixture(scope="module")
def pipelines():
    from test_torch_batch_reconstruct import jax_pipeline, tiny_pipelines

    jcfg, dit_tree, vae_tree, text, port = tiny_pipelines()
    return jax_pipeline(jcfg, dit_tree, vae_tree, text), port


def _windowed_events(run, pipe, video, mod):
    rec = Recorder()
    mod.add_stage_listener(rec)
    try:
        results, starts, _ = run(pipe, video, height=64, width=96, num_frames=17, fps=12,
                                 num_inference_steps=2, stride=8, seed=3)
    finally:
        mod.remove_stage_listener(rec)
    assert starts == [0, 8] and len(results) == 2
    return rec.events


def test_windowed_reconstruction_events_match_jax(pipelines, monkeypatch):
    from aether_tpu.pipeline.windowing import run_windowed_reconstruction as jax_run
    from aether_tpu_torch.pipeline.windowing import run_windowed_reconstruction

    jax_pipe, port = pipelines
    video = np.random.default_rng(4).integers(0, 256, (25, 64, 96, 3), dtype=np.uint8)
    monkeypatch.setenv("AETHER_DENOISE_SEG", "1")
    ref = _windowed_events(jax_run, jax_pipe, video, jax_profiling)
    got = _windowed_events(run_windowed_reconstruction, port, video, profiling)
    window = [("vae_encode", "begin", None), ("vae_encode", "end", None),
              ("denoise", "begin", None), ("denoise", "progress", 0.5),
              ("denoise", "progress", 1.0), ("denoise", "end", None),
              ("vae_decode", "begin", None), ("vae_decode", "end", None)]
    assert got == ref == (
        [("dispatch@0", "begin", None)] + window + [("dispatch@0", "end", None)]
        + [("dispatch@8", "begin", None)] + window + [("dispatch@8", "end", None)]
        + [("resolve@0", "begin", None), ("resolve@0", "end", None),
           ("resolve@8", "begin", None), ("resolve@8", "end", None)])


def test_no_listener_no_progress_event(pipelines, monkeypatch):
    _, port = pipelines
    fired = []
    monkeypatch.setattr(port_aether, "notify_stage_progress",
                        lambda *a: fired.append(a))
    video = np.zeros((17, 64, 96, 3), np.uint8)
    kw = dict(task="reconstruction", video=video, height=64, width=96, num_frames=17,
              fps=12, num_inference_steps=3, seed=0)
    out = port(**kw)
    assert fired == [] and set(out.stage_seconds) == {"encode", "denoise", "decode"}
    rec = Recorder()
    profiling.add_stage_listener(rec)
    try:
        port(**kw)
    finally:
        profiling.remove_stage_listener(rec)
    assert fired == [("denoise", 1 / 3), ("denoise", 2 / 3), ("denoise", 1.0)]

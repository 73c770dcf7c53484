"""Prediction and planning, with CFG, in the PyTorch port (CPU, tiny config).

The port's ``AetherPipeline`` runs 17 frames at 64x96 for 2 steps with
guidance 3 and the dynamic-CFG ramp, conditioned on an image (and a goal for
planning) and a raymap, with the JAX pipeline's key streams injected
(``test_torch_pipeline.JaxKeyNoise``: the goal's posterior from the goal key,
in a fixed order that the tests assert), and is held against the committed
torch-sampler goldens ``prediction_*`` / ``planning_*``
(``scripts/make_pipeline_goldens.py``) at 5e-3, the bar
test_pipeline_torch_parity.py holds the JAX pipeline to. Also: the
dynamic-CFG ramp equals the JAX function, and every input error carries the
JAX message. ``test_torch_pipeline_cfg_live.py`` holds both tasks against the
live JAX pipeline.
"""

import types

import numpy as np
import pytest
import torch

from aether_tpu.pipeline import AetherPipeline as JaxPipeline
from aether_tpu.pipeline.aether import dynamic_cfg_schedule as jax_dynamic_cfg_schedule
from aether_tpu_torch.pipeline.aether import dynamic_cfg_schedule
from aether_tpu_torch.schedule.dpm import set_timesteps
from test_torch_pipeline import JaxKeyNoise, setup  # noqa: F401  (fixture)

torch.set_num_threads(1)

SEED = 1234  # scripts/make_pipeline_goldens.py
F, H, W, STEPS = 17, 64, 96, 2
DRAWS = {
    "prediction": ["posterior", "initial", "sde0", "sde1"],
    "planning": ["posterior", "goal", "initial", "sde0", "sde1"],
}


def _inputs(golden, task):
    kw = dict(image=golden["image"], raymap=golden["raymap"], height=H, width=W,
              num_frames=F, num_inference_steps=STEPS, fps=12)
    if task == "planning":
        kw["goal"] = golden["goal"]
    return kw


def _run_port(port, golden, task):
    noise = JaxKeyNoise(SEED)
    out = port(task=task, noise=noise, **_inputs(golden, task))
    assert noise.calls == DRAWS[task]
    return out


def _max_diffs(out, ref):
    return {name: float(np.max(np.abs(getattr(out, name) - ref[name])))
            for name in ("rgb", "disparity", "raymap")}


@pytest.mark.parametrize("task", ["prediction", "planning"])
def test_task_matches_torch_goldens(setup, task):
    *_, port, golden = setup
    out = _run_port(port, golden, task)
    assert out.rgb.shape == (F, H, W, 3) and out.disparity.shape == (F, H, W)
    assert out.raymap.shape == (F, 6, H // 8, W // 8)
    diffs = _max_diffs(out, {n: golden[f"{task}_{n}"]
                             for n in ("rgb", "disparity", "raymap")})
    assert max(diffs.values()) < 5e-3, diffs


@pytest.mark.parametrize("steps,guidance", [(50, 3.0), (10, 3.0), (2, 3.0), (4, 6.5)])
def test_dynamic_cfg_schedule_matches_jax(steps, guidance):
    from aether_tpu_torch.config import PipelineConfig

    timesteps = set_timesteps(PipelineConfig().scheduler, steps)
    ours = dynamic_cfg_schedule(timesteps, steps, guidance)
    assert ours.dtype == np.float32 and ours.shape == (steps,)
    np.testing.assert_array_equal(ours, jax_dynamic_cfg_schedule(timesteps, steps, guidance))


_IMG = np.zeros((64, 96, 3), np.uint8)
_VID = np.zeros((17, 64, 96, 3), np.uint8)
_RAY = np.zeros((17, 6, 8, 12), np.float32)
# check_inputs(task, image, video, goal, raymap, height, width, num_frames, fps)
ERRORS = [
    (("depth", _IMG, None, None, None, 64, 96, 17, 12), "`task` has to be one of"),
    (("prediction", None, None, None, None, 64, 96, 17, 12), "`image` or `video` has to"),
    (("prediction", _IMG, _VID, None, None, 64, 96, 17, 12), "cannot both be provided"),
    (("reconstruction", _IMG, None, None, None, 64, 96, 17, 12), "`image` is not supported"),
    (("prediction", _IMG, None, _IMG, None, 64, 96, 17, 12), "`goal` is only supported"),
    (("planning", None, _VID, _IMG, None, 64, 96, 17, 12), "`video` is only supported"),
    (("prediction", _IMG, None, None, None, 60, 96, 17, 12), "divisible by 8"),
    (("prediction", _IMG, None, None, None, 64, 96, None, 12), "`num_frames` is required"),
    (("prediction", _IMG, None, None, None, 64, 96, 18, 12), "`num_frames` has to be one of"),
    (("prediction", _IMG, None, None, None, 64, 96, 17, 7), "`fps` has to be one of"),
    (("prediction", _IMG, None, None, _RAY[:13], 64, 96, 17, 12), "`raymap` shape is not"),
]


@pytest.mark.parametrize("args,match", ERRORS)
def test_check_inputs_errors_match_jax(setup, args, match):
    jcfg, *_, port, _ = setup
    with pytest.raises(ValueError, match=match) as jax_err:
        JaxPipeline.check_inputs(types.SimpleNamespace(config=jcfg), *args)
    with pytest.raises(ValueError, match=match) as port_err:
        port.check_inputs(*args)
    assert str(port_err.value) == str(jax_err.value)


def test_task_is_inferred_from_the_inputs(setup, monkeypatch):
    """task=None: planning with a goal, prediction with an image alone (the
    JAX rule); seen through the order of the draws."""
    *_, port, golden = setup
    for task in ("planning", "prediction"):
        kw = _inputs(golden, task)
        kw["num_inference_steps"] = 1
        noise = JaxKeyNoise(SEED)
        port(noise=noise, **kw)
        assert noise.calls == DRAWS[task][:-1]

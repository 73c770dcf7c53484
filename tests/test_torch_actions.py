"""The port's canned camera actions against ``aether_tpu.apps.actions`` (CPU).

``trajectory`` is the same float64 numpy code on both sides (held exactly);
``action_raymap`` runs the port's ``camera_pose_to_raymap`` in torch f32
against the JAX one (atol 1e-5), for every named action and a custom one.
"""

import numpy as np
import pytest
import torch

from aether_tpu.apps import actions as jax_actions
from aether_tpu_torch.apps import actions

torch.set_num_threads(1)

CUSTOM = {"forward": 1.5, "right": -0.5, "yaw_deg": 35.0}


def test_named_actions_are_the_jax_ones():
    assert actions.NAMED_ACTIONS == jax_actions.NAMED_ACTIONS


@pytest.mark.parametrize("kwargs", list(jax_actions.NAMED_ACTIONS.values()) + [CUSTOM],
                         ids=list(jax_actions.NAMED_ACTIONS) + ["custom"])
def test_trajectory_matches_jax(kwargs):
    np.testing.assert_array_equal(actions.trajectory(17, **kwargs),
                                  jax_actions.trajectory(17, **kwargs))


@pytest.mark.parametrize("name", sorted(jax_actions.NAMED_ACTIONS) + ["custom"])
def test_action_raymap_matches_jax(name):
    action = CUSTOM if name == "custom" else name
    kw = dict(num_frames=17, height=64, width=96, hfov_deg=55.0)
    got = actions.action_raymap(action, **kw)
    ref = np.asarray(jax_actions.action_raymap(action, **kw))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == ref.shape == (17, 6, 8, 12)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_action_raymap_default_shape():
    raymap = actions.action_raymap("forward_right")
    assert raymap.shape == (41, 6, 60, 90) and np.isfinite(raymap).all()


def test_main_writes_the_actions(tmp_path):
    actions.main(["--out_dir", str(tmp_path), "--actions", "left", "turn_right",
                  "--num_frames", "17", "--height", "64", "--width", "96"])
    for name in ("left", "turn_right"):
        saved = np.load(tmp_path / f"raymap_{name}.npy")
        np.testing.assert_array_equal(
            saved, actions.action_raymap(name, num_frames=17, height=64, width=96))

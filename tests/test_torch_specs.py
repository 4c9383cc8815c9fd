"""The OneRoom and YMaze families, GreenKey and ThreeRooms against the
JAX package: reset and 8 steps at B=8, 40x30, half the agents walking
to entity 0 from 1 m (the red box, GreenKey's green key: their episodes
end and auto-reset; ThreeRooms has no reward and never ends); YMaze's
``goal_pos`` info every step. Their banks are one chunk on today's
kernels. The spec fields are also held against Sign's, RoomObjects'
and PutNext's."""

import numpy as np
import pytest

from miniworld_tpu.envs import make_spec as jax_make_spec
from miniworld_tpu_torch.envs import make_spec

from _torch_parity import facing, reset_and_steps
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B, W, H, STEPS = 8, 40, 30, 8
IDS = ["MiniWorld-OneRoom-v0", "MiniWorld-OneRoomS6-v0", "MiniWorld-OneRoomS6Fast-v0",
       "MiniWorld-YMaze-v0", "MiniWorld-YMazeLeft-v0", "MiniWorld-YMazeRight-v0",
       "MiniWorld-GreenKey-v0", "MiniWorld-ThreeRooms-v0"]


def _half_to_the_box(jenv, jstate):
    pos, yaw = facing(jenv, jstate, 0, 1.0)
    forced = np.arange(B) < B // 2
    return (np.where(forced[:, None], pos, np.asarray(jstate.pos)),
            np.where(forced, yaw, np.asarray(jstate.dir)), forced)


@pytest.mark.parametrize("env_id", IDS)
def test_reset_and_steps(env_id):
    dones, rewards, j_info, t_info = reset_and_steps(env_id, B, W, H, STEPS, seed=41,
                                                     start=_half_to_the_box)
    if env_id == "MiniWorld-ThreeRooms-v0":  # exploration only (threerooms.py:41-80)
        assert dones == 0 and rewards == 0.0, (dones, rewards)
    else:
        assert dones >= B // 2 and rewards > 0.0, (dones, rewards)
    if "YMaze" in env_id:
        assert "goal_pos" in t_info


@pytest.mark.parametrize("env_id", IDS + ["MiniWorld-Sign-v0", "MiniWorld-RoomObjects-v0",
                                    "MiniWorld-PutNext-v0"])
def test_spec_fields(env_id):
    """Step limits, goal positions, layouts, Fourier terms, observation
    kind, Sign's goal and end action, the discrete table (None for the
    raw 6-D actions of RoomObjects and PutNext), PutNext's box slots and
    the per-episode parameters equal the JAX package's specs."""
    spec, jspec = make_spec(env_id), jax_make_spec(env_id)
    assert spec.max_episode_steps == jspec.max_episode_steps
    for name in ("goal_pos", "goal", "end_action_index", "red_slot", "yellow_slot"):
        assert getattr(spec, name, None) == getattr(jspec, name, None), name
    for name in ("num_layouts", "fourier_k", "dict_obs", "agent_radius", "place_budget"):
        assert getattr(spec, name) == getattr(jspec, name), name
    assert (spec.discrete_actions is None) == (jspec.discrete_actions is None)
    if jspec.discrete_actions is not None:
        np.testing.assert_array_equal(spec.discrete_actions, jspec.discrete_actions)
    for name, p in jspec.params.params.items():
        q = spec.params.params[name]
        for k in ("default", "min", "max"):
            np.testing.assert_array_equal(getattr(q, k), getattr(p, k), err_msg=name)

"""The widest static banks against the JAX package: WallGap and
NavigateWallGap (1,167 prims, 2 chunks of 1,024) and Sidewalk (2,702
prims with its baked building and cones, 3 chunks of 1,024), reset and
6 steps at B=4, 40x30, the multi-chunk render on every frame. Agents
are sent through WallGap's gap (NavigateWallGap's ``passed_gap``
reward) and off Sidewalk's kerb into the street (its termination)."""

import numpy as np
import pytest

from _torch_parity import facing, reset_and_steps
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B, W, H, STEPS = 4, 40, 30, 6


def _through_gap(jenv, jstate):
    """Envs 0 and 1 stand in the gap between the rooms, facing the
    bottom room (forward is (cos d, 0, -sin d)); the others where they
    reset."""
    pos = np.asarray(jstate.pos).copy()
    yaw = np.asarray(jstate.dir).copy()
    forced = np.arange(B) < 2
    pos[forced] = [[-0.5, 0.0, 0.1], [0.6, 0.0, -0.2]]
    yaw[forced] = np.pi / 2
    return pos, yaw, forced


def _to_the_box(jenv, jstate):
    pos, yaw = facing(jenv, jstate, 0, 1.0)
    forced = np.arange(B) < 2
    return (np.where(forced[:, None], pos, np.asarray(jstate.pos)),
            np.where(forced, yaw, np.asarray(jstate.dir)), forced)


def _into_the_street(jenv, jstate):
    """Envs 0 and 1 at the kerb (the street is x > 0), facing it; env 2
    in front of the box."""
    pos = np.asarray(jstate.pos).copy()
    yaw = np.asarray(jstate.dir).copy()
    forced = np.arange(B) < 3
    pos[:2] = [[-0.45, 0.0, 5.0], [-0.3, 0.0, 9.0]]
    yaw[:2] = 0.0
    box = np.asarray(jstate.ent_pos)[2, jenv.spec.goal_slot]
    pos[2] = box - [0.0, 0.0, 1.0]
    yaw[2] = -np.pi / 2
    return pos, yaw, forced


@pytest.mark.parametrize("env_id,start,expect", [
    ("MiniWorld-WallGap-v0", _to_the_box, "reward"),
    ("MiniWorld-NavigateWallGap-v0", _through_gap, "passed_gap"),
    ("MiniWorld-Sidewalk-v0", _into_the_street, "street"),
])
def test_reset_and_six_steps(env_id, start, expect):
    dones, rewards, j_info, t_info = reset_and_steps(env_id, B, W, H, STEPS, seed=31,
                                                     start=start)
    if expect == "passed_gap":  # a reward of 1 and the episode ends
        assert dones >= 2 and rewards == float(dones), (dones, rewards)
    elif expect == "street":  # two terminations without reward, one reached box
        assert dones >= 3 and 0.0 < rewards < 2.0, (dones, rewards)
    else:
        assert dones >= 2 and rewards > 0.0, (dones, rewards)

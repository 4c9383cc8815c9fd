"""The continuous-action ids of the port against the JAX package's:
RoomObjects and PutNext take the raw 6-D actions (no discrete table).

``sample_actions`` and ``rollout_actions`` bit for bit against the JAX
package's ``jax.random.uniform`` branch; reset and 8 steps of uniform
action vectors at B=8, 40x30 (``reset_and_steps``: states within
FLOAT_ATOL, images by ``assert_images_match`` on the render of the JAX
state: XLA:CPU fuses some multiply-adds of the fractional actions'
arithmetic, so states move apart by ulps a step, ROADMAP C1); a step
sequence that picks PutNext's red box up, carries it and drops it,
state for state;
a RoomObjects rollout's rewards, dones and checksums equal to JAX's;
(B,) actions raise for a spec without a table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.ops import rng as trng

from _torch_parity import (
    assert_images_match, assert_states_match, facing, reset_and_steps, to_port_state,
)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B, W, H = 8, 40, 30
ROOM, PUT = "MiniWorld-RoomObjects-v0", "MiniWorld-PutNext-v0"


@pytest.fixture(scope="module")
def room():
    return (JaxVec(ROOM, num_envs=B, obs_width=W, obs_height=H),
            MiniWorldVec(ROOM, B, obs_width=W, obs_height=H, device="cpu"))


@pytest.fixture(scope="module")
def put():
    return (JaxVec(PUT, num_envs=B, obs_width=W, obs_height=H),
            MiniWorldVec(PUT, B, obs_width=W, obs_height=H, device="cpu"))


def test_sample_actions_match_jax(room):
    jenv, tenv = room
    assert tenv._action_table is None and jenv._action_table is None
    for seed in (0, 7, 123456):
        want = np.asarray(jenv.sample_actions(jax.random.key(seed)))
        got = tenv.sample_actions(trng.key_data(seed))
        assert got.dtype == torch.float32 and got.shape == (B, 6)
        np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[:, 4:].min()) >= 0.0 and float(got[:, :4].min()) < 0.0


def test_rollout_actions_match_jax(room):
    """Step t acts on the first split of split(key, horizon)[t], as
    ``rollout_fn`` draws its random policy's actions."""
    jenv, tenv = room
    keys = jax.random.split(jax.random.key(5), 6)
    want = np.stack([np.asarray(jenv.sample_actions(jax.random.split(k)[0])) for k in keys])
    got = tenv.rollout_actions(trng.key_data(5), 6)
    assert got.shape == (6, B, 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("env_id", [ROOM, PUT])
def test_reset_and_steps(room, put, env_id):
    reset_and_steps(env_id, B, W, H, 8, seed=21, follow_jax=True,
                    envs=room if env_id == ROOM else put)


def test_pickup_carry_drop_match_jax(put):
    """PutNext: every agent 1 m from the red box and facing it, then
    pickup, forward, turn, drop and forward vectors: the box is carried
    (``carrying`` = 4) and put down again, the states within FLOAT_ATOL
    after every step (the port then goes on from the JAX state, C1) and
    the images of the same state equal JAX's."""
    jenv, tenv = put
    jstate, _ = jenv.reset(jax.random.key(8))
    pos, yaw = facing(jenv, jstate, 4, 1.0)
    jstate = jstate.replace(pos=jnp.asarray(pos, jnp.float32), dir=jnp.asarray(yaw, jnp.float32))
    tstate = to_port_state(jstate)
    plan = [[0, 0, 0, 0, 1, 0], [0.6, 0, 0, 0, 0, 0], [0, 0.3, 0.4, 0.2, 0, 0],
            [0, 0, 0, 0, 0, 1], [-0.5, 0, -0.2, 0, 0, 0]]
    carried = []
    for act in plan:
        acts = np.tile(np.asarray(act, np.float32), (B, 1))
        jstate, (j_rgb, j_d), j_r, j_done, _ = jenv.step(jstate, jnp.asarray(acts))
        tstate, (t_rgb, t_d), t_r, t_done, _ = tenv.step(tstate, torch.from_numpy(acts))
        np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
        assert_states_match(jstate, tstate)
        carried.append(tstate.carrying.numpy().copy())
        tstate = to_port_state(jstate)
        assert_images_match(j_rgb, j_d, *tenv.render(tstate))
    assert (carried[0] == 4).all() and (carried[2] == 4).all() and (carried[3] == -1).all()


def test_rollout_matches_jax(room):
    """A 4-step RoomObjects rollout from one key: rewards, dones and
    checksums equal JAX's ``rollout``."""
    jenv, tenv = room
    jstate, jobs = jenv.reset(jax.random.key(2))
    tstate, tobs = tenv.reset(2)
    _, _, j_out = jenv.rollout(jstate, jobs, jax.random.key(6), 4)
    _, _, t_out = tenv.rollout(tstate, tobs, trng.key_data(6), 4)
    for k in ("reward", "dones", "obs_sum"):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]).astype(
            t_out[k].numpy().dtype), err_msg=k)


def test_index_actions_raise(room):
    _, tenv = room
    state, _ = tenv.reset(0)
    with pytest.raises(ValueError, match="6"):
        tenv.step(state, torch.zeros(B, dtype=torch.int32))

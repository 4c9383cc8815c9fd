"""``MiniWorldVec.visible_ents`` of the port (render/visibility.py)
against the JAX package's (``get_visible_ents`` parity) on the CPU.

- the room depth the queries test against: ``room_depth_plain`` equals
  JAX ``_room_depth`` on every pixel (rays materialised, cov <= det
  unnormalised, t > NEAR; the MazeS3 procgen super bank with each env's
  ``tri_active`` kill);
- the (B, E) mask equals JAX's on every (env, entity) on the ids of
  tests/test_visibility.py (OneRoom, PutNext, PickupObjects, GreenKey) and
  MazeS3 procgen, at B=8, 48x36: the reset's poses, every agent 2.5 m
  from an entity and facing it, random yaws, and after random steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu.ops import geom as jgeom
from miniworld_tpu.render import raycast as jrc
from miniworld_tpu.render import visibility as jvis
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.render import visibility as tvis
from miniworld_tpu_torch.render.raycast import camera_grid

from _torch_parity import facing, to_port_state
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B, W, H = 8, 48, 36
IDS = ["MiniWorld-OneRoom-v0", "MiniWorld-PutNext-v0", "MiniWorld-PickupObjects-v0",
       "MiniWorld-GreenKey-v0", "MiniWorld-MazeS3-v0"]


def _envs(env_id):
    return (JaxVec(env_id, num_envs=B, obs_width=W, obs_height=H),
            MiniWorldVec(env_id, B, obs_width=W, obs_height=H, device="cpu"))


def _poses(jenv, seed):
    """JAX states: the reset's, every agent 2.5 m from entity slot 0 and
    facing it, and random yaws."""
    jstate, _ = jenv.reset(jax.random.key(seed))
    pos, yaw = facing(jenv, jstate, 0, 2.5)  # its query box inside the fov
    out = [jstate, jstate.replace(pos=jnp.asarray(pos, jnp.float32),
                                  dir=jnp.asarray(yaw, jnp.float32))]
    rng = np.random.default_rng(seed)
    out.append(jstate.replace(dir=jnp.asarray(rng.uniform(-np.pi, np.pi, B), jnp.float32)))
    return out


@pytest.mark.parametrize("env_id", ["MiniWorld-PickupObjects-v0", "MiniWorld-MazeS3-v0"])
def test_room_depth_matches_jax(env_id):
    jenv, env = _envs(env_id)
    vis = tvis.vis_statics(env._bank)
    jbank = jenv._bank

    def one(s):
        origin = jgeom.cam_position(s.pos, s.dir, s.cam_height, s.cam_fwd_disp)
        active = None
        if s.wall_open is not None:
            active = jbank.tri_active_base[0] + s.wall_open @ jbank.tri_wall_onehot[0]
        return jvis._room_depth(jbank, s.layout_id, origin, jrc.camera_rays(s, W, H),
                                tri_active=active)

    fn = jax.jit(jax.vmap(one))
    for jstate in _poses(jenv, 3):
        want = np.asarray(fn(jstate))
        state = to_port_state(jstate)
        got = tvis.room_depth_plain(vis, state.layout_id, state.wall_open,
                                    camera_grid(state, W, H))
        np.testing.assert_array_equal(got.numpy(), want)
        assert np.isfinite(want).mean() > 0.5


@pytest.mark.parametrize("env_id", IDS)
def test_visible_ents_match_jax(env_id):
    jenv, env = _envs(env_id)
    states = _poses(jenv, 11)
    rng = np.random.default_rng(11)
    jstate = states[0]
    for _ in range(3):
        n_act = env._action_table.shape[0] if env._action_table is not None else None
        acts = (rng.integers(0, n_act, B).astype(np.int32) if n_act is not None else
                rng.uniform([-1, -1, -1, -1, 0, 0], 1.0, (B, 6)).astype(np.float32))
        jstate = jenv.step(jstate, jnp.asarray(acts))[0]
        states.append(jstate)
    n_vis = n_pairs = 0
    for jstate in states:
        want = np.asarray(jenv.visible_ents(jstate))
        got = env.visible_ents(to_port_state(jstate))
        assert got.dtype == torch.bool and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        n_vis += int(want.sum())
        n_pairs += int(np.asarray(jstate.ent_alive).sum())
    # visible and hidden alive entities both occur
    assert 0 < n_vis < n_pairs

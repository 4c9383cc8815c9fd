"""Physics, placement and reset of the port against the JAX package, at
B=8 from the same key data: ints, bools and rewards exact, floats within
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu import vector as jvector
from miniworld_tpu.ops import physics as jphys, place as jplace, rng as jrng
from miniworld_tpu.render.raycast import room_of_point as j_room_of_point
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.ops import physics as tphys, place as tplace, rng as trng
from miniworld_tpu_torch.render.raycast import room_of_point as t_room_of_point

from _torch_parity import ENV_ID, assert_states_match, to_port_state
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B = 8


@pytest.fixture(scope="module")
def envs():
    jenv = JaxVec(ENV_ID, num_envs=B, obs_width=16, obs_height=12)
    tenv = MiniWorldVec(ENV_ID, B, obs_width=16, obs_height=12, device="cpu")
    return jenv, tenv


def _keys(seed):
    keys = jax.random.split(jax.random.key(seed), B)
    return keys, torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_reset_from_same_keys(envs, seed):
    jenv, tenv = envs
    jkeys, tkeys = _keys(seed)
    assert_states_match(jenv._reset_jit(jenv._bank, jkeys), tenv._reset_batch(tkeys))


@pytest.mark.parametrize("budget,radius", [(16, 0.4), (16, 1.2), (2, 1.9)])
def test_place_one(envs, budget, radius):
    """The agent's rule row with varied radii; budget 2 at radius 1.9
    exhausts the tries in some envs and takes the clamped fallback."""
    jenv, tenv = envs
    jkeys, tkeys = _keys(7)
    j_seed = jax.vmap(jrng.cheap_seed)(jkeys)
    bank_np = jenv._bank_np
    E = bank_np.slot_protos.shape[1]
    rule = {k: getattr(bank_np, k)[0, E, 0] for k in
            ("rule_room", "rule_bbox", "rule_pos", "rule_dir", "rule_dir_lo", "rule_dir_hi")}
    ent_xz = np.array([[9.5, 0.3]] * E, np.float32)
    ent_r = np.full(E, 0.6, np.float32)
    mask = np.ones(E, bool)

    def one(seed):
        lay = jvector.lay_view(jenv._bank, jnp.int32(0))
        return jplace.place_one(seed, lay, jenv._bank.room_segs, jnp.int32(0),
                                *[jnp.asarray(rule[k]) for k in rule],
                                jnp.float32(radius), jnp.asarray(ent_xz),
                                jnp.asarray(ent_r), jnp.asarray(mask), budget=budget)

    j_pos, j_dir = jax.jit(jax.vmap(one))(j_seed)
    t_seed = trng.cheap_seed(tkeys)
    np.testing.assert_array_equal(t_seed.numpy(), np.asarray(j_seed).astype(np.int64))

    def rep(x):
        t = torch.as_tensor(np.asarray(x))
        return t.expand((B,) + tuple(t.shape)).clone()

    t_pos, t_dir = tplace.place_one(
        t_seed, tenv._bank, torch.zeros(B, dtype=torch.int32),
        *[rep(rule[k]) for k in rule], torch.full((B,), radius),
        rep(ent_xz), rep(ent_r), rep(mask), budget=budget,
    )
    np.testing.assert_allclose(t_pos.numpy(), np.asarray(j_pos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_dir.numpy(), np.asarray(j_dir), rtol=0, atol=1e-5)


def _jax_physics_one(bank, state, a):
    lay = jvector.lay_view(bank, state.layout_id)
    room = j_room_of_point(bank, state.layout_id, state.pos[jnp.array([0, 2])])
    segs4 = bank.room_segs[state.layout_id, room]
    return jphys.physics_step(
        lay, state, a, segs4=segs4, max_forward_step=0.17,
        fwd_step=jnp.float32(0.15), fwd_drift=jnp.float32(0.0),
        turn_step=jnp.float32(15.0), agent_radius=0.4)


_jax_physics = jax.jit(jax.vmap(_jax_physics_one, in_axes=(None, 0, 0)))


def _physics_both(jenv, tenv, jstate, tstate, action_vec):
    """One physics_step in each package (discrete-table parameters)."""
    jstate, jres = _jax_physics(jenv._bank, jstate, jnp.asarray(action_vec))
    tb = tenv._bank
    lid = tstate.layout_id.long()
    room = t_room_of_point(tb, tstate.layout_id, tstate.pos[:, [0, 2]])
    tstate, tres = tphys.physics_step(
        tb.proto_pickable[lid], tstate, torch.from_numpy(action_vec),
        segs4=tb.room_segs[lid, room], max_forward_step=0.17, fwd_step=0.15,
        fwd_drift=0.0, turn_step=15.0, agent_radius=0.4)
    for name in ("moved", "picked_up", "dropped"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)), err_msg=name)
    return jstate, tstate


@pytest.mark.parametrize("action", range(6))
def test_physics_step_discrete(envs, action):
    """Each row of the discrete table, 12 steps in a row (walls and the
    goal box get hit along the way)."""
    jenv, tenv = envs
    jkeys, _ = _keys(action)
    jstate = jenv._reset_jit(jenv._bank, jkeys)
    tstate = to_port_state(jstate)
    vec = np.repeat(np.asarray(jenv.spec.discrete_actions)[action][None], B, 0)
    for _ in range(12):
        jstate, tstate = _physics_both(jenv, tenv, jstate, tstate, vec)
        assert_states_match(jstate, tstate)


def test_physics_carry(envs):
    """Pickup, carried moves and turns, then drop, from an agent placed
    facing the goal box."""
    jenv, tenv = envs
    jkeys, _ = _keys(5)
    jstate = jenv._reset_jit(jenv._bank, jkeys)
    box = np.asarray(jstate.ent_pos)[:, 0]
    pos = box - np.array([0.9, 0.0, 0.0], np.float32)
    jstate = jstate.replace(pos=jnp.asarray(pos), dir=jnp.zeros(B, jnp.float32))
    tstate = to_port_state(jstate)
    seq = [
        [0, 0, 0, 0, 1, 0],  # pickup
        [1, 0, 0, 0, 0, 0],  # forward, carrying
        [0, 0, 1, 0, 0, 0],  # turn, carrying
        [-1, 0.5, -1, 0.3, 0, 0],  # mixed, carrying
        [0, 0, 0, 0, 0, 1],  # drop
    ]
    carried = []
    for a in seq:
        vec = np.repeat(np.asarray(a, np.float32)[None], B, 0)
        jstate, tstate = _physics_both(jenv, tenv, jstate, tstate, vec)
        assert_states_match(jstate, tstate)
        carried.append(int((tstate.carrying >= 0).sum()))
    assert carried[0] > 0 and carried[-1] == 0, carried


@pytest.mark.parametrize("action", range(6))
def test_step_with_auto_reset(envs, action):
    """The whole per-env step (physics, goal transition, truncation and
    auto-reset) against _step_one: rewards and dones exact."""
    jenv, tenv = envs
    jkeys, _ = _keys(40 + action)
    jstate = jenv._reset_jit(jenv._bank, jkeys)
    # near the step limit and next to the goal, so both done paths fire
    sc = np.where(np.arange(B) % 2 == 0, 249, 10).astype(np.int32)
    box = np.asarray(jstate.ent_pos)[:, 0]
    pos = np.where((np.arange(B) % 3 == 0)[:, None], box - [0.9, 0, 0],
                   np.asarray(jstate.pos)).astype(np.float32)
    jstate = jstate.replace(step_count=jnp.asarray(sc), pos=jnp.asarray(pos))
    tstate = to_port_state(jstate)
    acts = np.full(B, action, np.int32)
    jstate, jr, jd, _ = jenv._step_jit(jenv._bank, jstate, jnp.asarray(acts))
    tstate, tr, td, _ = tenv._step_batch(tstate, torch.from_numpy(acts))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert np.asarray(jd).any()
    assert_states_match(jstate, tstate)

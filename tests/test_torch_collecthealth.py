"""CollectHealth on the port against the JAX package, at B=4, 32x24:
18 medkit meshes on a slime floor, health draining 2 a step, the raw
6-D actions, and the kit respawn inside the step (``place_one`` against
the other live kits and the agent).

Reset and 8 steps of uniform action vectors (``reset_and_steps``,
following the JAX state: XLA:CPU fuses some multiply-adds of the
fractional actions, ROADMAP C1); a forced sequence that faces a kit,
walks, presses pickup (the kit is picked up and put back elsewhere, the
health restored to 100) and presses it again, with two envs dying at
health 2, state for state; a rollout from a key equal to JAX's
``rollout``; and the CPU ``place_one`` on CollectHealth's bank with the
respawn's obstacle list, the budget exhausted included, equal to the JAX
``place_one``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu import vector as jvector
from miniworld_tpu.ops import place as jplace, rng as jrng
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.ops import place as tplace, rng as trng

from _torch_parity import (
    FLOAT_ATOL, assert_images_match, assert_states_match, facing, reset_and_steps,
    to_port_state,
)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B, W, H = 4, 32, 24
ENV_ID = "MiniWorld-CollectHealth-v0"



@pytest.fixture(scope="module")
def envs():
    return (JaxVec(ENV_ID, num_envs=B, obs_width=W, obs_height=H),
            MiniWorldVec(ENV_ID, B, obs_width=W, obs_height=H, device="cpu"))


def test_reset_and_steps(envs):
    jenv, tenv = envs
    assert tenv._action_table is None and tenv.spec.num_kits == 18
    dones, rewards, j_info, t_info = reset_and_steps(ENV_ID, B, W, H, 8, seed=21,
                                                     follow_jax=True, envs=envs)
    assert dones == 0 and rewards == 2.0 * B * 8
    np.testing.assert_array_equal(t_info["health"].numpy(), np.asarray(j_info["health"]))


def test_respawn_and_death_match_jax(envs):
    """Each agent 0.8 m from a kit, facing it; envs 2 and 3 at health 2.
    Step 1 (forward 0.1): envs 2 and 3 die (-100, done, reset to health
    100), the others drain to 98. Step 2 (pickup in envs 0 and 1): the
    kit in front is picked up and re-placed in the same step, carrying
    back at -1 and health at 100. Step 3 (pickup again, nothing in
    reach): health 98. Envs 2 and 3 stand still after their reset."""
    jenv, tenv = envs
    jstate, _ = jenv.reset(jax.random.key(8))
    pos, yaw = facing(jenv, jstate, 0, 0.8)
    health = jnp.asarray([100, 100, 2, 2], jnp.int32)
    jstate = jstate.replace(pos=jnp.asarray(pos, jnp.float32), dir=jnp.asarray(yaw, jnp.float32),
                            task={"health": health})
    tstate = to_port_state(jstate)
    plan = [[0.1, 0, 0, 0, 0, 0], [0, 0, 0, 0, 1, 0], [0, 0, 0, 0, 1, 0]]
    want_health = [[98, 98, 100, 100], [100, 100, 98, 98], [98, 98, 96, 96]]
    want_reward = [[2.0, 2.0, -100.0, -100.0], [2.0] * 4, [2.0] * 4]
    for i, act in enumerate(plan):
        before = np.asarray(jstate.ent_pos)
        acts = np.tile(np.asarray(act, np.float32), (B, 1))
        acts[2:] = plan[0] if i == 0 else 0.0
        jstate, (j_rgb, j_d), j_r, j_done, j_info = jenv.step(jstate, jnp.asarray(acts))
        tstate, _, t_r, t_done, t_info = tenv.step(tstate, torch.from_numpy(acts))
        np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
        np.testing.assert_array_equal(t_r.numpy(), want_reward[i])
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
        np.testing.assert_array_equal(tstate.task["health"].numpy(), want_health[i])
        np.testing.assert_array_equal(tstate.task["health"].numpy(),
                                      np.asarray(jstate.task["health"]))
        np.testing.assert_array_equal(t_info["health"].numpy(), np.asarray(j_info["health"]))
        np.testing.assert_array_equal(tstate.carrying.numpy(), np.asarray(jstate.carrying))
        assert_states_match(jstate, tstate)
        if i == 1:  # one kit moved in envs 0 and 1, none in the others
            moved = (np.abs(np.asarray(jstate.ent_pos) - before) > FLOAT_ATOL).any(-1)
            np.testing.assert_array_equal(moved.sum(1), [1, 1, 0, 0])
            assert (np.asarray(jstate.carrying) == -1).all()
            moved_t = (np.abs(tstate.ent_pos.numpy() - before) > FLOAT_ATOL).any(-1)
            np.testing.assert_array_equal(moved_t, moved)
        tstate = to_port_state(jstate)
        assert_images_match(j_rgb, j_d, *tenv.render(tstate))


def test_rollout_matches_jax(envs):
    """A 4-step rollout from one key: rewards, dones and checksums equal
    JAX's ``rollout``."""
    jenv, tenv = envs
    jstate, jobs = jenv.reset(jax.random.key(2))
    tstate, tobs = tenv.reset(2)
    _, _, j_out = jenv.rollout(jstate, jobs, jax.random.key(6), 4)
    _, _, t_out = tenv.rollout(tstate, tobs, trng.key_data(6), 4)
    for k in ("reward", "dones", "obs_sum"):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]).astype(
            t_out[k].numpy().dtype), err_msg=k)


@pytest.mark.parametrize("budget,scale", [(16, 1.0), (16, 6.0), (2, 12.0)],
                         ids=["respawn", "large", "exhausted"])
def test_place_one_with_obstacles(envs, budget, scale):
    """The respawn's placement of kit slot 3 on a reset's state: the
    other live kits and the agent (at the agent's radius) as obstacles,
    the kit's radius scaled by ``scale`` (12 with budget 2: the tries
    fail and the clamped fallback places it), equal to JAX's place_one."""
    jenv, tenv = envs
    jstate, _ = jenv.reset(jax.random.key(4))
    keys = jax.random.split(jax.random.key(9), B)
    j_seed = jax.vmap(jrng.cheap_seed)(keys)
    slot, E = 3, 18
    ent_xz = np.concatenate([np.asarray(jstate.ent_pos)[:, :, [0, 2]],
                             np.asarray(jstate.pos)[:, None, [0, 2]]], axis=1)
    ent_r = np.concatenate([np.asarray(jstate.ent_radius),
                            np.full((B, 1), jenv.spec.agent_radius, np.float32)], axis=1)
    mask = np.concatenate([np.asarray(jstate.ent_alive) & (np.arange(E) != slot),
                           np.ones((B, 1), bool)], axis=1)
    radius = np.asarray(jstate.ent_radius)[:, slot] * np.float32(scale)
    bank_np = jenv._bank_np
    rule = {k: getattr(bank_np, k)[0, slot, 0] for k in tplace.RULE_FIELDS}

    def one(seed, r, xz, rr, m):
        lay = jvector.lay_view(jenv._bank, jnp.int32(0))
        return jplace.place_one(seed, lay, jenv._bank.room_segs, jnp.int32(0),
                                *[jnp.asarray(rule[k]) for k in tplace.RULE_FIELDS], r, xz,
                                rr, m, budget=budget)

    j_pos, j_dir = jax.jit(jax.vmap(one))(j_seed, jnp.asarray(radius), jnp.asarray(ent_xz),
                                           jnp.asarray(ent_r), jnp.asarray(mask))
    t_seed = trng.cheap_seed(torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(
        np.int64)))

    def rep(x):
        t = torch.as_tensor(np.asarray(x))
        return t.expand((B,) + tuple(t.shape)).clone()

    args = (t_seed, tenv._bank, torch.zeros(B, dtype=torch.int32),
            *[rep(rule[k]) for k in tplace.RULE_FIELDS], torch.from_numpy(radius),
            torch.from_numpy(ent_xz), torch.from_numpy(ent_r), torch.from_numpy(mask))
    t_pos, t_dir = tplace.place_one(*args, budget=budget)
    first = tplace._place_one(*args, budget=budget)[2]
    if scale == 12.0:
        assert bool((first == budget).all()), first
    else:
        assert bool((first < budget).all()), first
    np.testing.assert_allclose(t_pos.numpy(), np.asarray(j_pos), rtol=0, atol=FLOAT_ATOL)
    np.testing.assert_allclose(t_dir.numpy(), np.asarray(j_dir), rtol=0, atol=FLOAT_ATOL)

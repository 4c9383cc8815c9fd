"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages run on the CPU in one process; data crosses between them
as numpy arrays through ``miniworld_tpu_torch.convert``.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from miniworld_tpu_torch.convert import state_from_numpy, state_to_numpy
from miniworld_tpu_torch.state import tree_select

ENV_ID = "MiniWorld-Hallway-v0"
W, H = 80, 60

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for the module that imports this fixture (every
    tests/test_torch_*.py does). The parity tests' CPU ops are small, and
    a thread per core in each of the suite's six worker processes
    oversubscribes the machine: six concurrent processes of one such
    test take about twice as long with torch's default threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Tolerances of the parity contract (ROADMAP queue A):
FLOAT_ATOL = 1e-5  # state floats
DEPTH_RTOL = 1e-5  # depth, where both pick the same winner
MAX_WINNER_DIFF = 1e-3  # fraction of pixels whose winner differs
MAX_RGB_DIFF = 2  # u8 levels, on pixels whose winner agrees


def jax_state_arrays(state) -> tuple[dict, np.ndarray]:
    """(field -> numpy, key data) of a batched JAX EnvState."""
    fields = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "rng" or v is None:
            continue
        if f.name == "task":
            fields["task"] = {k: np.asarray(a) for k, a in v.items()}
        else:
            fields[f.name] = np.asarray(v)
    return fields, np.asarray(jax.random.key_data(state.rng))


def to_port_state(state):
    """The port's EnvState holding the same values as a JAX EnvState."""
    fields, key_data = jax_state_arrays(state)
    return state_from_numpy(fields, key_data)


def assert_states_match(jstate, tstate, atol: float = FLOAT_ATOL):
    """Ints, bools and key data exact; floats within ``atol``."""
    fields, key_data = jax_state_arrays(jstate)
    port = state_to_numpy(tstate)
    np.testing.assert_array_equal(port["rng"], key_data.astype(np.int64))
    for name, want in fields.items():
        if name == "task":
            continue
        got = port[name]
        assert got.shape == want.shape, (name, got.shape, want.shape)
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


def assert_images_match(j_rgb, j_depth, t_rgb, t_depth):
    """Depth equality (rtol DEPTH_RTOL) stands for 'same winner': it may
    fail on at most MAX_WINNER_DIFF of the pixels, and RGB is within
    MAX_RGB_DIFF u8 levels everywhere else. Returns the stats."""
    j_rgb = np.asarray(j_rgb).astype(np.int32)
    j_depth = np.asarray(j_depth)[..., 0]
    t_rgb = t_rgb.numpy().astype(np.int32)
    t_depth = t_depth.numpy()[..., 0]
    assert t_rgb.shape == j_rgb.shape and t_depth.shape == j_depth.shape
    same = np.isclose(t_depth, j_depth, rtol=DEPTH_RTOL, atol=0)
    differ = 1.0 - same.mean()
    rgb_err = int(np.abs(t_rgb - j_rgb).max(-1)[same].max(initial=0))
    assert differ <= MAX_WINNER_DIFF, f"winner differs on {differ:.4%} of pixels"
    assert rgb_err <= MAX_RGB_DIFF, f"rgb differs by {rgb_err} levels"
    return differ, rgb_err


def split_obs(j_obs, t_obs):
    """(JAX image, port image) of two observations: a dict observation
    (Sign's {"obs": image, "goal": (B,) int32}) must be one in both
    packages, with the same keys and an equal ``goal``."""
    if not isinstance(j_obs, dict):
        assert not isinstance(t_obs, dict)
        return j_obs, t_obs
    assert isinstance(t_obs, dict) and set(t_obs) == set(j_obs) == {"obs", "goal"}
    goal = np.asarray(j_obs["goal"])
    assert t_obs["goal"].dtype == torch.int32 and t_obs["goal"].shape == goal.shape
    np.testing.assert_array_equal(t_obs["goal"].numpy(), goal)
    return j_obs["obs"], t_obs["obs"]


def facing(jenv, jstate, slot, dist):
    """(pos, dir) that put each agent ``dist`` from entity ``slot`` along
    x, on the side of the entity's room centre, facing it."""
    bank = jenv._bank_np
    target = np.asarray(jstate.ent_pos)[:, slot]
    aabb = bank.room_aabb[0][bank.room_mask[0]]  # (R, 4) [min_x, max_x, min_z, max_z]
    pos, yaw = [], []
    for p in target:
        inside = ((aabb[:, 0] <= p[0]) & (p[0] <= aabb[:, 1])
                  & (aabb[:, 2] <= p[2]) & (p[2] <= aabb[:, 3]))
        room = aabb[np.argmax(inside)]
        side = 1.0 if p[0] > 0.5 * (room[0] + room[1]) else -1.0  # stand towards the centre
        pos.append(p - [side * dist, 0.0, 0.0])
        yaw.append(0.0 if side > 0 else np.pi)  # forward is (cos d, 0, -sin d)
    return np.asarray(pos), np.asarray(yaw)


def adopt_reset_ulps(jstate, tstate, done):
    """The port's state after a step whose ``done`` envs auto-reset, with
    the envs whose reset state differs from the JAX one continuing from
    the JAX state.

    XLA:CPU fuses the JAX placement's multiply-add in some placements
    and not in others, so the agent's reset position can differ by one
    ulp, which a wall edge's quantized depth shows on every later frame.
    Only that difference is allowed; envs whose reset matched bit for
    bit keep the port's own state.
    """
    b = tstate.pos.shape[0]
    jport = to_port_state(jstate)
    differs = torch.zeros(b, dtype=torch.bool)
    for name, v in jport.tensors().items():
        ne = (v != tstate.tensors()[name]).reshape(b, -1).any(dim=1)
        assert name == "pos" or not bool(ne.any()), name
        differs |= ne
    one_ulp = torch.nextafter(tstate.pos, jport.pos)
    assert torch.equal(one_ulp, jport.pos), "reset positions differ by more than one ulp"
    swap = torch.from_numpy(np.array(done)) & differs
    return tree_select(swap, jport, tstate)


def reset_and_steps(env_id, b, w, h, steps, seed, start=None, forced_action=2,
                    frames=None, follow_jax=False, envs=None, **env_kwargs):
    """Reset the JAX package's env and the port's at (b, w, h) from
    ``seed`` and step both ``steps`` times with the same actions, checking
    as tests/test_torch_vector.py::test_reset_and_ten_steps does: rewards,
    dones, step counts, layouts, info and task state exact, states within
    FLOAT_ATOL, images by ``assert_images_match``. ``start(jenv, jstate)``
    may return (pos (b, 3), yaw (b,), forced (b,) bool) to move the
    agents after the reset; forced envs take ``forced_action`` (an int,
    or one per env) every step; an env without a discrete table (the
    raw 6-D actions) steps with uniform vectors in the action box, its
    forced envs with the vector ``forced_action``; an env that resets goes on from the JAX
    package's reset state. A dict observation's goal must be equal and
    its images are compared (``split_obs``). ``frames``, a list, gets
    (port state, JAX rgb, JAX depth, port rgb, port depth) of every step.
    ``follow_jax``: after each step's checks the port goes on from the JAX
    state, and its image is the render of that state (the raw 6-D
    actions: XLA:CPU fuses some of their multiply-adds, moving states by
    ulps a step, ROADMAP C1; the states are still held within
    FLOAT_ATOL). ``env_kwargs`` go to both constructors; ``envs`` = (JAX
    env, port env) built already at (b, w, h) takes their place.
    Returns (dones, total reward, the last infos of JAX and the port)."""
    from miniworld_tpu import MiniWorldVec as JaxVec
    from miniworld_tpu_torch import MiniWorldVec

    import jax.numpy as jnp

    if envs is None:
        env = MiniWorldVec(env_id, b, obs_width=w, obs_height=h, device="cpu", **env_kwargs)
        jenv = JaxVec(env_id, num_envs=b, obs_width=w, obs_height=h, **env_kwargs)
    else:
        jenv, env = envs
    jstate, (j_rgb, j_depth) = jenv.reset(jax.random.key(seed))
    tstate, (t_rgb, t_depth) = env.reset(seed)
    assert_states_match(jstate, tstate)
    j_img, t_img = split_obs(j_rgb, t_rgb)
    assert_images_match(j_img, j_depth, t_img, t_depth)
    forced = np.zeros(b, bool)
    if start is not None:
        pos, yaw, forced = start(jenv, jstate)
        jstate = jstate.replace(pos=jnp.asarray(pos, jnp.float32),
                                dir=jnp.asarray(yaw, jnp.float32))
        tstate = to_port_state(jstate)
    rng = np.random.default_rng(seed)
    dones, rewards = 0, 0.0
    for _ in range(steps):
        if env._action_table is None:
            acts = rng.uniform([-1, -1, -1, -1, 0, 0], 1.0, (b, 6)).astype(np.float32)
            acts = np.where(forced[:, None], np.asarray(forced_action, np.float32), acts)
        else:
            acts = np.where(forced, forced_action,
                            rng.integers(0, env._action_table.shape[0], b)).astype(np.int32)
        jstate, (j_rgb, j_depth), j_r, j_d, j_info = jenv.step(jstate, jnp.asarray(acts))
        tstate, (t_rgb, t_depth), t_r, t_d, t_info = env.step(tstate, torch.from_numpy(acts))
        np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
        np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
        np.testing.assert_array_equal(tstate.step_count.numpy(), np.asarray(jstate.step_count))
        np.testing.assert_array_equal(tstate.layout_id.numpy(), np.asarray(jstate.layout_id))
        assert set(t_info) == set(j_info)
        for k in ("termination", "truncation"):
            np.testing.assert_array_equal(t_info[k].numpy(), np.asarray(j_info[k]))
        for k in set(j_info) - {"termination", "truncation"}:
            np.testing.assert_allclose(t_info[k].numpy(), np.asarray(j_info[k]), rtol=0,
                                       atol=FLOAT_ATOL, err_msg=k)
        assert set(tstate.task) == set(jstate.task)
        for k, v in jstate.task.items():
            np.testing.assert_array_equal(tstate.task[k].numpy(), np.asarray(v), err_msg=k)
        assert_states_match(jstate, tstate)
        if follow_jax:
            tstate = to_port_state(jstate)
            t_rgb, t_depth = env._obs(tstate)[0]
        j_img, t_img = split_obs(j_rgb, t_rgb)
        assert_images_match(j_img, j_depth, t_img, t_depth)
        if frames is not None:
            frames.append((tstate, j_img, j_depth, t_img, t_depth))
        dones += int(t_d.sum())
        rewards += float(t_r.sum())
        if bool(t_d.any()):
            # the resets agree within FLOAT_ATOL (checked above), but
            # XLA:CPU's fused multiply-adds move placed positions and
            # directions by an ulp or two (ROADMAP C1), which a later
            # frame's quantized depth shows: the envs that reset go on
            # from the JAX state
            tstate = tree_select(torch.from_numpy(np.array(j_d)), to_port_state(jstate), tstate)
    assert t_img.shape == (b, h, w, 3) and t_depth.shape == (b, h, w, 1)
    return dones, rewards, j_info, t_info


def drop_paired(bank_np, tex_np):
    """The super bank without its paired rows (``vector.drop_paired_rows``,
    any package's bank), and its texture table."""
    from miniworld_tpu_torch.vector import drop_paired_rows

    return drop_paired_rows(bank_np), tex_np


def installed_pair(env_id, b, w, h, transform, tri_chunk=None, **env_kwargs):
    """(JAX env, port env) at (b, w, h), each package's own bank and
    texture table passed through ``transform(bank, tex) -> (bank, tex)``
    and installed afresh: the JAX env's ``_install_bank(..., fresh=True)``
    with its constructor's chunk cap, the port's ``install_fresh``."""
    from miniworld_tpu import MiniWorldVec as JaxVec
    from miniworld_tpu import vector as jvector
    from miniworld_tpu_torch import MiniWorldVec
    from miniworld_tpu_torch import vector as tvector

    jenv = JaxVec(env_id, num_envs=b, obs_width=w, obs_height=h, tri_chunk=tri_chunk,
                  **env_kwargs)
    env = MiniWorldVec(env_id, b, obs_width=w, obs_height=h, device="cpu", tri_chunk=tri_chunk,
                       **env_kwargs)
    if jenv.procgen:
        jbank, jtex, _ = jvector.build_super_bank(jenv.spec, jenv.tex_mode, jenv.fourier_k)
        bank, tex = tvector.build_super_bank(env.spec, env.tex_mode, env.fourier_k)
    else:
        jbank, jtex, _ = jvector.build_bank(jenv.spec, 0, jenv.tex_mode, jenv.fourier_k)
        bank, tex = tvector.build_bank(env.spec, env.tex_mode, fourier_k=env.fourier_k)
    jenv.tri_chunk = max(16, min(tri_chunk or jenv._chunk_cap, jenv._chunk_cap))
    jenv._chunk_vis = jenv._sched_len = None
    jenv._install_bank(*transform(jbank, jtex), fresh=True)
    jenv._make_jits()
    env.install_fresh(*transform(bank, tex))
    assert env.tri_chunk == jenv.tri_chunk
    return jenv, env

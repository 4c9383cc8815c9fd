"""The port's gymnasium adapter renders as the JAX package's adapter does,
at 24x18 on the CPU: the agent's RGB-D view, the ``view="top"``
observation, ``render_top_view(return_scale=True)`` and
``get_visible_ents`` on six ids, episode by episode; the chunk plan of
the adapter's render (``gym_env.render_statics``), also with mesh rows
over several chunks (the schedule route, forced with small chunks)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_parity import assert_images_match, one_torch_thread  # noqa: F401
from miniworld_tpu.gym_env import MiniWorldGym as JaxGym
from miniworld_tpu_torch.gym_env import MiniWorldGym, SingleEnv, render_statics

W, H = 24, 18
STEPS = 5
IDS = ["Hallway", "PickupObjects", "Sign", "MazeS2", "CollectHealth", "CameraControlClick"]


def _img(obs):
    return obs["obs"] if isinstance(obs, dict) else obs


def _assert_frames(j_rgb, j_depth, t_rgb, t_depth):
    """tests/_torch_parity.assert_images_match on one frame."""
    assert_images_match(j_rgb[None], j_depth[None], torch.from_numpy(t_rgb)[None],
                        torch.from_numpy(t_depth)[None])


@pytest.fixture(scope="module", params=IDS)
def envs(request):
    """(JAX adapter, port adapter) of one id, and its (view="top") pair."""
    name = request.param
    return (name, JaxGym(name, obs_width=W, obs_height=H),
            MiniWorldGym(name, obs_width=W, obs_height=H, device="cpu"),
            JaxGym(name, obs_width=W, obs_height=H, view="top"),
            MiniWorldGym(name, obs_width=W, obs_height=H, device="cpu", view="top"))


def _actions(space, n, seed=3):
    rng = np.random.default_rng(seed)
    if hasattr(space, "n"):
        return [int(a) for a in rng.integers(0, space.n, n)]
    return list(rng.uniform(space.low, space.high, (n,) + space.shape).astype(np.float32))


def test_agent_view(envs):
    """Observations after reset and each step, and render_depth: winners
    (depth within 1e-5) on at least 99.9% of pixels, RGB within 2 levels
    where they agree; the camera ids' crosshair drawn by the host hook."""
    name, jenv, env, _, _ = envs
    j_obs, _ = jenv.reset(seed=11)
    t_obs, _ = env.reset(seed=11)
    for a in [None] + _actions(jenv.action_space, STEPS):
        if a is not None:
            j_obs = jenv.step(a)[0]
            t_obs = env.step(a)[0]
        j_rgb, j_depth = jenv.render_depth()
        t_rgb, t_depth = env.render_depth()
        assert t_rgb.dtype == np.uint8 and t_depth.dtype == np.float32
        _assert_frames(j_rgb, j_depth, t_rgb, t_depth)
        _assert_frames(_img(j_obs), j_depth, _img(t_obs), t_depth)
        if isinstance(j_obs, dict):
            assert t_obs["goal"] == j_obs["goal"]


def test_top_view(envs):
    """The view="top" observation (and its depth), and render_top_view
    with and without the agent, with its world-to-pixel scale."""
    name, jenv, env, jtop, top = envs
    j_obs, _ = jtop.reset(seed=13)
    t_obs, _ = top.reset(seed=13)
    jenv.reset(seed=13)
    env.reset(seed=13)
    for a in [None] + _actions(jtop.action_space, 2, seed=4):
        if a is not None:
            j_obs = jtop.step(a)[0]
            t_obs = top.step(a)[0]
            jenv.step(a)
            env.step(a)
        j_rgb, j_depth = jtop.render_depth()
        t_rgb, t_depth = top.render_depth()
        _assert_frames(j_rgb, j_depth, t_rgb, t_depth)
        _assert_frames(_img(j_obs), j_depth, _img(t_obs), t_depth)
        j_img, j_scale = jenv.render_top_view(return_scale=True)
        t_img, t_scale = env.render_top_view(return_scale=True)
        assert t_scale == j_scale
        np.testing.assert_array_equal(t_img, j_img)
        np.testing.assert_array_equal(env.render_top_view(32, 24, render_agent=False),
                                      jenv.render_top_view(32, 24, render_agent=False))


def test_visible_ents(envs):
    """get_visible_ents: the same entities (by slot) after each step."""
    name, jenv, env, _, _ = envs
    jenv.reset(seed=17)
    env.reset(seed=17)
    for a in [None] + _actions(jenv.action_space, STEPS, seed=5):
        if a is not None:
            jenv.step(a)
            env.step(a)
        want = sorted(e.slot_idx for e in jenv.get_visible_ents())
        got = sorted(e.slot_idx for e in env.get_visible_ents())
        assert got == want, name
    # the agent 2 m from entity 0, facing it and looking 20 degrees down,
    # from the first of 8 sides where the JAX adapter sees it
    target = jenv.entities[0].pos
    for k in range(8):
        d = np.array([np.cos(k * np.pi / 4), 0.0, np.sin(k * np.pi / 4)])
        for e in (jenv, env):
            e.agent_pos = target + 2.0 * d
            e.agent_dir = float(np.arctan2(d[2], -d[0]))  # forward (cos, 0, -sin) = -d
            e.cam_pitch = -20.0
        want = sorted(e.slot_idx for e in jenv.get_visible_ents())
        got = env.get_visible_ents()
        assert sorted(e.slot_idx for e in got) == want, (name, k)
        if 0 in want:
            break
    assert 0 in want, name
    assert all(e in env.entities for e in got)


@pytest.mark.parametrize("name,n_chunks,mesh", [("Sidewalk", 22, False), ("WallGap", 10, False),
                                                ("Maze", 4, False), ("PickupObjects", None, True)])
def test_chunk_plan(name, n_chunks, mesh):
    """The JAX adapter's split: S bucketed to 64 in chunks of 128 from
    the clamped starts (Sidewalk's 2,752 rows: 22 chunks, the last at
    2,624), one chunk up to 128 rows; the 8x8 Maze's 381 slots carry in
    float32 (no mesh rows there)."""
    env = SingleEnv(name, obs_width=W, obs_height=H, device="cpu", skip_obs=True)
    env.reset(seed=0)
    st = env.render_statics()
    s = st.bank.tri_verts9.shape[2]
    assert s % 64 == 0 and st.mesh == mesh
    if n_chunks is None:
        assert s <= 128 and st.plan is None
    else:
        assert st.plan["nc"] == n_chunks and st.plan["chunk_starts"][-1] == s - 128
        assert st.bank.pvs_v9_rows is None


@pytest.mark.parametrize("name", ["Sidewalk", "Maze"])
def test_multi_chunk_frames(name):
    """The multi-chunk scan (Sidewalk's 22 chunks; the Maze's 4 with the
    float32 carry) and the top view at 80x60 match the JAX adapter."""
    jenv = JaxGym(name, obs_width=W, obs_height=H)
    env = MiniWorldGym(name, obs_width=W, obs_height=H, device="cpu")
    jenv.reset(seed=2)
    env.reset(seed=2)
    for a in (None, 2):
        if a is not None:
            jenv.step(a)
            env.step(a)
        _assert_frames(*jenv.render_depth(), *env.render_depth())
    np.testing.assert_array_equal(env.render_top_view(80, 60), jenv.render_top_view(80, 60))


@pytest.mark.parametrize("name,tri_chunk", [("PickupObjects", 16), ("ThreeRooms", 24)])
def test_mesh_rows_over_chunks(name, tri_chunk):
    """Mesh rows with the prims in several chunks take the schedule of
    the clamped chunks, seeded by the mesh pass: the port's plan at a
    small chunk against JAX's render_rgbd at that tri_chunk on the JAX
    adapter's bank and state (the 27 ids' worlds fit one chunk of 128
    where they have mesh entities)."""
    import jax

    from miniworld_tpu.render.raycast import render_rgbd

    jenv = JaxGym(name, obs_width=W, obs_height=H)
    env = SingleEnv(name, obs_width=W, obs_height=H, device="cpu")
    jenv.reset(seed=4)
    env.reset(seed=4)
    env._statics = render_statics(env.world, "cpu", tri_chunk)
    st = env.render_statics()
    s = st.bank.tri_verts9.shape[2]
    assert st.mesh and st.plan["nc"] == -(-s // tri_chunk)
    assert st.bank.pvs_v9_rows.shape == (st.plan["nc"], 9 * tri_chunk)
    f = jax.jit(lambda bank, atlas, state: render_rgbd(
        bank, state, {"mode": "nearest", "atlas": atlas}, width=W, height=H,
        tri_chunk=tri_chunk))
    for a in (None, 2, 1, 2):
        if a is not None:
            jenv.step(a)
            env.step(a)
        j_rgb, j_depth = f(*jenv._build_render_state())
        t_rgb, t_depth = env.render_agent_view()
        _assert_frames(np.asarray(j_rgb), np.asarray(j_depth), t_rgb.numpy(), t_depth.numpy())

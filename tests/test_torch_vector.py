"""The port's slices as a whole against the JAX package: reset and 10
steps at B=8, 80x60, for every ported env, plus the port's own rollout,
its import hygiene and its refusals."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu_torch import MiniWorldVec, make_spec
from miniworld_tpu_torch.ops import mazegen, place as tplace, rng as trng
from miniworld_tpu_torch.render import cuda_build, raycast as trc

from _torch_parity import (
    ENV_ID, FLOAT_ATOL, H, W, adopt_reset_ulps, assert_images_match, assert_states_match,
    facing, to_port_state,
)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_env():
    return MiniWorldVec(ENV_ID, B, obs_width=W, obs_height=H, device="cpu")


@pytest.fixture(scope="module")
def jax_env():
    """JAX's Hallway at (B, W, H), its programs compiled once for the
    module's tests."""
    return JaxVec(ENV_ID, num_envs=B, obs_width=W, obs_height=H)


PICK_ID = "MiniWorld-PickupObjects-v0"
RESET_ENVS = ["MiniWorld-Hallway-v0", "MiniWorld-FourRooms-v0", "MiniWorld-TMaze-v0", PICK_ID]


@pytest.mark.parametrize("env_id", RESET_ENVS)
def test_reset_and_ten_steps(port_env, jax_env, env_id):
    """Half the envs start in front of entity 0 — 1.5 m before the goal
    of the go-to envs, walking forward (their episodes end and
    auto-reset); just within PickupObjects' pickup probe, picking up
    (rewards, num_picked_up and ent_alive change)."""
    env = port_env if env_id == ENV_ID else MiniWorldVec(env_id, B, obs_width=W, obs_height=H,
                                                         device="cpu")
    jenv = jax_env if env_id == ENV_ID else JaxVec(env_id, num_envs=B, obs_width=W, obs_height=H)
    jstate, (j_rgb, j_depth) = jenv.reset(jax.random.key(21))
    tstate, (t_rgb, t_depth) = env.reset(21)
    assert_states_match(jstate, tstate)
    assert_images_match(j_rgb, j_depth, t_rgb, t_depth)
    pickup = env_id == PICK_ID
    dist = 1.5
    if pickup:  # the probe reaches 0.6 + 0.48 + the entity's radius ahead
        dist = 0.4 + float(np.asarray(jstate.ent_radius)[:, 0].max()) + 0.2
    pos, yaw = facing(jenv, jstate, 0, dist)
    near = np.arange(B) < B // 2
    pos = np.where(near[:, None], pos, np.asarray(jstate.pos))
    jstate = jstate.replace(pos=jnp.asarray(pos, jnp.float32),
                            dir=jnp.where(jnp.asarray(near), jnp.asarray(yaw, jnp.float32),
                                          jstate.dir))
    tstate = to_port_state(jstate)
    rng = np.random.default_rng(21)
    n_act = env._action_table.shape[0]
    dones, rewards = 0, 0.0
    for _ in range(10):
        acts = rng.integers(0, n_act, B).astype(np.int32)
        acts[near] = 4 if pickup else 2  # pickup / forward
        jstate, (j_rgb, j_depth), j_r, j_d, j_info = jenv.step(jstate, jnp.asarray(acts))
        tstate, (t_rgb, t_depth), t_r, t_d, t_info = env.step(
            tstate, torch.from_numpy(acts))
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
        for k, v in jstate.task.items():
            np.testing.assert_array_equal(tstate.task[k].numpy(), np.asarray(v), err_msg=k)
        assert_states_match(jstate, tstate)
        assert_images_match(j_rgb, j_depth, t_rgb, t_depth)
        dones += int(t_d.sum())
        rewards += float(t_r.sum())
        if env_id != ENV_ID and bool(t_d.any()):
            tstate = adopt_reset_ulps(jstate, tstate, j_d)
    if pickup:
        assert rewards >= B // 2, rewards
        assert int(tstate.task["num_picked_up"].sum()) == int(rewards)
        assert not bool(tstate.ent_alive[near, 0].any())
    else:
        assert dones >= B // 2, dones
    assert t_rgb.shape == (B, H, W, 3) and t_depth.shape == (B, H, W, 1)


def test_rollout(port_env):
    state, obs = port_env.reset(0)
    outs = []
    for seed in (1, 2):
        s, o, out = port_env.rollout(state, obs, trng.key_data(seed), 4)
        assert set(out) == {"reward", "dones", "obs_sum"}
        for v in out.values():
            assert v.shape == (4,)
        assert o[0].shape == (B, H, W, 3) and o[1].shape == (B, H, W, 1)
        assert s.step_count.shape == (B,)
        outs.append(out["obs_sum"])
    assert not torch.equal(outs[0], outs[1]), "obs_sum must follow the key"
    # same key, same trajectory
    s, o, again = port_env.rollout(state, obs, trng.key_data(1), 4)
    assert torch.equal(again["obs_sum"], outs[0])


def test_rollout_matches_jax(port_env, jax_env):
    """The port's rollout from a key steps the JAX package's
    ``rollout(state, obs, key, horizon)``: Hallway at B=8, horizon 4,
    from the same reset; per-step reward, dones and obs_sum equal."""
    jenv = jax_env
    jstate, jobs = jenv.reset(jax.random.key(3))
    tstate, tobs = port_env.reset(3)
    for seed in (7, 8):
        _, _, j_out = jenv.rollout(jstate, jobs, jax.random.key(seed), 4)
        _, _, t_out = port_env.rollout(tstate, tobs, trng.key_data(seed), 4)
        for k in ("reward", "dones", "obs_sum"):
            np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]).astype(
                t_out[k].numpy().dtype), err_msg=k)


def test_without_depth():
    env = MiniWorldVec(ENV_ID, 2, obs_width=16, obs_height=12, with_depth=False,
                       device="cpu")
    _, obs = env.reset(0)
    assert isinstance(obs, torch.Tensor) and obs.shape == (2, 12, 16, 3)


def test_imports_no_jax_flax_pil():
    """The port runs resets and steps — Hallway, PickupObjects with its
    mesh loading, decimation and mesh-entity render, and MazeS3 with its
    super bank and maze generation (procgen) and its layout bank — without
    jax, flax or Pillow."""
    code = (
        "import sys, torch\n"
        "import miniworld_tpu_torch as m\n"
        "for name, kw in (('MiniWorld-Hallway-v0', {}), ('MiniWorld-PickupObjects-v0', {}),\n"
        "                 ('MiniWorld-MazeS3-v0', {}), ('MiniWorld-MazeS3-v0', {'procgen': False})):\n"
        "    env = m.MiniWorldVec(name, 2, obs_width=16, obs_height=12, device='cpu', **kw)\n"
        "    state, obs = env.reset(0)\n"
        "    env.step(state, torch.tensor([2, 4]))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'PIL', 'miniworld_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        MiniWorldVec(ENV_ID, 2, obs_width=16, obs_height=12, device="cuda")


def test_device_is_required():
    """The device defaults to the CUDA card; without one the constructor
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA"):
        MiniWorldVec(ENV_ID, 2)


def test_env_ids_match_jax():
    """The port registers the JAX package's 27 ids, each by gym id and
    short name."""
    from miniworld_tpu.envs import ENV_IDS as JAX_IDS
    from miniworld_tpu_torch.envs import ENV_IDS

    assert ENV_IDS == JAX_IDS and len(ENV_IDS) == 27
    for env_id in ENV_IDS:
        spec = make_spec(env_id)
        assert spec.gym_id == env_id and type(make_spec(spec.name)) is type(spec)


def test_unknown_env_raises():
    """An unknown name raises the JAX package's KeyError."""
    with pytest.raises(KeyError, match="unknown env"):
        make_spec("MiniWorld-NoSuchEnv-v0")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit, no kernels: the build raises instead of falling back."""
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(cuda_build, "_LIB", None)
    monkeypatch.setenv("MINIWORLD_TORCH_BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.load()


def test_wrappers_take_plain_on_cpu(port_env):
    """For CPU tensors each wrapper returns its plain version's result
    and launches nothing: the render's three stages (tri_pass also
    with mesh rows, against the mesh pass seeding it, and paired) and
    the reset's placement (also with a maze's room weights and gated
    segments) and maze generation."""
    state, _ = port_env.reset(5)
    bank = port_env._bank
    cam = trc.camera_grid(state, W, H)
    cuda_build.reset_launch_counts()
    t1, a1 = trc.tri_pass(bank.tri_verts9, bank.tri_attr, state.layout_id, cam, True)
    t2, a2 = trc.tri_pass_plain(bank.tri_verts9, bank.tri_attr, state.layout_id, cam, True)
    assert torch.equal(t1, t2) and torch.equal(a1, a2)
    ents = (state.ent_pos, state.ent_size, state.ent_dir, state.ent_height,
            state.ent_color, trc.entity_flags(bank, state))
    e1 = trc.entity_pass(*ents, cam, False, True)
    e2 = trc.entity_pass_plain(*ents, cam, False, True)
    assert all(torch.equal(x, y) for x, y in zip(e1, e2))
    lights = (state.light_pos, state.light_color, state.light_ambient, state.sky_color)
    r1 = trc.pixel_epilogue(t1, a1, *e1, port_env._atlas, cam, *lights, 16)
    r2 = trc.pixel_epilogue_plain(t1, a1, *e1, port_env._atlas, cam, *lights, 16)
    assert all(torch.equal(x, y) for x, y in zip(r1, r2))

    pick = MiniWorldVec(PICK_ID, 4, obs_width=W, obs_height=H, device="cpu")
    state, _ = pick.reset(5)
    bank = pick._bank
    cam = trc.camera_grid(state, W, H)
    rows9, attrs, _ = trc.entity_mesh_rows(bank, state)
    seed = trc.entity_mesh_pass_plain(rows9, attrs, cam)
    s1 = trc.tri_pass(bank.tri_verts9, bank.tri_attr, state.layout_id, cam, False,
                      mesh=(rows9, attrs))
    s2 = trc.tri_pass_plain(bank.tri_verts9, bank.tri_attr, state.layout_id, cam, False, seed)
    assert all(torch.equal(x, y) for x, y in zip(s1, s2))
    captured = {}

    def capture(*args, **kwargs):
        captured.update(args=args, kwargs=kwargs)
        return tplace.place_all_plain(*args, **kwargs)

    orig = tplace.place_all
    tplace.place_all = capture
    maze = MiniWorldVec("MiniWorld-MazeS3-v0", 4, obs_width=W, obs_height=H, device="cpu")
    try:
        for env in (pick, maze):
            env.reset(6)
            p1 = tplace.place_all(*captured["args"], **captured["kwargs"])
            p2 = tplace.place_all_plain(*captured["args"], **captured["kwargs"])
            assert all(torch.equal(x, y) for x, y in zip(p1, p2))
    finally:
        tplace.place_all = orig
    assert captured["kwargs"]["seg_gate"] is not None

    seed = torch.arange(4, dtype=torch.int64) * 977
    assert torch.equal(mazegen.gen_walls(seed, 3, 3), mazegen.gen_walls_plain(seed, 3, 3))
    state, _ = maze.reset(7)
    bank = maze._bank
    cam = trc.camera_grid(state, W, H)
    paired = (bank.pg_verts9_alt, bank.pg_attr_alt, maze._pg_wall, state.wall_open)
    q1 = trc.tri_pass(bank.pg_verts9, bank.pg_attr, state.layout_id, cam, True, None, paired)
    q2 = trc.tri_pass_plain(bank.pg_verts9, bank.pg_attr, state.layout_id, cam, True, None,
                            paired)
    assert all(torch.equal(x, y) for x, y in zip(q1, q2))
    assert not any(cuda_build.LAUNCHES.values())


@pytest.mark.parametrize("kwargs", [
    {"procgen": True}, {"tex_mode": "nearest"}, {"view": "top"},
])
def test_unported_statics_raise(kwargs):
    """procgen=True on Hallway, which has no maze grid, raises the JAX
    package's ValueError
    (tests/test_procgen.py::test_procgen_requires_maze_spec).
    tex_mode="nearest" and view="top", which raised until their slices,
    construct and render: the u8 atlas's texels, and the top view
    (tests/test_torch_nearest.py and tests/test_torch_topview*.py hold
    them against the JAX package)."""
    if "tex_mode" in kwargs:
        env = MiniWorldVec(ENV_ID, 2, obs_width=16, obs_height=12, device="cpu", **kwargs)
        _, (rgb, _) = env.reset(0)
        assert env._atlas.dtype == torch.uint8 and rgb.shape == (2, 12, 16, 3)
        return
    if "view" in kwargs:
        env = MiniWorldVec(ENV_ID, 2, obs_width=16, obs_height=12, device="cpu", **kwargs)
        _, (rgb, depth) = env.reset(0)
        assert env.view == "top" and rgb.shape == (2, 12, 16, 3)
        assert bool((depth < 100.0).any())  # the floor, seen from above
        return
    if "procgen" in kwargs:
        expect, match = ValueError, "maze-grid"
    else:
        expect, match = NotImplementedError, "not ported"
    with pytest.raises(expect, match=match):
        MiniWorldVec(ENV_ID, 2, obs_width=16, obs_height=12, device="cpu", **kwargs)

"""The port's gymnasium adapter (miniworld_tpu_torch/gym_env.py) against
the JAX package's (miniworld_tpu/gym_env.py): the float64 host physics
of all 27 ids bit for bit, the recorded goldens replayed bit-exactly
with no JAX in the loop, pickling, gymnasium's env checker, and the
action helpers. Renders: tests/test_torch_gym_render.py."""

from __future__ import annotations

import glob
import os
import pickle
import warnings

import numpy as np
import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from miniworld_tpu.gym_env import MiniWorldGym as JaxGym
from miniworld_tpu_torch.envs import ENV_IDS
from miniworld_tpu_torch.gym_env import MiniWorldGym, SingleEnv

W, H = 24, 18
STEPS = 20
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = sorted(glob.glob(os.path.join(HERE, "golden", "*.npz")))
REF_GOLDENS = sorted(glob.glob(os.path.join(HERE, "golden_ref", "*.npz")))
# tests/test_periphery.py's ENV_CHECK_IDS
ENV_CHECK_IDS = ["OneRoomS6Fast", "Hallway", "PutNext", "Sign", "CameraControlClick"]


def _actions(space, seed: int, n: int):
    """``n`` seeded actions of ``space``: indices, or vectors in the box."""
    rng = np.random.default_rng(seed)
    if hasattr(space, "n"):
        return [int(a) for a in rng.integers(0, space.n, n)]
    return list(rng.uniform(space.low, space.high, (n,) + space.shape).astype(np.float32))


def _assert_info_equal(got: dict, want: dict, context):
    assert set(got) == set(want), context
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_info_equal(got[k], v, context)
        else:
            assert type(np.asarray(got[k]).item(0)) is type(np.asarray(v).item(0)), (context, k)
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=f"{context} {k}")


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_physics_bit_exact(env_id):
    """Reset and ~20 seeded steps (discrete, 6-D or click actions):
    poses, yaw, pitch, rewards, terminations, truncations and info equal
    to the JAX adapter's bit for bit; an episode that ends resets both
    with the next seed."""
    name = env_id.split("-")[1]
    jenv = JaxGym(name, obs_width=W, obs_height=H, skip_obs=True)
    env = MiniWorldGym(name, obs_width=W, obs_height=H, skip_obs=True, device="cpu")
    seed = 7
    _, j_info = jenv.reset(seed=seed)
    _, t_info = env.reset(seed=seed)
    _assert_info_equal(t_info, j_info, f"{name} reset")
    for t, a in enumerate(_actions(jenv.action_space, seed, STEPS)):
        j = jenv.step(a)
        got = env.step(a)
        ctx = f"{name} step {t}"
        np.testing.assert_array_equal(env.agent_pos, jenv.agent_pos, err_msg=ctx)
        assert (env.agent_dir, env.cam_pitch) == (jenv.agent_dir, jenv.cam_pitch), ctx
        assert got[1:4] == j[1:4] and [type(x) for x in got[1:4]] == [type(x) for x in j[1:4]], ctx
        _assert_info_equal(got[4], j[4], ctx)
        assert [e.alive for e in env.entities] == [e.alive for e in jenv.entities], ctx
        for e_t, e_j in zip(env.entities, jenv.entities):
            np.testing.assert_array_equal(e_t.pos, e_j.pos, err_msg=ctx)
        if j[2] or j[3]:
            seed += 1
            jenv.reset(seed=seed)
            env.reset(seed=seed)
            np.testing.assert_array_equal(env.agent_pos, jenv.agent_pos, err_msg=ctx)


def _name_seed(path):
    base = os.path.basename(path)[:-4]
    name, seed = base.rsplit("_s", 1)
    return name, int(seed)


@pytest.mark.parametrize("path", GOLDENS, ids=[os.path.basename(p) for p in GOLDENS])
def test_golden_replay(path):
    """tests/golden (tests/test_golden.py:27-50), through the port alone."""
    name, seed = _name_seed(path)
    g = np.load(path)
    env = SingleEnv(name, obs_width=W, obs_height=H, device="cpu", skip_obs=True)
    env.reset(seed=seed)
    np.testing.assert_array_equal(env.agent_pos, g["spawn"])
    for t, a in enumerate(g["actions"]):
        _, r, term, trunc, _ = env.step(int(a) if np.ndim(a) == 0 else a)
        np.testing.assert_array_equal(env.agent_pos, g["poses"][t], err_msg=f"{name} step {t}")
        assert env.agent_dir == g["dirs"][t]
        assert r == g["rewards"][t]
        assert bool(term) == bool(g["terms"][t])
        if term or trunc:
            break


@pytest.mark.parametrize("path", REF_GOLDENS, ids=[os.path.basename(p) for p in REF_GOLDENS])
def test_reference_golden_replay(path):
    """tests/golden_ref, the reference package's recorded trajectories
    (tests/test_ref_parity.py): spawn, poses, yaw, pitch, rewards,
    terminations and truncations, through the port alone."""
    base = os.path.basename(path)[:-4]
    dr = base.endswith("_dr")
    name, seed = base[:-3].rsplit("_s", 1) if dr else base.rsplit("_s", 1)
    with np.load(path) as f:
        ref = {k: f[k] for k in f.files}
    env = SingleEnv(name, obs_width=W, obs_height=H, device="cpu", skip_obs=True,
                    domain_rand=dr)
    env.reset(seed=int(seed))
    np.testing.assert_array_equal(env.agent_pos, ref["spawn_pos"])
    assert env.agent_dir == ref["spawn_dir"]
    n = 0
    for t, a in enumerate(ref["actions"]):
        a = np.asarray(a)
        _, r, term, trunc, _ = env.step(int(a) if a.ndim == 0 else a)
        ctx = f"{base} step {t}"
        np.testing.assert_array_equal(env.agent_pos, ref["pos"][t], err_msg=ctx)
        assert (env.agent_dir, env.cam_pitch) == (ref["dir"][t], ref["pitch"][t]), ctx
        assert (float(r), bool(term), bool(trunc)) == (
            ref["reward"][t], bool(ref["term"][t]), bool(ref["trunc"][t])), ctx
        n += 1
        if term or trunc:
            break
    assert n == len(ref["pos"])


@pytest.mark.parametrize("name", ["Hallway", "Sign", "PickupObjects", "CameraControl"])
def test_pickle_env(name):
    """EzPickle round trip: the rebuilt env (same device) reproduces
    reset and step exactly (tests/test_periphery.py::test_pickle_env)."""
    env = MiniWorldGym(name, obs_width=W, obs_height=H, device="cpu")
    env.reset(seed=5)
    env2 = pickle.loads(pickle.dumps(env))
    assert env2.device == env.device and env2.obs_width == W
    outs = []
    for e in (env, env2):
        obs, info = e.reset(seed=9)
        outs.append((obs, info, e.step(0)))
    a, b = outs
    img = (lambda o: o["obs"] if isinstance(o, dict) else o)
    np.testing.assert_array_equal(img(a[0]), img(b[0]))
    np.testing.assert_array_equal(img(a[2][0]), img(b[2][0]))
    assert a[2][1:4] == b[2][1:4]
    _assert_info_equal(b[2][4], a[2][4], name)


@pytest.mark.parametrize("name", ENV_CHECK_IDS)
def test_env_checker(name):
    """gymnasium's conformance checker (tests/test_periphery.py:240)."""
    from gymnasium.utils.env_checker import check_env

    env = MiniWorldGym(name, obs_width=W, obs_height=H, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        check_env(env, skip_render_check=True)


def test_spaces_match_jax():
    """Action and observation spaces of every id equal the JAX adapter's."""
    for env_id in ENV_IDS:
        name = env_id.split("-")[1]
        jenv = JaxGym(name, obs_width=W, obs_height=H, skip_obs=True)
        env = MiniWorldGym(name, obs_width=W, obs_height=H, skip_obs=True, device="cpu")
        assert env.action_space == jenv.action_space, name
        assert env.observation_space == jenv.observation_space, name


def test_set_discrete_actions_and_control_action():
    """set_discrete_actions installs a table (None: the default six
    moves) and the action space follows; control_action maps HUD buttons
    as the JAX adapter does (CameraControl's discrete ids, a projected
    index with a table, a 6-D vector without one)."""
    env = MiniWorldGym("PutNext", obs_width=W, obs_height=H, device="cpu", skip_obs=True)
    jenv = JaxGym("PutNext", obs_width=W, obs_height=H, skip_obs=True)
    with pytest.raises(ValueError):
        env.reset(seed=0)
        env.step(2)
    for e in (env, jenv):
        np.testing.assert_array_equal(e.control_action("fwd"), [1, 0, 0, 0, 0, 0])
    env.set_discrete_actions()
    jenv.set_discrete_actions()
    assert env.action_space == jenv.action_space
    for label in ("fwd", "back", "t.left", "s.right", "pick", "nothing"):
        assert env.control_action(label) == jenv.control_action(label), label
    env.reset(seed=3)
    jenv.reset(seed=3)
    for a in (2, 2, 0, 5):
        env.step(a)
        jenv.step(a)
    np.testing.assert_array_equal(env.agent_pos, jenv.agent_pos)
    table = [[0.5, 0, 0, 0, 0, 0], [0, 0, 0.25, 0, 0, 0]]
    env.set_discrete_actions(table)
    assert env.action_space.n == 2
    with pytest.raises(ValueError):
        env.set_discrete_actions([[1.0, 0.0]])
    cam = MiniWorldGym("CameraControl", obs_width=W, obs_height=H, device="cpu")
    jcam = JaxGym("CameraControl", obs_width=W, obs_height=H)
    assert cam.control_action("zoom_in") == jcam.control_action("zoom_in") == 4
    assert cam.control_boxes == jcam.control_boxes
    assert env.control_boxes == jenv.control_boxes


def test_device_and_gymnasium_free_class():
    """The adapter renders on the card by default and raises without
    CUDA; SingleEnv, the same env without gymnasium, has no spaces."""
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            MiniWorldGym("Hallway")
        with pytest.raises(RuntimeError):
            SingleEnv("Hallway")
    env = SingleEnv("Hallway", obs_width=W, obs_height=H, device="cpu")
    assert not hasattr(env, "action_space")
    obs, info = env.reset(seed=0)
    assert obs.shape == (H, W, 3) and obs.dtype == np.uint8
    assert set(info) == {"agent"}


def test_register_gym():
    """register_gym points the reference ids at the port's adapter."""
    import gymnasium as gym

    from miniworld_tpu_torch.gym_env import register_gym

    register_gym(prefix="Torch")
    spec = gym.spec("TorchMiniWorld-Hallway-v0")
    assert spec.entry_point == "miniworld_tpu_torch.gym_env:MiniWorldGym"
    env = gym.make("TorchMiniWorld-Hallway-v0", obs_width=W, obs_height=H, device="cpu")
    obs, _ = env.reset(seed=1)
    assert obs.shape == (H, W, 3)
    assert isinstance(env.unwrapped, MiniWorldGym)
    env.close()


def test_render_modes():
    """render(): "rgb_array" the observation with the HUD's controls
    drawn, equal to the JAX adapter's; "human" blits the composed frame
    (pose text, top-view thumbnail) to a pygame window and returns None."""
    jenv = JaxGym("OneRoomS6Fast", obs_width=W, obs_height=H, render_mode="rgb_array",
                  show_controls=True)
    env = MiniWorldGym("OneRoomS6Fast", obs_width=W, obs_height=H, device="cpu",
                       render_mode="rgb_array", show_controls=True)
    jenv.reset(seed=2)
    env.reset(seed=2)
    np.testing.assert_array_equal(env.render(), jenv.render())
    pytest.importorskip("pygame")
    human = MiniWorldGym("OneRoomS6Fast", obs_width=W, obs_height=H, device="cpu",
                         render_mode="human")
    human.reset(seed=2)
    assert human.render() is None and hasattr(human, "_pygame_screen")
    human.close()
    assert not hasattr(human, "_pygame_screen")

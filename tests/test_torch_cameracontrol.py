"""CameraControl and CameraControlClick on the port against the JAX
package, at B=4, 32x24: a camera 0.1 m from a random wall of an 8 m room
(``post_reset``), moved by its own physics (``apply_action``: Discrete(6)
pan / tilt / zoom, or (B, 2) clicks), rewarded when the green key is
centred, a red crosshair over every observation (``post_render``).

Resets and every step exact: the camera's state (its moves round as in
XLA:CPU's step program; the other fields within FLOAT_ATOL, as the
reset's placements there), rewards, dones and the six ``info`` entries
(``key_centered`` and ``distance_from_center`` through XLA's arccos
expansion and the C library's atan2f), the crosshair's pixels equal and
red, the rest of the image by ``assert_images_match``. Each discrete
action is run to its clamps (pitch +-89, fov 20 and 90) and one camera
pans 180 degrees to face its own wall from 0.1 m; clicks at the centre
(no move), the corners and at random. ``sample_actions``,
``rollout_actions`` and a rollout from a key equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.envs.cameracontrol import crosshair_mask
from miniworld_tpu_torch.ops import rng as trng
from miniworld_tpu_torch.state import tree_select

from _torch_parity import assert_images_match, assert_states_match, to_port_state
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B, W, H = 4, 32, 24
CAM, CLICK = "MiniWorld-CameraControl-v0", "MiniWorld-CameraControlClick-v0"
INFO = ("camera_yaw", "camera_pitch", "camera_fov", "camera_wall", "key_centered",
        "distance_from_center")



@pytest.fixture(scope="module")
def envs():
    return {env_id: (JaxVec(env_id, num_envs=B, obs_width=W, obs_height=H),
                     MiniWorldVec(env_id, B, obs_width=W, obs_height=H, device="cpu"))
            for env_id in (CAM, CLICK)}


def _check_obs(j_rgb, j_depth, t_rgb, t_depth):
    """The crosshair's pixels equal and red in both, the rest by
    ``assert_images_match``."""
    mask = crosshair_mask(H, W)[:, :, 0].numpy()
    j_rgb, t_np = np.asarray(j_rgb), t_rgb.numpy()
    np.testing.assert_array_equal(t_np[:, mask], j_rgb[:, mask])
    assert (t_np[:, mask] == [255, 0, 0]).all()
    assert_images_match(j_rgb, j_depth, t_rgb, t_depth)


def _check_states(jstate, tstate):
    """The camera's fields and the task exact, the rest within FLOAT_ATOL
    (XLA:CPU fuses a multiply-add in some of the reset's placements,
    ROADMAP C1)."""
    assert_states_match(jstate, tstate)
    for name in ("pos", "dir", "cam_pitch", "cam_fov_y", "cam_height", "cam_fwd_disp"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)), err_msg=name)
    np.testing.assert_array_equal(tstate.task["camera_wall"].numpy(),
                                  np.asarray(jstate.task["camera_wall"]))


def _run(jenv, tenv, seed, actions):
    """Reset both from ``seed`` and step them with ``actions`` (a list of
    per-step (B, ...) arrays), everything exact each step. The port goes
    on from the JAX state after the reset and in each env that resets:
    the kits' placements may differ by an ulp (C1), and the key's
    position enters ``distance_from_center``. Returns the port's infos,
    one dict of numpy arrays a step."""
    jstate, (j_rgb, j_d) = jenv.reset(jax.random.key(seed))
    tstate, (t_rgb, t_d) = tenv.reset(seed)
    _check_states(jstate, tstate)
    _check_obs(j_rgb, j_d, t_rgb, t_d)
    tstate = to_port_state(jstate)
    infos = []
    for acts in actions:
        jstate, (j_rgb, j_d), j_r, j_done, j_info = jenv.step(jstate, jnp.asarray(acts))
        tstate, (t_rgb, t_d), t_r, t_done, t_info = tenv.step(tstate, torch.from_numpy(acts))
        np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
        assert set(t_info) == set(j_info) and set(INFO) <= set(t_info)
        for k in j_info:
            np.testing.assert_array_equal(t_info[k].numpy(), np.asarray(j_info[k]), err_msg=k)
        _check_states(jstate, tstate)
        _check_obs(j_rgb, j_d, t_rgb, t_d)
        if bool(t_done.any()):
            tstate = tree_select(t_done, to_port_state(jstate), tstate)
        infos.append({k: v.numpy() for k, v in t_info.items()} | {"done": t_done.numpy()})
    return infos


@pytest.mark.parametrize("env_id", [CAM, CLICK])
def test_action_draws_match_jax(envs, env_id):
    """``sample_actions``: JAX's ``randint(key, (B,), 0, 6)`` ids or
    ``uniform(key, (B, 2))`` clicks; ``rollout_actions``: step t's draw
    from the first split of ``split(key, horizon)[t]``."""
    jenv, tenv = envs[env_id]
    shape = (B,) if env_id == CAM else (B, 2)
    for seed in (0, 7, 123456):
        want = np.asarray(jenv.sample_actions(jax.random.key(seed)))
        got = tenv.sample_actions(trng.key_data(seed))
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)
    keys = jax.random.split(jax.random.key(5), 6)
    want = np.stack([np.asarray(jenv.sample_actions(jax.random.split(k)[0])) for k in keys])
    got = tenv.rollout_actions(trng.key_data(5), 6)
    assert tuple(got.shape) == (6,) + shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_discrete_actions_to_their_clamps(envs):
    """Env 0 pans left 36 times (180 degrees: it faces its own wall from
    0.1 m), then right; env 1 tilts up past 89, then down past -89; env 2
    zooms in past 20, then out; env 3 zooms out past 90, then tilts down."""
    jenv, tenv = envs[CAM]
    sched = [[0] * 36 + [1] * 20, [2] * 18 + [3] * 38, [4] * 22 + [5] * 34,
             [5] * 17 + [3] * 39]
    actions = [np.asarray(a, np.int32) for a in zip(*sched)]
    infos = _run(jenv, tenv, 3, actions)
    assert not any(i["done"][0] for i in infos[:36])
    yaw = np.asarray([i["camera_yaw"][0] for i in infos])
    assert abs(float(yaw[35] - yaw[0]) - 35 * np.deg2rad(5.0)) < 1e-4
    pitch = np.concatenate([i["camera_pitch"] for i in infos])
    fov = np.concatenate([i["camera_fov"] for i in infos])
    assert pitch.max() == 89.0 and pitch.min() == -89.0
    assert fov.min() == 20.0 and fov.max() == 90.0


def test_clicks(envs):
    """Env 0 clicks the centre (no move: its yaw and pitch stay); envs 1
    and 2 the four corners in turn; env 3 at random."""
    jenv, tenv = envs[CLICK]
    corners = np.asarray([[0, 0], [1, 1], [0, 1], [1, 0]], np.float32)
    rng = np.random.default_rng(4)
    actions = []
    for t in range(12):
        a = np.stack([[0.5, 0.5], corners[t % 4], corners[(t + 2) % 4],
                      rng.uniform(size=2)]).astype(np.float32)
        actions.append(a)
    infos = _run(jenv, tenv, 11, actions)
    assert len({float(i["camera_yaw"][0]) for i in infos}) == 1
    assert len({float(i["camera_pitch"][0]) for i in infos}) == 1
    assert len({float(i["camera_yaw"][1]) for i in infos}) > 1


@pytest.mark.parametrize("env_id", [CAM, CLICK])
def test_random_steps_and_rollout_match_jax(envs, env_id):
    """Ten steps of ``sample_actions`` exact; a 4-step rollout from a key:
    rewards, dones and checksums (the crosshair included) equal JAX's
    ``rollout``."""
    jenv, tenv = envs[env_id]
    _run(jenv, tenv, 6, [tenv.sample_actions(trng.key_data(100 + t)).numpy()
                         for t in range(10)])
    jstate, jobs = jenv.reset(jax.random.key(2))
    tstate, tobs = tenv.reset(2)
    _, _, j_out = jenv.rollout(jstate, jobs, jax.random.key(6), 4)
    _, _, t_out = tenv.rollout(tstate, tobs, trng.key_data(6), 4)
    for k in ("reward", "dones", "obs_sum"):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]).astype(
            t_out[k].numpy().dtype), err_msg=k)


def test_wrong_action_shapes_raise(envs):
    for env_id, bad in ((CAM, torch.zeros((B, 2))), (CLICK, torch.zeros(B, dtype=torch.int32))):
        tenv = envs[env_id][1]
        state, _ = tenv.reset(0)
        with pytest.raises(ValueError, match=tenv.spec.name):
            tenv.step(state, bad)

"""A rollout of every id the port runs, on the CPU: ``MiniWorldVec.rollout``
at B=2, 16x12, 3 steps from a key. Rewards, dones and checksums are
finite, the observations have their shapes (Sign's a dict with its
image and goal), and two rollouts from one key agree (RoomObjects' and
PutNext's with the raw 6-D actions). Every id's top view too (``view="top"``
at 64x48: a rollout, the agent marker, ``visible_ents``' mask). The
parity tests hold each id against the JAX package; this one shows that
every id's whole path starts."""

import numpy as np
import pytest
import torch

from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.envs import ENV_IDS
from miniworld_tpu_torch.envs.cameracontrol import CameraControl, crosshair_mask
from miniworld_tpu_torch.ops.rng import key_data

from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B, W, H, HORIZON = 2, 16, 12, 3


def test_every_id_counted():
    assert len(ENV_IDS) == 27 and len(set(ENV_IDS)) == 27


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_rollout(env_id):
    env = MiniWorldVec(env_id, B, obs_width=W, obs_height=H, device="cpu")
    state, obs = env.reset(seed=3)
    outs = []
    for _ in range(2):
        _, last, out = env.rollout(state, obs, key_data(11), HORIZON)
        outs.append({k: v.numpy() for k, v in out.items()})
    for k in ("reward", "dones", "obs_sum"):
        assert outs[0][k].shape == (HORIZON,)
        assert np.isfinite(outs[0][k]).all(), k
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    rgb, depth = last
    if env.spec.dict_obs:
        assert set(rgb) == {"obs", "goal"}
        assert rgb["goal"].dtype == torch.int32 and rgb["goal"].shape == (B,)
        rgb = rgb["obs"]
    assert rgb.shape == (B, H, W, 3) and rgb.dtype == torch.uint8
    assert depth.shape == (B, H, W, 1) and bool(torch.isfinite(depth).all())
    assert int(outs[0]["obs_sum"].min()) > 0


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_top_view_rollout_and_visible_ents(env_id):
    """view="top" on every id: a rollout's top-view observations (the
    floorplan from above: depth below FAR somewhere, the red agent
    marker where a pixel is narrower than the agent radius; the camera ids'
    crosshair over it), and visible_ents' (B, E) mask on the last state."""
    env = MiniWorldVec(env_id, B, obs_width=4 * W, obs_height=4 * H, device="cpu", view="top")
    state, obs = env.reset(seed=3)
    state, (rgb, depth), out = env.rollout(state, obs, key_data(11), HORIZON)
    if env.spec.dict_obs:
        rgb = rgb["obs"]
    assert rgb.shape == (B, 4 * H, 4 * W, 3) and bool((depth < 100.0).any())
    if isinstance(env.spec, CameraControl):
        # the camera ids' crosshair over the top view too, as the JAX package
        # draws it; it lies over the marker at a wall's centre, so the
        # marker is looked for in the render under it
        cross = crosshair_mask(4 * H, 4 * W)
        raw = env.render(state)[0]
        red_px = torch.tensor([255, 0, 0], dtype=torch.uint8)
        assert torch.equal(rgb, torch.where(cross, red_px, raw))
        rgb = raw
    red = (rgb[..., 0] == 255) & (rgb[..., 1] == 0) & (rgb[..., 2] == 0)
    pitch = float(env._top.xs[0, 1] - env._top.xs[0, 0])  # world units a pixel
    if pitch < env.spec.agent_radius:  # the marker covers pixel centres
        assert bool(red.flatten(1).any(1).all())
    vis = env.visible_ents(state)
    assert vis.dtype == torch.bool and vis.shape == state.ent_alive.shape
    assert not bool((vis & ~state.ent_alive).any())

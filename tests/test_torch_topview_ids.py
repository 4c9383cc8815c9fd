"""``MiniWorldVec(view="top")`` of the port against the JAX package's on
the CPU: reset and 3 steps at B=2, 48x36 (``reset_and_steps``: rewards,
dones and task state exact, states within FLOAT_ATOL, top-view images by
``assert_images_match``) on Hallway, PickupObjects (spheres, boxes and
mesh entities as footprints), FourRooms in both texture modes, the
MazeS3 procgen super bank (each env's maze kills its rows) and FourRooms
nearest with domain randomisation (the variants through ``tex_map``); and
``render_top_view`` without the agent marker and without depth against
JAX's. The stages and Sign (glyphs with no footprint, dict
observations) are in test_torch_topview.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu.render import topview as jtop
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.render import topview as ttop

from _torch_parity import reset_and_steps, to_port_state
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B, W, H = 2, 48, 36


@pytest.mark.parametrize("env_id,kwargs", [
    ("MiniWorld-Hallway-v0", {}),
    ("MiniWorld-PickupObjects-v0", {}),
    ("MiniWorld-FourRooms-v0", {}),
    ("MiniWorld-FourRooms-v0", {"tex_mode": "nearest"}),
    ("MiniWorld-MazeS3-v0", {}),
    ("MiniWorld-FourRooms-v0", {"tex_mode": "nearest", "domain_rand": True}),
], ids=["hallway", "pickupobjects", "fourrooms", "fourrooms-nearest", "mazes3-procgen",
        "fourrooms-nearest-domain_rand"])
def test_top_view_steps_match_jax(env_id, kwargs):
    top_view_steps(env_id, kwargs)


def top_view_steps(env_id, kwargs):
    """reset_and_steps with view="top"; the marker's pixels equal."""
    frames = []
    reset_and_steps(env_id, B, W, H, 3, seed=6, frames=frames, view="top", **kwargs)
    state, j_rgb, _, t_rgb, _ = frames[-1]
    # the agent marker is drawn: pure red pixels in every env's image
    red = (t_rgb[..., 0] == 255) & (t_rgb[..., 1] == 0) & (t_rgb[..., 2] == 0)
    assert bool(red.flatten(1).any(1).all())
    np.testing.assert_array_equal(red.numpy(), (np.asarray(j_rgb) == [255, 0, 0]).all(-1))


def test_render_top_view_options_match_jax():
    """render_agent=False and with_depth=False (the JAX function's
    flags) on FourRooms states, images equal to JAX's."""
    env = MiniWorldVec("MiniWorld-FourRooms-v0", B, obs_width=W, obs_height=H, device="cpu",
                       view="top")
    jenv = JaxVec("MiniWorld-FourRooms-v0", num_envs=B, obs_width=W, obs_height=H, view="top")
    jstate, _ = jenv.reset(jax.random.key(2))
    tex = {"mode": "fourier", "coeffs": jenv._atlas, "k": jenv.fourier_k, "has_gain": False}
    ext = jenv._bank.extents[0]
    want = np.asarray(jax.jit(jax.vmap(lambda s: jtop.render_top_view(
        jenv._bank, s, tex, width=W, height=H, extents=ext, render_agent=False)))(jstate))
    got = ttop.render_top_view(env._bank, to_port_state(jstate), env._atlas, width=W,
                               height=H, render_agent=False, with_depth=False,
                               k_terms=env.fourier_k)
    assert isinstance(got, torch.Tensor) and got.shape == (B, H, W, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    marked = ttop.render_top_view(env._bank, to_port_state(jstate), env._atlas, width=W,
                                  height=H, with_depth=False, k_terms=env.fourier_k)
    assert bool((marked != got).any())  # the marker

"""Sign and the SDF glyph branch of the Fourier texel, against the JAX
package on the CPU.

Sign's atlas (K = 64 terms) has 78 rows, 72 of them glyphs: a bf16 gain
< 0 marks a Fourier-SDF fit whose channels are [sdf | ink | bg], and the
texel thresholds the reconstructed signed distance at an edge half-width
grown with the pixel's footprint (raycast.py:656-724). A one-ulp
difference in the sdf moves a pixel near a stroke by several u8 levels,
so the glyph branch is held to the JAX package exactly:

- ``eval_fourier(has_gain=True)`` equals JAX ``eval_fourier`` bit for bit
  on Sign's atlas (and on rows with a contrast gain > 1), glyph and
  plain slots, -1 and >= A slots, footprints from magnified to minified;
- Sign's reset and 8 steps at B=8, 40x30, with half the agents 1-3 m
  from the sign and facing it: rewards, dones and ``goal`` exact, states
  within FLOAT_ATOL, images by ``assert_images_match``, and every pixel
  that shows a glyph (hundreds a frame, asserted) within 0 u8 levels
  where the winners agree; two agents end their episodes with action 3;
- the same with ``domain_rand=True`` and with ``supersample=2``;
- the SS=2 kernel's box filter as its lanes form it
  (tests/_kernel_models.py) equals the plain epilogue's ss=2 output on
  Sign's glyphs at 32x24.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import vector as jvector
from miniworld_tpu.envs import make_spec as jax_make_spec
from miniworld_tpu.render import raycast as jrc
from miniworld_tpu_torch.render import raycast as trc

from _kernel_models import epilogue_inputs, ss2_by_lanes
from _torch_parity import DEPTH_RTOL, reset_and_steps
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

SIGN_ID = "MiniWorld-Sign-v0"
K = 64
B, W, H = 8, 40, 30
GLYPH_RGB_TOL = 0  # u8 levels on glyph pixels whose winner agrees
FACING = 4  # envs 0-3 walk at the sign; 4-5 end their episodes; 6-7 act at random


@pytest.fixture(scope="module")
def sign_atlas():
    """Sign's Fourier atlas from the JAX package's bank build."""
    return jvector.build_bank(jax_make_spec(SIGN_ID))[1]


def _texel_inputs(atlas, n=24000, seed=0):
    rng = np.random.default_rng(seed)
    n_rows = atlas.shape[0]
    glyph = np.flatnonzero(atlas[:, -1] < 0)
    slot = np.where(rng.random(n) < 0.7, rng.choice(glyph, n),
                    rng.integers(-1, n_rows + 2, n)).astype(np.float32)
    uv = rng.uniform(-3.0, 3.0, (n, 2)).astype(np.float32)
    # uv-space footprints from a small fraction of a texel to many
    footprint = np.exp(rng.uniform(np.log(1e-5), np.log(0.3), n)).astype(np.float32)
    return slot, uv, footprint


@pytest.mark.parametrize("contrast", [False, True], ids=["sign", "contrast-gain"])
def test_eval_fourier_glyphs_match_jax(sign_atlas, contrast):
    """Bit for bit, with and without the footprint; ``contrast``: every
    other plain row given a gain of 1.7 (the branch that expands the
    contrast away from the DC term)."""
    atlas = sign_atlas.copy()
    assert atlas.shape == (78, 4 + 8 * K) and int((atlas[:, -1] < 0).sum()) == 72
    if contrast:
        plain = np.flatnonzero(atlas[:, -1] == 1.0)
        atlas[plain[::2], -1] = np.float32(1.7)
    slot, uv, fp = _texel_inputs(atlas)
    fn = jax.jit(lambda a, s, u, f: jrc.eval_fourier(a, s, u, K, f, has_gain=True))
    fn0 = jax.jit(lambda a, s, u: jrc.eval_fourier(a, s, u, K, None, has_gain=True))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = trc.eval_fourier(t(atlas), t(slot), t(uv), K, t(fp), has_gain=True).numpy()
    np.testing.assert_array_equal(got, np.asarray(fn(atlas, slot, uv, fp)))
    got0 = trc.eval_fourier(t(atlas), t(slot), t(uv), K, None, has_gain=True).numpy()
    np.testing.assert_array_equal(got0, np.asarray(fn0(atlas, slot, uv)))
    # the glyph branch decides: a threshold between ink and background
    # on glyph slots, many pixels strictly inside the edge
    g = atlas[np.clip(slot.astype(int), 0, 77), -1] < 0
    g &= (slot >= 0) & (slot < 78)
    assert g.sum() > 10000 and len(np.unique(got[g, 0])) > 1000


def test_fourier_table_gain(sign_atlas):
    """The epilogue kernel's table carries each row's bf16 gain in its
    column 3."""
    table = trc.fourier_table(torch.from_numpy(sign_atlas), K).numpy()
    want = np.asarray(jnp.asarray(sign_atlas[:, -1]).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(table[:, 3], want)
    assert table.shape == (78, 4 + 9 * K) and (table[:, 3] < 0).sum() == 72


def _start(jenv, jstate):
    """Envs 0-3 1-3 m in front of the sign (at x = 10, z = 10.25, facing
    -x) and facing it, walking forward; envs 4-5 where they reset, ending
    the episode (action 3) every step; envs 6-7 random."""
    rng = np.random.default_rng(7)
    pos = np.asarray(jstate.pos).copy()
    yaw = np.asarray(jstate.dir).copy()
    n = FACING
    pos[:n] = np.stack([rng.uniform(7.0, 9.0, n), np.zeros(n), rng.uniform(9.7, 10.8, n)], 1)
    yaw[:n] = rng.uniform(-0.25, 0.25, n)
    forced = np.arange(B) < FACING + 2
    return pos, yaw, forced


FORCED_ACTIONS = np.array([2] * FACING + [3] * 2 + [0] * (B - FACING - 2))


def _glyph_pixels(env, state, ss=1):
    """(B, H, W) bool: pixels whose tri_pass winner is a glyph row of the
    env's atlas and no nearer analytic entity covers (the port's plain
    passes; with ss=2 the top-left sample's, as depth)."""
    w, h = env.obs_width * ss, env.obs_height * ss
    cam = trc.camera_grid(state, w, h)
    rows, paired = trc.static_rows(env._bank, state, cam)
    mesh = trc.entity_mesh_rows(env._bank, state)[:2]
    t, attr = trc.tri_pass(*rows, cam, env._all_quads, mesh, paired, env.tri_chunk)
    t_ent, _, _ = trc.entity_pass(state.ent_pos, state.ent_size, state.ent_dir,
                                  state.ent_height, state.ent_color,
                                  trc.entity_flags(env._bank, state), cam)
    gain = env._atlas[:, -1]
    slot = torch.round(attr[..., 14].float()).long()
    inside = (slot >= 0) & (slot < gain.shape[0])
    glyph = inside & (gain[slot.clamp(0, gain.shape[0] - 1)] < 0) & ~(t_ent < t)
    return glyph.reshape(-1, h, w)[:, ::ss, ::ss]


def _run(steps, **env_kwargs):
    from miniworld_tpu import MiniWorldVec as JaxVec
    from miniworld_tpu_torch import MiniWorldVec

    env = MiniWorldVec(SIGN_ID, B, obs_width=W, obs_height=H, device="cpu", **env_kwargs)
    jenv = JaxVec(SIGN_ID, num_envs=B, obs_width=W, obs_height=H, **env_kwargs)
    frames = []
    dones, rewards, _, _ = reset_and_steps(SIGN_ID, B, W, H, steps, seed=5, start=_start,
                                           forced_action=FORCED_ACTIONS, frames=frames,
                                           envs=(jenv, env))
    worst = 0
    for tstate, j_rgb, j_depth, t_rgb, t_depth in frames:
        glyph = _glyph_pixels(env, tstate, env.supersample).numpy()
        assert glyph[:FACING].sum(axis=(1, 2)).min() >= 50, glyph.sum(axis=(1, 2))
        same = np.isclose(t_depth.numpy()[..., 0], np.asarray(j_depth)[..., 0], rtol=DEPTH_RTOL,
                          atol=0)
        diff = np.abs(t_rgb.numpy().astype(int) - np.asarray(j_rgb).astype(int)).max(-1)
        worst = max(worst, int(diff[glyph & same].max(initial=0)))
        assert (glyph & same).sum() >= 0.99 * glyph.sum()
    assert worst <= GLYPH_RGB_TOL, worst
    # action 3 ends the episode of envs 4 and 5 on every step
    assert dones >= 2 * steps
    return dones, rewards


def test_sign_reset_and_steps():
    _run(8)


@pytest.mark.parametrize("kwargs", [{"domain_rand": True}, {"supersample": 2}],
                         ids=["domain_rand", "ss2"])
def test_sign_options(kwargs):
    _run(3, **kwargs)


def test_lane_quad_mean_sign():
    """Sign at B=2, 32x24 (64x48 samples), both agents 1.5-2 m in front of
    the sign and facing it: the SS=2 kernel's lanes, one sample each,
    summed by shuffles at each pixel's s00 lane, give
    pixel_epilogue_plain's ss=2 output (the glyph branch) exactly."""
    from miniworld_tpu_torch import MiniWorldVec

    env = MiniWorldVec(SIGN_ID, 2, obs_width=32, obs_height=24, device="cpu")
    state, _ = env.reset(4)
    pos = state.pos.clone()
    pos[:, 0] = torch.tensor([8.0, 8.5])
    pos[:, 2] = torch.tensor([10.0, 10.5])
    state = state.replace(pos=pos, dir=torch.tensor([0.1, -0.1]))
    args = epilogue_inputs(env, state, 64, 48)
    assert int(_glyph_pixels(env, state).sum()) > 100
    rgb, depth = trc.pixel_epilogue_plain(*args, True, ss=2)
    rgb_l, depth_l = ss2_by_lanes(args, True)
    assert torch.equal(rgb, rgb_l) and torch.equal(depth, depth_l)

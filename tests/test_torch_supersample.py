"""supersample=2 in the port against the JAX package's.

The render at 16x12 output (a 32x24 grid of samples) on Hallway,
FourRooms and PickupObjects (its mesh rows at 2x2 too), from the JAX
package's reset state, to ``assert_images_match``'s tolerances (winners
equal on 99.9% of the pixels, depth rtol 1e-5, RGB within 2 u8 levels);
the epilogue's box filter in XLA's order against a JAX mean, exactly,
and as the SS=2 kernel's lanes form it (tests/_kernel_models.py) against
the plain epilogue on PickupObjects' samples, with the samples whose
texel the result never reads holding noise; the refusals of the plans
the port cannot render at ss=2. The chunk
plans at ss=2 are held against JAX's in tests/test_torch_chunks.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu_torch import MiniWorldVec, vector as tvector
from miniworld_tpu_torch.render import cuda_build, raycast as trc

from _kernel_models import epilogue_inputs, ss2_by_lanes, texel_read_mask
from _torch_parity import assert_images_match, to_port_state
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

W, H, B = 16, 12, 8


@pytest.mark.parametrize("env_id", ["MiniWorld-Hallway-v0", "MiniWorld-FourRooms-v0",
                                    "MiniWorld-PickupObjects-v0"])
def test_render_matches_jax(env_id):
    """The port's ss=2 render of JAX's reset state: (B, 12, 16) images,
    depth from the top-left sample, matching JAX's; the plain path and
    the wrappers (plain versions on the CPU, no launch) agree exactly."""
    jenv = JaxVec(env_id, num_envs=B, obs_width=W, obs_height=H, supersample=2)
    tenv = MiniWorldVec(env_id, B, obs_width=W, obs_height=H, device="cpu", supersample=2)
    assert tenv.plan["cap"] == tvector.chunk_cap(B, W * H * 4)
    jstate, (j_rgb, j_depth) = jenv.reset(jax.random.key(4))
    state = to_port_state(jstate)
    cuda_build.reset_launch_counts()
    rgb, depth = tenv.render(state)
    assert not any(cuda_build.LAUNCHES.values())
    assert rgb.shape == (B, H, W, 3) and depth.shape == (B, H, W, 1)
    assert_images_match(j_rgb, j_depth, rgb, depth)
    tenv.use_kernels = False
    rgb_p, depth_p = tenv.render(state)
    assert torch.equal(rgb, rgb_p) and torch.equal(depth, depth_p)
    # depth is the top-left sample of the 2W x 2H render
    ref = MiniWorldVec(env_id, B, obs_width=2 * W, obs_height=2 * H, device="cpu")
    _, depth_full = ref.render(state)
    assert torch.equal(depth, depth_full[:, ::2, ::2])


def test_box_filter_order_matches_jax_mean():
    """The epilogue's mean of each pixel's 2x2 samples, ((s00 + s01) +
    s10) + s11 times 0.25, equals XLA's reduce of the JAX package's
    ``mean(axis=(1, 3))`` bit for bit (another order differs)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 1.0, (4, 24, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda r: r.reshape(12, 2, 16, 2, 3).mean(axis=(1, 3))))(jnp.asarray(x)))
    q = torch.from_numpy(x).reshape(4, 12, 2, 16, 2, 3)
    got = (((q[:, :, 0, :, 0] + q[:, :, 0, :, 1]) + q[:, :, 1, :, 0]) + q[:, :, 1, :, 1]) * 0.25
    np.testing.assert_array_equal(got.numpy(), want)
    other = ((q[:, :, 0, :, 0] + q[:, :, 1, :, 0]) + q[:, :, 0, :, 1]) + q[:, :, 1, :, 1]
    assert not np.array_equal((other * 0.25).numpy(), want)


def test_lane_quad_mean_pickupobjects():
    """PickupObjects at 32x24 (64x48 samples), agents facing the balls,
    boxes and keys: the SS=2 kernel's lanes, one sample each, summed by
    shuffles at each pixel's s00 lane, give pixel_epilogue_plain's ss=2
    output exactly; so does the plain epilogue where the samples whose
    texel the result never reads (entity-covered ones among them) hold
    noise in place of their attributes."""
    env = MiniWorldVec("MiniWorld-PickupObjects-v0", 2, obs_width=32, obs_height=24,
                       device="cpu", supersample=2)
    state, _ = env.reset(3)
    target = state.ent_pos[:, 0]
    yaw = torch.atan2(-(target[:, 2] - state.pos[:, 2]), target[:, 0] - state.pos[:, 0])
    state = state.replace(dir=yaw)
    args = epilogue_inputs(env, state, 64, 48)
    rgb, depth = trc.pixel_epilogue_plain(*args, ss=2)
    rgb_l, depth_l = ss2_by_lanes(args)
    assert torch.equal(rgb, rgb_l) and torch.equal(depth, depth_l)
    t_tri, attr, t_ent = args[:3]
    mask = texel_read_mask(t_tri, t_ent)
    assert bool((~mask & torch.isfinite(t_tri)).any()), "no sample is an entity's"
    noise = torch.rand(attr.shape, generator=torch.Generator().manual_seed(1)) * 40 - 20
    attr_n = torch.where(mask[..., None], attr, noise.to(attr.dtype))
    rgb_n, depth_n = trc.pixel_epilogue_plain(t_tri, attr_n, *args[2:], ss=2)
    assert torch.equal(rgb, rgb_n) and torch.equal(depth, depth_n)


def test_plans_that_still_raise():
    """At ss=2 the 8x8 procgen Maze's paired bank (Sp = 608 rows) meets a
    chunk cap of 496 at B=1024, 80x60 (19,200 samples a frame): the port
    plans it as JAX does, 2 chunks of 496 (it raised before the paired
    multi-chunk scan was ported); other supersample values raise
    ValueError."""
    env = MiniWorldVec("MiniWorld-Maze-v0", 1024, obs_width=80, obs_height=60, device="cpu",
                       supersample=2)
    assert (env.tri_chunk, env.plan["chunk_starts"]) == (496, [0, 112])
    with pytest.raises(ValueError, match="supersample"):
        MiniWorldVec("MiniWorld-Hallway-v0", 2, obs_width=16, obs_height=12, device="cpu",
                     supersample=3)


def test_epilogue_rejects_odd_sample_grids():
    env = MiniWorldVec("MiniWorld-Hallway-v0", 2, obs_width=W, obs_height=H, device="cpu")
    state, _ = env.reset(0)
    cam = trc.camera_grid(state, 15, 12)
    t = torch.full((2, 15 * 12), float("inf"))
    a = torch.zeros((2, 15 * 12, 16), dtype=torch.bfloat16)
    lights = (state.light_pos, state.light_color, state.light_ambient, state.sky_color)
    with pytest.raises(ValueError, match="ss=2"):
        trc.pixel_epilogue(t, a, None, None, None, env._atlas, cam, *lights, 16, ss=2)

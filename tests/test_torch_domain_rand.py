"""Domain randomisation in the port against the JAX package's.

The draws: ``ops.rng.uniform`` bit for bit against ``jax.random.uniform``
(shapes () and (3,), a collapsed range), the step's three parameter
draws against the JAX package's ``_sample_param`` on the same keys,
and every reset draw (the 8 per-episode parameters, the entity colour
bias, ``tex_map`` and the texture-variant key ``tri_slots``) against
``_reset_one``. The render: each scanned row's texture variant on every
route the port renders, dense in one chunk (Hallway, FourRooms), in
three chunks (Sidewalk), packed PVS (the 8x8 Maze's layout bank), a
paired procgen bank (MazeS3) and with mesh rows (PickupObjects), from
the JAX package's reset state. Tolerances: the reset draws and the
step draws exact; states within FLOAT_ATOL, where XLA:CPU's fused
multiply-adds move positions by an ulp or two (ROADMAP C1); images by
``assert_images_match`` (winners equal on 99.9% of the pixels, depth
rtol 1e-5, RGB within 2 u8 levels); the Hallway rollout's rewards,
dones and checksums exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu.envs import make_spec as jax_make_spec
from miniworld_tpu.render import raycast as jrc
from miniworld_tpu_torch import MiniWorldVec, make_spec, vector as tvector
from miniworld_tpu_torch.ops import rng as trng
from miniworld_tpu_torch.render import raycast as trc

from _torch_parity import assert_images_match, assert_states_match, to_port_state
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

W, H = 40, 30


def _kd(keys) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(np.int64))


@pytest.mark.parametrize("shape,lo,hi", [
    ((), 0.12, 0.17), ((), -0.05, 0.05), ((), 10.0, 20.0),
    ((3,), [-40.0, 2.5, -40.0], [40.0, 5.0, 40.0]),
    ((), 0.15, 0.15), ((3,), [0.5, 0.5, 0.5], [0.5, 0.5, 0.5]),
], ids=["fwd_step", "drift", "turn", "light_pos", "collapsed", "collapsed3"])
def test_uniform_matches_jax(shape, lo, hi):
    """Bit for bit over 2,048 keys; a collapsed range gives its bound."""
    keys = jax.random.split(jax.random.key(3), 2048)
    lo32, hi32 = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    want = jax.jit(jax.vmap(lambda k: jax.random.uniform(
        k, shape, jnp.float32, minval=jnp.asarray(lo32), maxval=jnp.asarray(hi32))))(keys)
    got = trng.uniform(_kd(keys), shape, lo32, hi32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2048,) + shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if np.array_equal(lo32, hi32):
        assert bool((got == torch.from_numpy(lo32)).all())


@pytest.fixture(scope="module")
def hallway():
    jenv = JaxVec("MiniWorld-Hallway-v0", num_envs=8, obs_width=W, obs_height=H,
                  domain_rand=True)
    tenv = MiniWorldVec("MiniWorld-Hallway-v0", 8, obs_width=W, obs_height=H, device="cpu",
                        domain_rand=True)
    return jenv, tenv


def test_step_draws_match_jax(hallway):
    """forward_step, forward_drift and turn_step from split(k_params, 3)
    equal the JAX package's ``_sample_param`` on the same 1,024 keys, in
    one batched threefry call; without domain randomisation they are the
    defaults."""
    jenv, tenv = hallway
    k_params = jax.random.split(jax.random.key(9), 1024)

    def one(k):
        pk = jax.random.split(k, 3)
        return jnp.stack([jenv._sample_param(pk[i], n)
                          for i, n in enumerate(tvector.STEP_PARAMS)])

    want = np.asarray(jax.jit(jax.vmap(one))(k_params))
    got = tenv._step_params(_kd(k_params))
    assert all(g.shape == (1024,) for g in got)
    np.testing.assert_array_equal(torch.stack(got, dim=1).numpy(), want)
    assert len(np.unique(want[:, 2])) > 1000
    plain = MiniWorldVec("MiniWorld-Hallway-v0", 2, obs_width=16, obs_height=12, device="cpu")
    assert plain._step_params(_kd(k_params[:2])) == (0.15, 0.0, 15.0)


# (id, procgen, layouts, B, the plan the port renders)
CASES = [
    ("MiniWorld-Hallway-v0", None, None, 8, "dense"),
    ("MiniWorld-FourRooms-v0", None, None, 8, "dense"),
    ("MiniWorld-Sidewalk-v0", None, None, 4, "dense-3"),
    ("MiniWorld-Maze-v0", False, 4, 8, "packed_pvs"),
    ("MiniWorld-MazeS3-v0", None, None, 8, "paired"),
    ("MiniWorld-PickupObjects-v0", None, None, 8, "mesh"),
]
DR_FIELDS = ("tex_map", "tri_slots", "ent_color", "sky_color", "light_pos", "light_color",
             "light_ambient", "cam_height", "cam_fwd_disp", "cam_pitch", "cam_fov_y")


@pytest.mark.parametrize("env_id,procgen,layouts,b,route", CASES,
                         ids=[c[4] + "-" + c[0].split("-")[1] for c in CASES])
def test_reset_and_render_match_jax(env_id, procgen, layouts, b, route):
    """The reset's draws equal ``_reset_one``'s exactly (the rest of the
    state within FLOAT_ATOL), and the port's render of the JAX state, its
    rows' texture variants on this route, matches JAX's."""
    kw = {} if procgen is None else {"procgen": procgen}
    jspec = env_id if layouts is None else jax_make_spec(env_id, num_layouts=layouts)
    tspec = env_id if layouts is None else make_spec(env_id, num_layouts=layouts)
    jenv = JaxVec(jspec, num_envs=b, obs_width=W, obs_height=H, domain_rand=True, **kw)
    tenv = MiniWorldVec(tspec, b, obs_width=W, obs_height=H, device="cpu", domain_rand=True,
                        **kw)
    kind = {"dense-3": "dense", "mesh": "dense", "paired": "dense"}.get(route, route)
    assert tenv.plan["kind"] == kind
    if route == "dense-3":
        assert tenv._bank.tri_verts9.shape[2] // tenv.tri_chunk == 3
    assert (tenv._pg_wall is not None) == (route == "paired")
    assert tenv._shapes_present[2] == (route == "mesh")
    jstate, (j_rgb, j_depth) = jenv.reset(jax.random.key(6))
    tstate, _ = tenv.reset(6)
    assert_states_match(jstate, tstate)
    port = to_port_state(jstate)
    for name in DR_FIELDS:
        assert torch.equal(getattr(tstate, name), getattr(port, name)), name
    for name in ("cam_fov_y", "light_pos", "sky_color"):  # drawn, not the default
        assert len(np.unique(np.asarray(getattr(jstate, name)), axis=0)) == b, name
    t_rgb, t_depth = tenv.render(port)
    assert_images_match(j_rgb, j_depth, t_rgb, t_depth)


def test_variants_reach_the_render():
    """FourRooms' slots take at least 2 variants across 8 envs, and the
    render's slot column carries atlas rows above their slot's base: the
    override is not a no-op. Winners and t equal the render without the
    override; only the slot column changes."""
    tenv = MiniWorldVec("MiniWorld-FourRooms-v0", 8, obs_width=W, obs_height=H,
                        device="cpu", domain_rand=True)
    state, _ = tenv.reset(2)
    tm = state.tex_map
    assert int((tm != tm[:1]).any(0).sum()) >= 2
    assert bool((tm != tenv._bank.tex_slot_base[state.layout_id.long()]).any())
    cam = trc.camera_grid(state, W, H)
    args = (tenv._bank.tri_verts9, tenv._bank.tri_attr, state.layout_id, cam, tenv._all_quads)
    override = (state.tri_slots, *tenv._slot_tex)
    t_ov, a_ov = trc.tri_pass(*args, override=override)
    t_no, a_no = trc.tri_pass(*args)
    assert torch.equal(t_ov, t_no)
    assert torch.equal(a_ov[..., :14], a_no[..., :14]) and torch.equal(a_ov[..., 15], a_no[..., 15])
    slot = a_ov[..., 14].float()
    bases = torch.unique(tenv._slot_tex[0][..., 1])
    assert bool((~torch.isin(slot[torch.isfinite(t_ov)], bases)).any())


def test_rollout_matches_jax():
    """A 5-step Hallway rollout with domain randomisation from one key:
    rewards, dones and checksums equal JAX's ``rollout``."""
    b = 8
    jenv = JaxVec("MiniWorld-Hallway-v0", num_envs=b, obs_width=W, obs_height=H,
                  domain_rand=True)
    tenv = MiniWorldVec("MiniWorld-Hallway-v0", b, obs_width=W, obs_height=H, device="cpu",
                        domain_rand=True)
    jstate, jobs = jenv.reset(jax.random.key(3))
    tstate, tobs = tenv.reset(3)
    _, _, j_out = jenv.rollout(jstate, jobs, jax.random.key(7), 5)
    _, _, t_out = tenv.rollout(tstate, tobs, trng.key_data(7), 5)
    for k in ("reward", "dones", "obs_sum"):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]).astype(
            t_out[k].numpy().dtype), err_msg=k)


def test_atlas_over_256_rows_raises():
    """Slot ids above 256 are not exact in the bf16 attribute carry: a
    Fourier atlas of 257 rows no longer raises, it installs (with and
    without domain_rand) and renders with the float32 carry, as the JAX
    package's attr_carry_dtype picks it; 256 rows keep bf16."""
    bank_np, tex_np = tvector.build_bank(make_spec("MiniWorld-Hallway-v0"))
    big = np.concatenate([tex_np] * (257 // tex_np.shape[0] + 1))[:257]
    for dr in (False, True):
        got, statics = tvector.install_statics(bank_np, big, 8, 80 * 60, domain_rand=dr)
        assert statics["plan"]["kind"] == "dense" and (statics["slot_tex"] is None) != dr
    assert trc.attr_carry_dtype(big.shape[0]) == torch.float32
    assert trc.attr_carry_dtype(256) == torch.bfloat16
    assert jrc.attr_carry_dtype({"mode": "fourier", "coeffs": big}, None) == jnp.float32
    assert jrc.attr_carry_dtype({"mode": "fourier", "coeffs": big[:256]}, None) == jnp.bfloat16
    tvector.install_statics(bank_np, big[:256], 8, 80 * 60)

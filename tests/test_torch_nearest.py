"""Nearest-mode textures of the port against the JAX package's
(``tex_mode="nearest"``, its bit-accurate texture path).

``eval_nearest`` exactly, on seeded inputs that cross texel edges; the
carry dtype of every ported id in both modes; the u8 atlas byte for
byte; Hallway's render at supersample=2, FourRooms' with domain
randomisation (the variants reach the render through ``tex_map``) and a
Hallway rollout against JAX's; and a 10x10 procgen maze, whose 660
layout-local slot ids need the float32 attribute carry: forcing bf16
on the port's plain path changes its image; the wrappers raise for the
kernel instances that are not built. The six ids' resets and steps are
in test_torch_nearest_ids.py and test_torch_nearest_wide.py.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu import vector as jvector
from miniworld_tpu.envs import make_spec as jax_make_spec
from miniworld_tpu.render import raycast as jrc
from miniworld_tpu_torch import MiniWorldVec, vector as tvector
from miniworld_tpu_torch.envs import ENV_IDS, make_spec
from miniworld_tpu_torch.ops import rng as trng
from miniworld_tpu_torch.render import raycast as trc

from _torch_parity import reset_and_steps
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

W, H = 32, 24


def test_eval_nearest_matches_jax():
    """Slots -1 to 527 (halves too: round half to even; 530 clamps to the
    last slot), uv on texel edges, a hair either side of them, negative
    and large: every texel equal."""
    rng = np.random.default_rng(0)
    b, p, n_ids, n_rows, res = 3, 4096, 528, 5, 256
    atlas = rng.integers(0, 256, (n_rows, res, res, 3), dtype=np.uint8)
    tex_map = rng.integers(0, n_rows, (b, n_ids), dtype=np.int32)
    slot = rng.integers(-1, n_ids, (b, p)).astype(np.float32)
    slot[:, :64] = rng.integers(-2, 2 * n_ids, (b, 64)) * np.float32(0.5)
    slot[:, 64:72] = [-1.0, -0.5, 0.5, 1.5, 2.5, 527.0, 527.5, 530.0]
    edges = rng.integers(-600, 600, (b, p, 2)).astype(np.float32) / np.float32(res)
    nudge = rng.choice([-1.0, 0.0, 1.0], (b, p, 2)).astype(np.float32) * np.float32(1e-6)
    uv = edges + nudge
    uv[:, :256] = rng.uniform(-1e4, 1e4, (b, 256, 2)).astype(np.float32)
    uv[:, 256:260, 0] = [-0.0, -1e-9, 1.0 - 1e-8, 3.0]
    want = np.stack([np.asarray(jrc.eval_nearest(jnp.asarray(atlas), jnp.asarray(tex_map[i]),
                                                 jnp.asarray(slot[i]), jnp.asarray(uv[i])))
                     for i in range(b)])
    got = trc.eval_nearest(torch.from_numpy(atlas), torch.from_numpy(tex_map),
                           torch.from_numpy(slot), torch.from_numpy(uv))
    assert got.dtype == torch.float32 and got.shape == (b, p, 3)
    np.testing.assert_array_equal(got.numpy(), want)


_TABLES = {}


def _slot_counts(env_id):
    """(atlas rows, layout-local slots) of the id's default bank, from the
    port's nearest build (the atlas rows are the Fourier table's too)."""
    if env_id not in _TABLES:
        spec = make_spec(env_id)
        build = tvector.build_super_bank if spec.procgen_default else tvector.build_bank
        bank_np, atlas = build(spec, "nearest")
        _TABLES[env_id] = atlas.shape[0], bank_np.tex_slot_base.shape[1]
    return _TABLES[env_id]


@pytest.mark.parametrize("mode", ["fourier", "nearest"])
def test_attr_carry_dtype_matches_jax(mode):
    """Every ported id's carry in both modes is JAX's attr_carry_dtype of
    the same tables: bf16 everywhere but the 8x8 procgen maze's 528
    nearest-mode slots."""
    f32 = []
    for env_id in ENV_IDS:
        n_rows, n_slots = _slot_counts(env_id)
        tex = {"mode": mode, "coeffs": np.zeros((n_rows, 1), np.float32)}
        want = jrc.attr_carry_dtype(tex, types.SimpleNamespace(tex_map=np.zeros(n_slots)))
        got = trc.attr_carry_dtype(n_rows if mode == "fourier" else n_slots)
        assert str(got).split(".")[-1] == jnp.dtype(want).name, env_id
        if got == torch.float32:
            f32.append(env_id)
    assert f32 == ([] if mode == "fourier" else ["MiniWorld-Maze-v0"])


@pytest.mark.parametrize("env_id", ["MiniWorld-Hallway-v0", "MiniWorld-Sign-v0",
                                    "MiniWorld-Maze-v0"])
def test_atlas_matches_jax(env_id):
    """The nearest-mode u8 atlas (build_bank / build_super_bank), byte for
    byte."""
    spec, jspec = make_spec(env_id), jax_make_spec(env_id)
    if spec.procgen_default:
        got = tvector.build_super_bank(spec, "nearest")[1]
        want = jvector.build_super_bank(jspec, "nearest")[1]
    else:
        got = tvector.build_bank(spec, "nearest")[1]
        want = jvector.build_bank(jspec, tex_mode="nearest")[1]
    assert got.dtype == np.uint8 and got.shape == want.shape and got.shape[1:] == (256, 256, 3)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("env_id,kwargs", [
    ("MiniWorld-Hallway-v0", {"supersample": 2}),
    ("MiniWorld-FourRooms-v0", {"domain_rand": True}),
], ids=["hallway-ss2", "fourrooms-domain_rand"])
def test_options_match_jax(env_id, kwargs):
    """Reset and 3 steps at B=2 with the option, as the ids' test runs
    them; with domain_rand the variants change the slot table."""
    frames = []
    reset_and_steps(env_id, 2, W, H, 3, seed=12, frames=frames, tex_mode="nearest", **kwargs)
    if kwargs.get("domain_rand"):
        env = MiniWorldVec(env_id, 2, obs_width=W, obs_height=H, device="cpu",
                           tex_mode="nearest")
        base = env._bank.tex_slot_base[frames[-1][0].layout_id.long()]
        assert not torch.equal(frames[-1][0].tex_map, base)


def test_f32_carry_is_load_bearing():
    """A 10x10 procgen maze (660 local slots) renders through the float32
    carry; forcing bf16 on the plain path rounds ids above 256 and
    changes the image (the mirror of
    tests/test_render.py::test_big_slot_tables_construct_and_stay_exact)."""
    spec = dataclasses.replace(make_spec("MiniWorld-Maze-v0"), num_rows=10, num_cols=10)
    env = MiniWorldVec(spec, 1, obs_width=W, obs_height=H, device="cpu", tex_mode="nearest")
    state, (rgb, depth) = env.reset(0)
    assert state.tex_map.shape[1] > 256
    assert rgb.shape == (1, H, W, 3) and bool(torch.isfinite(depth).all())
    orig = trc.attr_carry_dtype
    try:
        trc.attr_carry_dtype = lambda n_ids: torch.bfloat16
        rgb_bad, _ = env.render(state)
    finally:
        trc.attr_carry_dtype = orig
    assert not torch.equal(rgb_bad, rgb)
    assert torch.equal(env.render(state)[0], rgb)


def test_rollout_matches_jax():
    """A 5-step Hallway rollout in nearest mode from one key: rewards,
    dones and checksums equal JAX's ``rollout``."""
    b = 8
    jenv = JaxVec("MiniWorld-Hallway-v0", num_envs=b, obs_width=W, obs_height=H,
                  tex_mode="nearest")
    tenv = MiniWorldVec("MiniWorld-Hallway-v0", b, obs_width=W, obs_height=H, device="cpu",
                        tex_mode="nearest")
    jstate, jobs = jenv.reset(jax.random.key(4))
    tstate, tobs = tenv.reset(4)
    _, _, j_out = jenv.rollout(jstate, jobs, jax.random.key(9), 5)
    _, _, t_out = tenv.rollout(tstate, tobs, trng.key_data(9), 5)
    for k in ("reward", "dones", "obs_sum"):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]).astype(
            t_out[k].numpy().dtype), err_msg=k)


def test_unbuilt_instances_raise(monkeypatch):
    """The float32 carry with mesh rows, with the override and in fourier
    mode raised here while the kernels lacked those instances; now each
    wrapper runs them (on the card the F32 MESH, F32 OVERRIDE and Fourier
    F32 instances launch), and with is_cuda patched off it takes its
    plain route and equals the plain function. What the kernels still do
    not take raises before any launch: the dense super-bank kill with
    mesh rows or a schedule."""
    env = MiniWorldVec("MiniWorld-PickupObjects-v0", 2, obs_width=16, obs_height=12,
                       device="cpu")
    state, _ = env.reset(0)
    bank = env._bank
    cam = trc.camera_grid(state, 16, 12)
    mesh = trc.entity_mesh_rows(bank, state)[:2]
    tri = (bank.tri_verts9, bank.tri_attr, state.layout_id, cam, False)
    f32 = torch.float32
    monkeypatch.setattr(trc, "is_cuda", lambda *tensors: False)
    got = trc.tri_pass(*tri, mesh, attr_dtype=f32)
    want = trc.tri_pass_plain(*tri, seed=trc.entity_mesh_pass_plain(*mesh, cam, f32),
                              attr_dtype=f32)
    assert got[1].dtype == f32 and all(torch.equal(g, w) for g, w in zip(got, want))
    gen = torch.Generator().manual_seed(3)
    shape = bank.tri_attr.shape[:2]
    tex = torch.stack([torch.randint(0, 1 << 20, shape, generator=gen).float(),
                       torch.randint(250, 300, shape, generator=gen).float(),
                       torch.randint(1, 5, shape, generator=gen).float(),
                       torch.zeros(shape)], dim=-1)
    override = (state.tri_slots, tex, None)
    got = trc.tri_pass(*tri, override=override, attr_dtype=f32)
    want = trc.tri_pass_plain(*tri, override=override, attr_dtype=f32)
    assert bool((got[1][..., 14] > 256).any())
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    lights = (state.light_pos, state.light_color, state.light_ambient, state.sky_color)
    t_tri, attr = trc.tri_pass(*tri, mesh, attr_dtype=f32)
    got = trc.pixel_epilogue(t_tri, attr, None, None, None, env._atlas, cam, *lights, 16)
    want = trc.pixel_epilogue_plain(t_tri, attr, None, None, None, env._atlas, cam, *lights,
                                    16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    active = (trc.wall_codes(bank), torch.ones((2, 1)))
    monkeypatch.setattr(trc, "is_cuda", lambda *tensors: True)
    with pytest.raises(ValueError, match="tri_active"):
        trc.tri_pass(*tri, mesh, active=active)
    with pytest.raises(ValueError, match="tri_active"):
        trc.tri_pass(*tri[:2], state.layout_id[:, None].contiguous(), *tri[3:], active=active)

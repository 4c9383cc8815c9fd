"""The port's plain render stages against the JAX raycaster on the CPU.

Hallway states come from the JAX reset at B=4, 80x60; a wider synthetic
case adds 64 prims of mixed kind, spheres and boxes, flat (-1) and
missing atlas rows. Contract: the winner differs on at most 0.1% of the
pixels, depth within rtol 1e-5 where it agrees, RGB within 2 u8 levels
there.
"""

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu.ops import geom as jgeom
from miniworld_tpu.render import raycast as jrc
from miniworld_tpu_torch.convert import atlas_from_numpy, layout_from_numpy
from miniworld_tpu_torch.render import cuda_build, raycast as trc

from _torch_parity import (
    DEPTH_RTOL, ENV_ID, MAX_WINNER_DIFF, H, W, assert_images_match, to_port_state,
)
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B = 4
K = 16


@pytest.fixture(scope="module")
def hallway():
    jenv = JaxVec(ENV_ID, num_envs=B, obs_width=W, obs_height=H)
    jstate, _ = jenv.reset(jax.random.key(3))
    # spread the agents over the hallway, facing all ways, so walls,
    # floor, ceiling, the box and the sky all show up
    rng = np.random.default_rng(0)
    pos = np.stack([rng.uniform(-0.5, 10.5, B), np.zeros(B), rng.uniform(-1.5, 1.5, B)], 1)
    jstate = jstate.replace(pos=jnp.asarray(pos, jnp.float32),
                            dir=jnp.asarray(rng.uniform(-np.pi, np.pi, B), jnp.float32),
                            cam_pitch=jnp.asarray([0.0, 20.0, -30.0, 5.0], jnp.float32))
    return jenv, jstate


def _jax_camera(state):
    origin = jgeom.cam_position(state.pos, state.dir, state.cam_height, state.cam_fwd_disp)
    rays = jrc.camera_grid(state, W, H)
    tan_y = jnp.tan(jnp.deg2rad(state.cam_fov_y) * 0.5)
    return origin, rays, tan_y


_jax_cameras = jax.jit(jax.vmap(_jax_camera))


def _port_camera(jstate):
    """A port Camera holding the JAX camera's numbers."""
    origin, (fwd, right, up, xv, yv), tan_y = _jax_cameras(jstate)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tan_y = t(tan_y)
    ref = trc.camera_grid(to_port_state(jstate), W, H)
    cam = trc.Camera(t(origin), t(fwd), t(right), t(up), tan_y * (W / H), tan_y,
                     ref.xbase, ref.ybase)
    np.testing.assert_array_equal(cam.xv().numpy(), np.asarray(xv))
    np.testing.assert_array_equal(cam.yv().numpy(), np.asarray(yv))
    return cam, (origin, (fwd, right, up, xv, yv))


def _winner_stats(t_j, t_t, same):
    """Fraction of pixels whose winner differs, and the depth check
    where it agrees."""
    t_j, t_t = np.asarray(t_j), t_t.numpy()
    differ = 1.0 - same.mean()
    assert differ <= MAX_WINNER_DIFF, f"winner differs on {differ:.4%}"
    fin = same & np.isfinite(t_j)
    np.testing.assert_allclose(t_t[fin], t_j[fin], rtol=DEPTH_RTOL, atol=0)
    np.testing.assert_array_equal(np.isinf(t_t[same]), np.isinf(t_j[same]))
    return differ


def test_camera_grid(hallway):
    jenv, jstate = hallway
    cam, (origin, (fwd, right, up, _, _)) = _port_camera(jstate)
    port = trc.camera_grid(to_port_state(jstate), W, H)
    for name, want in (("origin", origin), ("fwd", fwd), ("right", right), ("up", up)):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(want), name)
    np.testing.assert_array_equal(port.tan_y.numpy(), cam.tan_y.numpy())


@pytest.mark.parametrize("tri_chunk", [8, 4])
def test_tri_pass(hallway, tri_chunk):
    """Single-chunk pass (the kernel's contract) and the chunk loop with
    its keyed-z carry (tri_chunk=4: two chunks)."""
    jenv, jstate = hallway
    cam, (origin, rays) = _port_camera(jstate)
    bank = jenv._bank

    def one(s, o, r):
        return jrc._tri_pass(bank.tri_verts9, bank.tri_attr, s.layout_id, o, r,
                             tri_chunk, all_quads=jenv._all_quads)

    t_j, a_j = jax.jit(jax.vmap(one))(jstate, origin, rays)
    tb = layout_from_numpy(jenv._bank_np)
    lid = torch.from_numpy(np.array(jstate.layout_id))
    if tri_chunk == tb.tri_verts9.shape[2]:
        t_t, a_t = trc.tri_pass_plain(tb.tri_verts9, tb.tri_attr, lid, cam, jenv._all_quads)
    else:
        t_t, a_t = trc.tri_pass_chunked(tb.tri_verts9, tb.tri_attr, lid, cam,
                                        tri_chunk, jenv._all_quads)
    assert a_t.dtype == torch.bfloat16
    a_j = np.asarray(a_j.astype(jnp.float32))
    a_t = a_t.float().numpy()
    hit = np.isfinite(np.asarray(t_j))
    same = np.where(hit, (a_j == a_t).all(-1), np.isinf(t_t.numpy()))
    _winner_stats(t_j, t_t, same)


def _synthetic(jenv, seed=1, S=64, E=4):
    """Wide case: a bank of S random prims (mixed kind, slots -1..A) plus
    box and sphere protos, and states with E entities of both shapes."""
    rng = np.random.default_rng(seed)
    bank_np = jenv._bank_np
    A = np.asarray(jenv._atlas).shape[0]
    v0 = np.stack([rng.uniform(-1, 11, S), rng.uniform(0, 2.7, S), rng.uniform(-2, 2, S)])
    e1 = rng.uniform(-2, 2, (3, S))
    e2 = rng.uniform(-2, 2, (3, S))
    verts9 = np.concatenate([v0, v0 + e1, v0 + e2])[None].astype(np.float32)
    attr = rng.uniform(-1, 1, (1, S, 16)).astype(np.float32)
    nrm = rng.normal(size=(S, 3))
    attr[0, :, 8:11] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    attr[0, :, 11:14] = rng.uniform(0, 1, (S, 3))
    attr[0, :, 14] = rng.integers(-1, A + 1, S)
    attr[0, :, 15] = rng.integers(0, 2, S)
    syn = dataclasses.replace(
        bank_np, tri_verts9=verts9, tri_attr=attr,
        proto_shape=np.array([[1, 2]], np.int32),  # SHAPE_BOX, SHAPE_SPHERE
        proto_static=np.zeros((1, 2), bool),
    )
    jstate, _ = jenv.reset(jax.random.key(seed))
    ent = dict(
        ent_pos=np.stack([rng.uniform(0, 10, (B, E)), rng.uniform(0, 0.5, (B, E)),
                          rng.uniform(-1.5, 1.5, (B, E))], -1),
        ent_dir=rng.uniform(-np.pi, np.pi, (B, E)),
        ent_size=rng.uniform(0.3, 1.2, (B, E, 3)),
        ent_height=rng.uniform(0.3, 1.2, (B, E)),
        ent_color=rng.uniform(0, 1, (B, E, 3)),
    )
    jstate = jstate.replace(
        **{k: jnp.asarray(v, jnp.float32) for k, v in ent.items()},
        ent_proto=jnp.asarray(rng.integers(0, 2, (B, E)), jnp.int32),
        ent_alive=jnp.asarray(rng.uniform(size=(B, E)) > 0.2),
        ent_radius=jnp.ones((B, E), jnp.float32),
        pos=jnp.asarray(np.stack([rng.uniform(-0.5, 3, B), np.zeros(B),
                                  rng.uniform(-1.5, 1.5, B)], 1), jnp.float32),
        dir=jnp.asarray(rng.uniform(-0.5, 0.5, B), jnp.float32),
    )
    return syn, jstate


def test_tri_pass_seeded_wide(hallway):
    """The seeded pass (raycast._tri_pass with ``init``) on the wide bank:
    random seeds in front of, behind and tied with the prims, misses
    (t = inf, zero attrs) included; the seed wins quantized-depth ties."""
    jenv, _ = hallway
    bank_np, jstate = _synthetic(jenv, seed=6)
    cam, (origin, rays) = _port_camera(jstate)
    jbank = jax.tree.map(jnp.asarray, bank_np)
    S = bank_np.tri_verts9.shape[2]

    def prims(s, o, r):
        return jrc._tri_pass(jbank.tri_verts9, jbank.tri_attr, s.layout_id, o, r, S)

    t0, _ = jax.jit(jax.vmap(prims))(jstate, origin, rays)
    rng = np.random.default_rng(7)
    t0 = np.asarray(t0)
    # a third of the seeds sit exactly on the prims' own depth (ties)
    pick = rng.integers(0, 3, t0.shape)
    seed_t = np.where(pick == 0, t0, rng.uniform(0.5, 12.0, t0.shape)).astype(np.float32)
    seed_t[rng.uniform(size=t0.shape) < 0.3] = np.inf
    seed_a = rng.uniform(-1, 1, t0.shape + (16,)).astype(np.float32)
    seed_a[np.isinf(seed_t)] = 0.0
    seed_a = np.asarray(jnp.asarray(seed_a).astype(jnp.bfloat16).astype(jnp.float32))

    def seeded(s, o, r, st, sa):
        return jrc._tri_pass(jbank.tri_verts9, jbank.tri_attr, s.layout_id, o, r, S,
                             init=(st, sa.astype(jnp.bfloat16)))

    t_j, a_j = jax.jit(jax.vmap(seeded))(jstate, origin, rays, seed_t, seed_a)
    seed = (torch.from_numpy(seed_t), torch.from_numpy(seed_a).to(torch.bfloat16))
    lid = torch.from_numpy(np.array(jstate.layout_id))
    tb = layout_from_numpy(bank_np)
    t_t, a_t = trc.tri_pass_plain(tb.tri_verts9, tb.tri_attr, lid, cam, False, seed)
    a_j = np.asarray(a_j.astype(jnp.float32))
    same = (a_j == a_t.float().numpy()).all(-1)
    _winner_stats(t_j, t_t, same)
    won = same & (a_j == seed_a).all(-1) & np.isfinite(seed_t)
    assert won.mean() > 0.1 and (same & ~won & np.isfinite(np.asarray(t_j))).mean() > 0.05


@pytest.mark.parametrize("case", ["hallway", "wide"])
def test_entity_pass(hallway, case):
    jenv, jstate = hallway
    bank_np = jenv._bank_np
    shapes = jenv._shapes_present
    if case == "wide":
        bank_np, jstate = _synthetic(jenv)
        shapes = (True, True, False)
    jbank = jax.tree.map(jnp.asarray, bank_np)
    cam, (origin, rays) = _port_camera(jstate)

    def one(s, o, r):
        return jrc._entity_pass(jbank, s.layout_id, s, o, r, shapes)

    t_j, c_j, n_j = jax.jit(jax.vmap(one))(jstate, origin, rays)
    ts = to_port_state(jstate)
    flags = trc.entity_flags(layout_from_numpy(bank_np), ts)
    t_t, c_t, n_t = trc.entity_pass_plain(ts.ent_pos, ts.ent_size, ts.ent_dir, ts.ent_height,
                                          ts.ent_color, flags, cam, shapes[0], shapes[1])
    c_j, n_j = np.asarray(c_j), np.asarray(n_j)
    same = (c_j == c_t.numpy()).all(-1) & np.isclose(n_t.numpy(), n_j, atol=1e-5).all(-1)
    _winner_stats(t_j, t_t, same)
    assert np.isfinite(np.asarray(t_j)).mean() > 0.01  # entities are in view


def test_eval_fourier_and_shade(hallway):
    """Per-pixel texture model and lighting on random inputs."""
    jenv, jstate = hallway
    rng = np.random.default_rng(2)
    n = 4096
    atlas = np.array(jenv._atlas)
    slot = rng.integers(-1, atlas.shape[0] + 1, n).astype(np.float32)
    uv = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
    fp = rng.uniform(0, 0.05, n).astype(np.float32)
    want = jax.jit(partial(jrc.eval_fourier, k_terms=K, has_gain=False))(
        jnp.asarray(atlas), jnp.asarray(slot), jnp.asarray(uv), footprint=jnp.asarray(fp))
    got = trc.eval_fourier(torch.from_numpy(atlas), torch.from_numpy(slot),
                           torch.from_numpy(uv), K, torch.from_numpy(fp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2 / 255)
    # bf16 sums round alike in both; most texels agree exactly
    assert (np.abs(got.numpy() - np.asarray(want)) < 1e-6).mean() > 0.99

    color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    hit_p = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    s0 = jax.tree.map(lambda a: a[0], jstate)
    want = jax.jit(jrc.shade)(color, nrm, hit_p, s0)
    light = [torch.from_numpy(np.repeat(np.asarray(getattr(s0, k))[None], n, 0))
             for k in ("light_pos", "light_color", "light_ambient")]
    got = trc.shade(torch.from_numpy(color), torch.from_numpy(nrm), torch.from_numpy(hit_p),
                    *light)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["hallway", "wide"])
def test_render_rgbd(hallway, case):
    """The whole render: the JAX raycaster against the port's wrappers,
    which on CPU tensors run the plain stages and launch nothing."""
    jenv, jstate = hallway
    bank_np, shapes, all_quads = jenv._bank_np, jenv._shapes_present, jenv._all_quads
    if case == "wide":
        bank_np, jstate = _synthetic(jenv, seed=4)
        shapes, all_quads = (True, True, False), False
    jbank = jax.tree.map(jnp.asarray, bank_np)
    tex = {"mode": "fourier", "coeffs": jenv._atlas, "k": K, "has_gain": False}
    fn = partial(jrc.render_rgbd, tex=tex, width=W, height=H,
                 tri_chunk=bank_np.tri_verts9.shape[2], shapes_present=shapes,
                 all_quads=all_quads)
    j_rgb, j_depth = jax.jit(jax.vmap(fn, in_axes=(None, 0)))(jbank, jstate)
    cuda_build.reset_launch_counts()
    t_rgb, t_depth = trc.render_rgbd(
        layout_from_numpy(bank_np), to_port_state(jstate),
        atlas_from_numpy(np.asarray(jenv._atlas)), width=W, height=H, k_terms=K,
        shapes_present=shapes, all_quads=all_quads)
    assert not any(cuda_build.LAUNCHES.values())
    assert t_rgb.dtype == torch.uint8 and t_depth.dtype == torch.float32
    differ, _ = assert_images_match(j_rgb, j_depth, t_rgb, t_depth)
    d = t_depth.numpy()
    assert np.isfinite(d).all() and d.min() > trc.NEAR and d.max() <= trc.FAR
    assert (d < trc.FAR).mean() > 0.5 and math.isfinite(differ)


def test_sqrt_rounds_once():
    """The plain stages' square root (geom.sqrt, the footprint's, the
    light distance's and the sphere hit's): on 40,000 float32 values over
    twelve octaves, bit for bit jnp.sqrt's (XLA:CPU) and the float64 root
    rounded to float32, the same bits on every call (torch.sqrt on the
    CPU is within one ulp of it)."""
    from miniworld_tpu_torch.ops import geom as tgeom

    rng = np.random.default_rng(12)
    x = (rng.uniform(1.0, 2.0, 40_000) * 2.0 ** rng.integers(-6, 6, 40_000)).astype(np.float32)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.sqrt(jnp.asarray(x))), want)
    for _ in range(3):
        got = tgeom.sqrt(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (40_000,)
        np.testing.assert_array_equal(got.numpy(), want)

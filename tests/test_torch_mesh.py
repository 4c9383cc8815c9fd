"""The port's mesh entities against the JAX package on the CPU: OBJ/MTL
loading, decimation and prototype rows exactly, the per-frame world rows
exactly, and the mesh-entity pass, the seeded tri_pass and the whole
PickupObjects render under the _torch_parity rules (winner differs on at
most 0.1% of the pixels, depth within rtol 1e-5 and RGB within 2 u8
levels where it agrees)."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu.ops import geom as jgeom
from miniworld_tpu.render import raycast as jrc
from miniworld_tpu.scene import entities as jent, mesh as jmesh
from miniworld_tpu_torch.convert import atlas_from_numpy, layout_from_numpy
from miniworld_tpu_torch.render import cuda_build, raycast as trc
from miniworld_tpu_torch.scene import entities as tent, mesh as tmesh

from _torch_parity import DEPTH_RTOL, MAX_WINNER_DIFF, H, W, assert_images_match, to_port_state
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

PICK_ID = "MiniWorld-PickupObjects-v0"
B = 6
MESHES = ["key_red", "ball_blue", "duckie", "barrel"]


def _assert_trimesh_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", MESHES)
def test_load_mesh(name):
    _assert_trimesh_equal(tmesh.load_mesh(name), jmesh.load_mesh(name))


@pytest.mark.parametrize("name", MESHES)
def test_decimate_mesh(name):
    budget = tent.MESH_TRI_BUDGET
    _assert_trimesh_equal(tmesh.decimate_mesh(tmesh.load_mesh(name), budget),
                          jmesh.decimate_mesh(jmesh.load_mesh(name), budget))


@pytest.mark.parametrize("name", MESHES)
def test_mesh_color(name):
    """Kd x mean texture colour: the port's PNG reader and bicubic resize
    against Pillow (duckie and barrel are textured)."""
    np.testing.assert_array_equal(tent._mesh_color(tmesh.load_mesh(name)),
                                  jent._mesh_color(jmesh.load_mesh(name)))


@pytest.mark.parametrize("kind,args", [
    ("ball", ("green", 0.9)), ("key", ("yellow",)), ("mesh", ("duckie", 0.5, False)),
    ("mesh", ("barrel", 1.2, True)), ("box", ("purple", 0.9)),
])
def test_proto(kind, args):
    """Prototype rows, mesh rows included (textured rows carry the slot
    that slot_fn gives their texture)."""
    slots = {}

    def slot_fn(path):
        return slots.setdefault(path, len(slots))

    def make(lib):
        fn = {"ball": lib.ball_proto, "key": lib.key_proto, "mesh": lib.mesh_box_proto,
              "box": lib.box_proto}[kind]
        return fn(*args) if kind in ("ball", "box") else fn(*args, slot_fn=slot_fn)

    got, want = make(tent), make(jent)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.fixture(scope="module")
def pickup():
    """PickupObjects states from the JAX reset, agents spread over the
    room looking at their entities (env i at slot i mod 5), some
    entities dead, random entity yaw."""
    jenv = JaxVec(PICK_ID, num_envs=B, obs_width=W, obs_height=H)
    jstate, _ = jenv.reset(jax.random.key(5))
    rng = np.random.default_rng(3)
    E = jstate.ent_pos.shape[1]
    pos = np.stack([rng.uniform(1, 11, B), np.zeros(B), rng.uniform(1, 11, B)], 1)
    target = np.asarray(jstate.ent_pos)[np.arange(B), np.arange(B) % E]
    yaw = np.arctan2(-(target[:, 2] - pos[:, 2]), target[:, 0] - pos[:, 0])
    alive = rng.uniform(size=(B, E)) > 0.15
    alive[np.arange(B), np.arange(B) % E] = True
    jstate = jstate.replace(
        pos=jnp.asarray(pos, jnp.float32), dir=jnp.asarray(yaw, jnp.float32),
        ent_dir=jnp.asarray(rng.uniform(-np.pi, np.pi, (B, E)), jnp.float32),
        ent_alive=jnp.asarray(alive),
    )
    return jenv, jstate


def _jax_camera(state):
    origin = jgeom.cam_position(state.pos, state.dir, state.cam_height, state.cam_fwd_disp)
    return origin, jrc.camera_grid(state, W, H)


def _cameras(jstate):
    """The JAX camera and the port's Camera of the same state (the
    port's camera agrees with it bit for bit; test_torch_render)."""
    origin, rays = jax.jit(jax.vmap(_jax_camera))(jstate)
    cam = trc.camera_grid(to_port_state(jstate), W, H)
    np.testing.assert_array_equal(cam.origin.numpy(), np.asarray(origin))
    np.testing.assert_array_equal(cam.xv().numpy(), np.asarray(rays[3]))
    np.testing.assert_array_equal(cam.yv().numpy(), np.asarray(rays[4]))
    return origin, rays, cam


def _winner_stats(t_j, t_t, same):
    t_j, t_t = np.asarray(t_j), t_t.numpy()
    differ = 1.0 - same.mean()
    assert differ <= MAX_WINNER_DIFF, f"winner differs on {differ:.4%}"
    fin = same & np.isfinite(t_j)
    np.testing.assert_allclose(t_t[fin], t_j[fin], rtol=DEPTH_RTOL, atol=0)
    np.testing.assert_array_equal(np.isinf(t_t[same]), np.isinf(t_j[same]))


def test_entity_mesh_rows(pickup):
    """World rows exactly: vertices (inactive rows zeroed), the composed
    affine-uv rows, normal, tint, atlas slot, and the live-row mask."""
    jenv, jstate = pickup
    bank = jenv._bank

    def one(s):
        return jrc.entity_mesh_rows(bank, s.layout_id, s, True, return_valid=True)

    jv, ja, jval = jax.jit(jax.vmap(one))(jstate)
    tv9, ta, tval = trc.entity_mesh_rows(layout_from_numpy(jenv._bank_np),
                                         to_port_state(jstate))
    jv9 = np.asarray(jv).reshape(B, -1, 9).transpose(0, 2, 1)
    np.testing.assert_array_equal(tv9.numpy(), jv9)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    assert 0 < tval.sum() < tval.numel()  # live and inactive rows both present


def test_entity_mesh_pass(pickup):
    jenv, jstate = pickup
    bank = jenv._bank
    origin, rays, cam = _cameras(jstate)

    def one(s, o, r):
        return jrc._entity_mesh_pass(bank, s.layout_id, s, o, r, True)

    t_j, a_j = jax.jit(jax.vmap(one))(jstate, origin, rays)
    rows9, attrs, _ = trc.entity_mesh_rows(layout_from_numpy(jenv._bank_np),
                                           to_port_state(jstate))
    t_t, a_t = trc.entity_mesh_pass_plain(rows9, attrs, cam)
    assert a_t.dtype == torch.bfloat16
    a_j = np.asarray(a_j.astype(jnp.float32))
    a_t = a_t.float().numpy()
    same = (a_j == a_t).all(-1)  # zeros on both sides where nothing is hit
    _winner_stats(t_j, t_t, same)
    assert np.isfinite(np.asarray(t_j)).mean() > 0.01  # the meshes are in view


def test_tri_pass_seeded(pickup):
    """The static prims seeded with the mesh pass's result, as
    render_rgbd runs them (JAX _tri_pass with ``init``)."""
    jenv, jstate = pickup
    bank = jenv._bank
    origin, rays, cam = _cameras(jstate)
    S = jenv._bank_np.tri_verts9.shape[2]

    def one(s, o, r):
        seed = jrc._entity_mesh_pass(bank, s.layout_id, s, o, r, True)
        return seed, jrc._tri_pass(bank.tri_verts9, bank.tri_attr, s.layout_id, o, r, S,
                                   init=seed, all_quads=jenv._all_quads)

    (st_j, sa_j), (t_j, a_j) = jax.jit(jax.vmap(one))(jstate, origin, rays)
    tb = layout_from_numpy(jenv._bank_np)
    seed = (torch.from_numpy(np.array(st_j)),
            torch.from_numpy(np.asarray(sa_j.astype(jnp.float32))).to(torch.bfloat16))
    lid = torch.from_numpy(np.array(jstate.layout_id))
    t_t, a_t = trc.tri_pass_plain(tb.tri_verts9, tb.tri_attr, lid, cam, jenv._all_quads, seed)
    a_j = np.asarray(a_j.astype(jnp.float32))
    a_t = a_t.float().numpy()
    same = (a_j == a_t).all(-1)  # the seed's zero attrs where nothing is hit
    _winner_stats(t_j, t_t, same)
    seeded = np.isfinite(np.asarray(st_j)) & (np.asarray(st_j) <= np.asarray(t_j) * (1 + 1e-3))
    assert seeded.mean() > 0.001  # mesh entities win some pixels


def test_render_rgbd(pickup):
    """The whole PickupObjects render (mesh pass seeding tri_pass,
    analytic balls, epilogue) through the port's wrappers, which on CPU
    tensors run the plain stages and launch nothing."""
    jenv, jstate = pickup
    tex = {"mode": "fourier", "coeffs": jenv._atlas, "k": jenv.fourier_k, "has_gain": False}
    fn = partial(jrc.render_rgbd, tex=tex, width=W, height=H, tri_chunk=jenv.tri_chunk,
                 shapes_present=jenv._shapes_present, all_quads=jenv._all_quads)
    j_rgb, j_depth = jax.jit(jax.vmap(fn, in_axes=(None, 0)))(jenv._bank, jstate)
    cuda_build.reset_launch_counts()
    t_rgb, t_depth = trc.render_rgbd(
        layout_from_numpy(jenv._bank_np), to_port_state(jstate),
        atlas_from_numpy(np.asarray(jenv._atlas)), width=W, height=H,
        k_terms=jenv.fourier_k, shapes_present=jenv._shapes_present,
        all_quads=jenv._all_quads)
    assert not any(cuda_build.LAUNCHES.values())
    assert_images_match(j_rgb, j_depth, t_rgb, t_depth)


def test_entity_mesh_pass_row_budget():
    """More mesh rows than the z-key's 10 index bits can name are refused
    by the tri_pass wrapper, which runs the mesh pass in its launch."""
    n = (1 << 10) + 1
    cam = trc.Camera(torch.zeros(1, 3), torch.tensor([[1.0, 0, 0]]), torch.tensor([[0, 0, 1.0]]),
                     torch.tensor([[0, 1.0, 0]]), torch.ones(1), torch.ones(1),
                     torch.zeros(4), torch.zeros(3))
    with pytest.raises(ValueError, match="budget"):
        trc.tri_pass(torch.zeros(1, 9, 8), torch.zeros(1, 8, 16), torch.zeros(1, dtype=torch.int32),
                     cam, mesh=(torch.zeros(1, 9, n), torch.zeros(1, n, 16)))

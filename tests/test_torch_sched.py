"""The port's scheduled tri_pass against the JAX package's.

A schedule is each env's list of chunks: packed PVS over more than one
chunk a render (the ``sched_len`` chunks from ``pvs_room_base[layout,
room]``), the same seeded by the mesh pass, ``chunk_vis`` (the sorted
chunks visible from the camera's room) and a dense scan seeded by mesh
rows. The constructor's ``tri_chunk`` reaches the first two (FourRooms,
ThreeRooms, the MazeS3 bank at 16); the 8x8 Maze's layout bank plans
packed PVS of 2 chunks a render at 320x240 samples (160x120,
supersample=2), B=1024; these tests take a bank of 2 of its layouts at a
chunk cap of 96 and render it small (the plan follows the chunk cap, the
render size does not). ``chunk_vis``, reached with the packed planner
switched off, is held in tests/test_torch_chunks.py.

Tolerances: plans, schedules, rewards and dones exact; the plain scan
``tri_pass_scheduled`` against JAX's ``_tri_pass`` t exact and winners
equal; images by ``assert_images_match`` (winners equal on 99.9% of the
pixels, depth rtol 1e-5, RGB within 2 u8 levels where they agree).

JAX's one-hot chunk read (raycast.py:234-250) runs past a layout's last
chunk where ``base + j >= NC`` and reads the next layout's first chunk;
the port clamps the read inside the layout, as JAX's ``dynamic_slice``
read does. The envs where the reads part are counted and named, and held
against JAX's clamped read.
"""

import dataclasses
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu import vector as jvector
from miniworld_tpu.envs import make_spec as jax_make_spec
from miniworld_tpu.render import raycast as jrc
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch import vector as tvector
from miniworld_tpu_torch.convert import atlas_from_numpy, layout_from_numpy
from miniworld_tpu_torch.envs import make_spec
from miniworld_tpu_torch.render import raycast as trc

from _torch_parity import assert_images_match, reset_and_steps, to_port_state
from test_torch_chunks import _jax_cameras, _port_camera
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

W, H = 32, 24
ROUTES = {  # id -> constructor arguments of a scheduled plan
    "fourrooms": ("MiniWorld-FourRooms-v0", {"tri_chunk": 16}),
    "threerooms": ("MiniWorld-ThreeRooms-v0", {"tri_chunk": 16}),
    "mazes3-bank": ("MiniWorld-MazeS3-v0", {"tri_chunk": 16, "procgen": False}),
}
# the 8x8 Maze's layout bank of 2 layouts at B=1024: layout 0's room 123
# starts at its last chunk, so JAX's one-hot read of its second slot reads
# layout 1's first chunk
MAZE_ID, MAZE_B, OVERRUN = "MiniWorld-Maze-v0", 1024, (0, 123)


_ROUTE_ENVS = {}


def _route_envs(route):
    """(JAX env, port env) of a route at B=4, W x H, built once."""
    if route not in _ROUTE_ENVS:
        env_id, kw = ROUTES[route]
        _ROUTE_ENVS[route] = (JaxVec(env_id, num_envs=4, obs_width=W, obs_height=H, **kw),
                              MiniWorldVec(env_id, 4, obs_width=W, obs_height=H, device="cpu",
                                           **kw))
    return _ROUTE_ENVS[route]


@pytest.mark.parametrize("route", list(ROUTES))
def test_plan_with_tri_chunk_matches_jax(route):
    """tri_chunk=16 caps the culling planner, as in the JAX constructor:
    the three ids plan packed PVS over 2 chunks a render in both
    packages (kind, chunk, schedule length, chunks a layout, room bases
    and the packed rows equal)."""
    jenv, tenv = _route_envs(route)
    plan = tenv.plan
    assert jenv._pvs_packed and plan["kind"] == "packed_pvs"
    assert (plan["tri_chunk"], plan["sched_len"]) == (jenv.tri_chunk, jenv._sched_len)
    assert plan["sched_len"] == 2 and plan["tri_chunk"] == {"mazes3-bank": 48}.get(route, 32)
    assert plan["nc"] == jenv._bank_np.pvs_verts9.shape[2] // jenv.tri_chunk
    for name in ("pvs_room_base", "pvs_v9_rows", "pvs_attr_rows"):
        np.testing.assert_array_equal(getattr(tenv._bank_np, name),
                                      getattr(jenv._bank_np, name), err_msg=name)
    assert tenv._shapes_present == jenv._shapes_present


def _spread_states(jenv, b, seed):
    """A JAX reset of b envs with the agents spread over the rooms of
    each env's layout (uniform in a room's box, up to 0.3 from its
    sides), uniform yaws."""
    jstate = jenv._reset_jit(jenv._bank, jax.random.split(jax.random.key(seed), b))
    rng = np.random.default_rng(seed)
    bank = jenv._bank_np
    lid = np.asarray(jstate.layout_id)
    pos = np.zeros((b, 3), np.float32)
    for i in range(b):
        aabb = bank.room_aabb[lid[i]][bank.room_mask[lid[i]]]
        a = aabb[rng.integers(len(aabb))]
        mx, mz = min(0.3, 0.25 * (a[1] - a[0])), min(0.3, 0.25 * (a[3] - a[2]))
        pos[i] = [rng.uniform(a[0] + mx, a[1] - mx), 0.0, rng.uniform(a[2] + mz, a[3] - mz)]
    return jstate.replace(pos=jnp.asarray(pos),
                          dir=jnp.asarray(rng.uniform(-np.pi, np.pi, b), jnp.float32))


def _jax_scan(jstate, one):
    origin, rays = _jax_cameras(jstate, W, H)
    t, a = jax.jit(jax.vmap(one))(jstate, origin, rays)
    return np.asarray(t), np.asarray(a.astype(jnp.float32))


def _check_scan(got, want):
    t, a = got
    np.testing.assert_array_equal(t.numpy(), want[0])
    np.testing.assert_array_equal(a.float().numpy(), want[1])
    assert np.isfinite(want[0]).mean() > 0.3


@pytest.fixture(scope="module")
def three():
    """ThreeRooms at tri_chunk=16 in both packages, 4 envs over its rooms."""
    jenv, tenv = _route_envs("threerooms")
    return jenv, tenv, _spread_states(jenv, 4, 4)


def test_scheduled_scan_seeded_matches_jax(three):
    """Packed PVS over 2 chunks of 32, seeded by the mesh pass (JAX's
    ``init``: the seed wins quantized-depth ties): tri_pass_scheduled on
    the port's static_rows equals JAX's ``_tri_pass`` with the one-hot
    chunk read (a last layout's overrun reads zeros, as the repeat of a
    clamped chunk renders nothing new)."""
    jenv, tenv, jstate = three
    jbank = jenv._bank
    ncl = jbank.pvs_v9_rows.shape[0] // jbank.pvs_verts9.shape[0]

    def one(s, o, r):
        room = jrc.room_of_point(jbank, s.layout_id, o[jnp.array([0, 2])])
        sched = jbank.pvs_room_base[s.layout_id, room] + jnp.arange(2, dtype=jnp.int32)
        seed = jrc._entity_mesh_pass(jbank, s.layout_id, s, o, r, fourier=True,
                                     attr_dtype=jnp.bfloat16)
        return jrc._tri_pass(jbank.pvs_verts9, jbank.pvs_attr, s.layout_id, o, r, 32,
                             chunk_sched=sched, init=seed,
                             chunk_rows=(jbank.pvs_v9_rows, jbank.pvs_attr_rows, ncl))

    want = _jax_scan(jstate, one)
    cam, _ = _port_camera(jstate, W, H)
    state = to_port_state(jstate)
    rows, paired = trc.static_rows(tenv._bank, state, cam, plan=tenv.plan)
    assert paired is None and rows[2].shape == (4, 2)
    seed = trc.entity_mesh_pass_plain(*trc.entity_mesh_rows(tenv._bank, state)[:2], cam)
    _check_scan(trc.tri_pass_scheduled(*rows, cam, tenv._all_quads, seed), want)


def test_dense_seeded_scan_matches_jax(three):
    """A dense bank over several chunks with mesh rows (no id plans it)
    is the schedule 0..n-1 of every env: ThreeRooms' 40 rows (64 as its
    packed plan pads them) in 4 chunks of 16, seeded by the mesh pass,
    against JAX's dense scan
    with ``init``."""
    jenv, tenv, jstate = three
    jbank = jenv._bank
    jdense = jvector._repad_for_chunks(jenv._bank_np, 16)
    v9, at = jnp.asarray(jdense.tri_verts9), jnp.asarray(jdense.tri_attr)

    def one(s, o, r):
        seed = jrc._entity_mesh_pass(jbank, s.layout_id, s, o, r, fourier=True,
                                     attr_dtype=jnp.bfloat16)
        return jrc._tri_pass(v9, at, s.layout_id, o, r, 16, init=seed)

    want = _jax_scan(jstate, one)
    cam, _ = _port_camera(jstate, W, H)
    state = to_port_state(jstate)
    nc = jdense.tri_verts9.shape[2] // 16
    plan = dict(kind="dense", tri_chunk=16, sched_len=None, nc=nc)
    v9r, atr = tvector.chunk_row_views(jdense.tri_verts9, jdense.tri_attr, 16)
    bank = dataclasses.replace(tenv._bank, pvs_v9_rows=torch.from_numpy(v9r),
                               pvs_attr_rows=torch.from_numpy(atr))
    rows, _ = trc.static_rows(bank, state, cam, plan=plan)
    assert nc == 4 and rows[0].shape == (4, 9, 16) and rows[2].tolist() == [[0, 1, 2, 3]] * 4
    seed = trc.entity_mesh_pass_plain(*trc.entity_mesh_rows(tenv._bank, state)[:2], cam)
    _check_scan(trc.tri_pass_scheduled(*rows, cam, tenv._all_quads, seed), want)


@pytest.fixture(scope="module")
def maze_bank():
    """The 8x8 Maze's bank of 2 layouts planned at B=1024 and 320x300
    samples (chunk cap 96: packed PVS, 2 chunks of 96, NC=72), with and
    without domain randomisation: the JAX env (the rendering reference)
    and the port's statics (``install_statics`` on the port's bank at
    that size); 16 envs spread over the rooms, the last 8 in layout 0's
    room 123 (its base is NC - 1) at 8 yaws."""
    bank_np, tex_np = tvector.build_bank(make_spec(MAZE_ID, num_layouts=2))
    bank = {}
    for dr in (False, True):
        kw = dict(obs_width=160, obs_height=150, supersample=2, procgen=False, domain_rand=dr)
        jenv = JaxVec(jax_make_spec(MAZE_ID, num_layouts=2), num_envs=MAZE_B, **kw)
        tbank, st = tvector.install_statics(bank_np, tex_np, MAZE_B, 320 * 300, dr)
        tenv = SimpleNamespace(
            plan=st["plan"], _bank=layout_from_numpy(tbank), _atlas=atlas_from_numpy(tex_np),
            fourier_k=jenv.fourier_k, _shapes_present=st["shapes_present"],
            _all_quads=st["all_quads"],
            _slot_tex=None if st["slot_tex"] is None else tuple(
                None if t is None else torch.from_numpy(t) for t in st["slot_tex"]))
        bank[dr] = jenv, tenv
    jenv = bank[False][0]
    jstate = _spread_states(jenv, 16, 9)
    room = jenv._bank_np.room_aabb[OVERRUN[0], OVERRUN[1]]
    pos = np.asarray(jstate.pos).copy()
    pos[8:] = [0.5 * (room[0] + room[1]), 0.0, 0.5 * (room[2] + room[3])]
    yaw = np.asarray(jstate.dir).copy()
    yaw[8:] = np.arange(8) * (np.pi / 4)
    lid = np.asarray(jstate.layout_id).copy()
    lid[8:] = OVERRUN[0]
    jstate = jstate.replace(pos=jnp.asarray(pos), dir=jnp.asarray(yaw, jnp.float32),
                            layout_id=jnp.asarray(lid, jnp.int32))
    return bank, jstate


def _jax_render(jenv, bank, jstate, tri_chunk, sched_len):
    tex = {"mode": "fourier", "coeffs": jenv._atlas, "k": jenv.fourier_k, "has_gain": False}
    fn = partial(jrc.render_rgbd, tex=tex, width=W, height=H, tri_chunk=tri_chunk,
                 shapes_present=jenv._shapes_present, all_quads=jenv._all_quads,
                 pvs_packed=True, sched_len=sched_len, domain_rand=jenv.domain_rand)
    return jax.jit(jax.vmap(fn, in_axes=(None, 0)))(bank, jstate)


@pytest.mark.parametrize("domain_rand", [False, True], ids=["fourier", "domain_rand"])
def test_maze_bank_render_and_overrun(maze_bank, domain_rand):
    """render_rgbd of the port's schedule (2 chunks of 96) against JAX's:
    every env against JAX's clamped read (the bank without its chunk
    rows: the dynamic_slice read, the one domain randomisation always
    takes); without it, the envs whose schedule stays inside the layout
    against JAX's default one-hot read too. The envs whose slot runs past
    the layout (layout 0, room 123, base = NC - 1) are counted and named;
    where JAX's foreign chunk is hidden behind the room's walls, as at
    these 8 yaws, they match the one-hot read as well."""
    (envs, jstate) = maze_bank
    jenv, tenv = envs[domain_rand]
    plan = tenv.plan
    assert (plan["kind"], plan["tri_chunk"], plan["sched_len"], plan["nc"], plan["cap"]) == (
        "packed_pvs", jenv.tri_chunk, jenv._sched_len, 72, 96)
    assert (jenv.tri_chunk, jenv._sched_len) == (96, 2)
    state = to_port_state(jstate)
    cam, _ = _port_camera(jstate, W, H)
    sched = trc.chunk_schedule(tenv._bank, state.layout_id, cam.origin, plan)
    room = trc.room_of_point(tenv._bank, state.layout_id, cam.origin[:, [0, 2]])
    base = tenv._bank.pvs_room_base[state.layout_id.long(), room]
    overrun = (base + plan["sched_len"] > plan["nc"]).numpy()
    named = sorted({(int(state.layout_id[i]), int(room[i])) for i in np.where(overrun)[0]})
    assert int(overrun.sum()) >= 8 and named == [OVERRUN], named
    want = state.layout_id[:, None].long() * plan["nc"] + torch.clamp(
        base[:, None].long() + torch.arange(2), max=plan["nc"] - 1)
    assert torch.equal(sched.long(), want)
    t_rgb, t_depth = trc.render_rgbd(
        tenv._bank, state, tenv._atlas, width=W, height=H, k_terms=tenv.fourier_k,
        shapes_present=tenv._shapes_present, all_quads=tenv._all_quads, plan=plan,
        slot_tex=tenv._slot_tex)
    clamped = dataclasses.replace(jenv._bank, pvs_v9_rows=None, pvs_attr_rows=None)
    j_rgb, j_depth = _jax_render(jenv, clamped, jstate, jenv.tri_chunk, jenv._sched_len)
    assert_images_match(j_rgb, j_depth, t_rgb, t_depth)
    if not domain_rand:
        d_rgb, d_depth = _jax_render(jenv, jenv._bank, jstate, jenv.tri_chunk, jenv._sched_len)
        inside = ~overrun
        assert_images_match(np.asarray(d_rgb)[inside], np.asarray(d_depth)[inside],
                            t_rgb[inside], t_depth[inside])
        hidden = (np.array_equal(np.asarray(d_rgb)[overrun], np.asarray(j_rgb)[overrun])
                  and np.array_equal(np.asarray(d_depth)[overrun], np.asarray(j_depth)[overrun]))
        assert hidden  # JAX's foreign chunk lies behind layout 0's walls at these poses
        assert_images_match(d_rgb, d_depth, t_rgb, t_depth)


@pytest.mark.parametrize("route", list(ROUTES))
def test_reset_and_steps_tri_chunk(route):
    """MiniWorldVec with tri_chunk=16 against the JAX package's, B=4, 3
    steps: rewards, dones and states as in every port id's test, images
    by assert_images_match (ThreeRooms: the schedule seeded by its mesh
    rows)."""
    reset_and_steps(ROUTES[route][0], 4, W, H, 3, seed=11, envs=_route_envs(route))


def test_render_domain_rand_matches_jax():
    """FourRooms with tri_chunk=16 and domain randomisation (each packed
    row's texture variant under the env's key, JAX's dynamic_slice read)
    from the JAX package's reset state: images by assert_images_match."""
    env_id, kw = ROUTES["fourrooms"]
    jenv = JaxVec(env_id, num_envs=4, obs_width=W, obs_height=H, domain_rand=True, **kw)
    tenv = MiniWorldVec(env_id, 4, obs_width=W, obs_height=H, device="cpu", domain_rand=True,
                        **kw)
    assert tenv.plan["sched_len"] == 2 and tenv._slot_tex[0].shape[1:] == (32, 4)
    jstate, (j_rgb, j_depth) = jenv.reset(jax.random.key(6))
    t_rgb, t_depth = tenv.render(to_port_state(jstate))
    assert_images_match(j_rgb, j_depth, t_rgb, t_depth)

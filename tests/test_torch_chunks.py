"""The port's chunk plans and chunked scans against the JAX package's.

The split of a bank into chunks decides ties at equal quantized depth
(the z-key carries a row's index within its chunk, and the carry across
chunks keeps the earlier chunk's winner), so the port reproduces the
JAX package's plan: for every ported id at three (B, W, H), the port's
plan equals JAX's.
The multi-chunk scan's plain version is held against JAX's ``_tri_pass``
on a bank whose prims are copied across chunk boundaries (ties on many
pixels), and the multi-chunk kernel's windowed scan, copied in torch
(tests/_kernel_models.py), against the chunk loop on that bank and on
Sidewalk's views, with windows small enough that tied rows and most
views span several; the Sidewalk views also check the kernel's group-of-
tiles cull and the epilogue's texel skip (the samples whose texel the
result never reads, sky among them); the Maze layout bank's packed-PVS plan renders its packed
chunks as JAX's scan does, in one chunk a render or, as the scheduled
plans (packed PVS over 2 chunks, chunk_vis) do, chunk by chunk.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu import vector as jvector
from miniworld_tpu.envs import make_spec as jax_make_spec
from miniworld_tpu.ops import geom as jgeom
from miniworld_tpu.render import raycast as jrc
from miniworld_tpu_torch import MiniWorldVec, vector as tvector
from miniworld_tpu_torch.convert import layout_from_numpy
from miniworld_tpu_torch.envs import ENV_IDS, make_spec
from miniworld_tpu_torch.render import raycast as trc

from _kernel_models import (epilogue_inputs, first_chunk_rank, group_cull_misses,
                            texel_read_mask, window_select)
from _torch_parity import to_port_state
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

# (B, W, H, supersample): at ss=2 the plan sees W x H x 4 samples a frame
SIZES = [(8, 80, 60, 1), (1024, 80, 60, 1), (1024, 160, 120, 1), (8, 80, 60, 2),
         (1024, 80, 60, 2)]
BANK_MODE = ["MiniWorld-MazeS2-v0", "MiniWorld-MazeS3-v0", "MiniWorld-MazeS3Fast-v0"]
CASES = [(env_id, None) for env_id in ENV_IDS] + [(env_id, False) for env_id in BANK_MODE]
_BANKS = {}


def _port_bank(env_id, procgen):
    """The port's host-built bank and atlas of an id, built once."""
    if (env_id, procgen) not in _BANKS:
        spec = make_spec(env_id)
        use_pg = spec.procgen_default if procgen is None else procgen
        build = tvector.build_super_bank if use_pg else tvector.build_bank
        _BANKS[env_id, procgen] = build(spec)
    return _BANKS[env_id, procgen]


@pytest.mark.parametrize("size", SIZES,
                         ids=lambda s: "B%d-%dx%d" % s[:3] + ("-ss%d" % s[3] if s[3] > 1 else ""))
@pytest.mark.parametrize("env_id,procgen", CASES,
                         ids=lambda v: {None: "", False: "bank"}.get(v, v))
def test_plan_matches_jax(env_id, procgen, size):
    """tri_chunk, the padded S, the plan's kind and schedule length and
    the chunk cap equal the JAX package's (at supersample=2 for the
    samples of a frame, as MiniWorldVec passes them); the chunks start
    where JAX's dynamic_slice reads them, the last clamped (a paired
    procgen bank in more than one chunk)."""
    b, w, h, ss = size
    jenv = JaxVec(env_id, num_envs=b, obs_width=w, obs_height=h, procgen=procgen,
                  supersample=ss)
    bank_np, tex_np = _port_bank(env_id, procgen)
    pg = jenv._bank_np.pg_verts9
    hw = w * h * ss * ss
    got, statics = tvector.install_statics(bank_np, tex_np, b, hw)
    n_scan = (jenv._bank_np.tri_mask if pg is None else pg[0, 0]).shape[-1]
    tc = min(jenv.tri_chunk, n_scan)
    if not jenv._pvs_packed:
        want = [int(jax.lax.dynamic_slice(jnp.arange(n_scan), (c * tc,), (tc,))[0])
                for c in range(-(-n_scan // tc))]
        assert statics["plan"]["chunk_starts"] == want
    plan = statics["plan"]
    assert plan["cap"] == jenv._chunk_cap
    assert statics["tri_chunk"] == plan["tri_chunk"] == jenv.tri_chunk
    assert got.tri_mask.shape == jenv._bank_np.tri_mask.shape
    assert (plan["kind"] == "chunk_vis") == (jenv._chunk_vis is not None)
    assert (plan["kind"] == "packed_pvs") == jenv._pvs_packed
    assert plan["sched_len"] == jenv._sched_len
    if env_id == "MiniWorld-Sidewalk-v0":  # the widest dense bank: 3 or 6 chunks
        assert (got.tri_mask.shape[1], plan["tri_chunk"]) == (
            (2976, 496) if plan["cap"] == 496 else (3072, 1024))


def test_port_plans_its_maze_at_160x120_raises():
    """Procgen Maze 8x8 (Sp = 608 paired rows) at 160x120 with B = 1024,
    chunk cap 496, which the port refused before it scanned a paired
    bank in more than one chunk: it plans JAX's 2 chunks of 496, the
    second from row 112, and raises for none of the ported ids'
    defaults."""
    assert tvector.chunk_cap(1024, 160 * 120) == 496
    _, statics = tvector.install_statics(*_port_bank("MiniWorld-Maze-v0", None), 1024,
                                         160 * 120)
    assert (statics["tri_chunk"], statics["plan"]["chunk_starts"]) == (496, [0, 112])


@pytest.fixture(scope="module")
def maze2_bank():
    """The 8x8 Maze's layout bank from its first 2 layouts (JAX's build)."""
    return jvector.build_bank(jax_make_spec("MiniWorld-Maze-v0", num_layouts=2))[0]


@pytest.mark.parametrize("kind", ["packed_pvs", "chunk_vis"])
def test_scheduled_plans_render(maze2_bank, maze_bank, kind, monkeypatch):
    """Packed PVS over more than one chunk a render, and a chunk_vis
    schedule, install and render: the 8x8 Maze's layout bank at a chunk
    cap of 96 plans packed PVS of 2 chunks of 96 a render, in the port as
    in the JAX package; without the packed planner it plans chunk_vis
    culling. tri_pass_scheduled on the port's schedule equals JAX's
    ``_tri_pass`` on JAX's (``room_base + arange`` with the one-hot chunk
    read; ``chunk_schedule`` with ``chunk_sched``), t and attributes, on
    16 views spread over the maze's cells; the envs whose packed slot runs
    past their layout (``base + j >= NC``, where JAX's one-hot read leaves
    the layout) are held against JAX's clamped read. render_rgbd renders
    the plan through its wrappers as through the plain versions."""
    hw = int(4e10 / 4 / 1024 / 96)
    assert tvector.chunk_cap(1024, hw) == 96
    if kind == "packed_pvs":
        j_packed = jvector.plan_packed_pvs(maze2_bank, 96)
        assert j_packed[1:3] == (96, 2)
    else:
        monkeypatch.setattr(tvector, "plan_packed_pvs",
                            lambda bank, cap, over: (None, cap, None, np.inf))
    tex = np.ones((2, 4 + 8 * 16), np.float32)
    bank_np, statics = tvector.install_statics(maze2_bank, tex, 1024, hw)
    plan = statics["plan"]
    assert plan["kind"] == kind and plan["sched_len"] > 1
    k, n, nc = plan["tri_chunk"], plan["sched_len"], plan["nc"]
    if kind == "packed_pvs":
        assert (k, n) == j_packed[1:3]
    else:
        vis = jvector._chunk_visibility(jvector._repad_for_chunks(maze2_bank, k), k)
        np.testing.assert_array_equal(plan["chunk_vis"], vis)
        plan = dict(plan, chunk_vis=torch.from_numpy(plan["chunk_vis"]))
    jenv, _ = maze_bank
    b = 16
    jstate, _ = jenv.reset(jax.random.key(8))
    rng = np.random.default_rng(16)
    cells = rng.permutation(64)[:b]
    pos = np.stack([(cells % 8) * 3.25 + rng.uniform(0.5, 2.5, b), np.zeros(b),
                    (cells // 8) * 3.25 + rng.uniform(0.5, 2.5, b)], 1)
    jstate = jstate.replace(pos=jnp.asarray(pos, jnp.float32),
                            dir=jnp.asarray(rng.uniform(-np.pi, np.pi, b), jnp.float32),
                            layout_id=jnp.asarray(rng.integers(0, 2, b), jnp.int32))
    jbank = SimpleNamespace(**{f: jnp.asarray(getattr(bank_np, f)) for f in (
        "room_outline", "room_norms", "room_vmask", "room_mask", "pvs_room_base")
        if getattr(bank_np, f) is not None})
    quads = statics["all_quads"]
    if kind == "packed_pvs":
        v9, at = jnp.asarray(bank_np.pvs_verts9), jnp.asarray(bank_np.pvs_attr)
        rows = (jnp.asarray(bank_np.pvs_v9_rows), jnp.asarray(bank_np.pvs_attr_rows), nc)

        def sched_of(s, o):
            room = jrc.room_of_point(jbank, s.layout_id, o[jnp.array([0, 2])])
            return jbank.pvs_room_base[s.layout_id, room] + jnp.arange(n, dtype=jnp.int32)
    else:
        v9, at = jnp.asarray(bank_np.tri_verts9), jnp.asarray(bank_np.tri_attr)
        rows = None

        def sched_of(s, o):
            return jrc.chunk_schedule(jbank, jnp.asarray(vis), s.layout_id, o, n)

    def scan(read):
        def one(s, o, r):
            return jrc._tri_pass(v9, at, s.layout_id, o, r, k, chunk_sched=sched_of(s, o),
                                 chunk_rows=read, all_quads=quads)

        origin, rays = _jax_cameras(jstate, TIE_W, TIE_H)
        return jax.jit(jax.vmap(one))(jstate, origin, rays)

    cam, _ = _port_camera(jstate, TIE_W, TIE_H)
    state = to_port_state(jstate)
    tbank = layout_from_numpy(bank_np)
    trows, paired = trc.static_rows(tbank, state, cam, plan=plan)
    assert paired is None and trows[2].shape == (b, n) and trows[0].shape[1:] == (9, k)
    t_t, a_t = trc.tri_pass_scheduled(*trows, cam, quads)
    every = torch.ones(b, dtype=torch.bool)
    checks = [(None, every)]  # JAX's dynamic_slice read, clamped
    if kind == "packed_pvs":
        room = trc.room_of_point(tbank, state.layout_id, cam.origin[:, [0, 2]])
        inside = tbank.pvs_room_base[state.layout_id.long(), room] + n <= nc
        assert int(inside.sum()) >= b // 2
        checks.append((rows, inside))  # its one-hot read, inside the layouts
    for read, envs in checks:
        t_j, a_j = scan(read)
        np.testing.assert_array_equal(t_t[envs].numpy(), np.asarray(t_j)[envs.numpy()])
        np.testing.assert_array_equal(a_t[envs].float().numpy(),
                                      np.asarray(a_j.astype(jnp.float32))[envs.numpy()])
    assert np.isfinite(t_t.numpy()).mean() > 0.3
    env_args = dict(width=TIE_W, height=TIE_H, k_terms=16,
                    shapes_present=statics["shapes_present"], all_quads=quads, plan=plan)
    atlas = torch.from_numpy(tex)
    rgb_k, depth_k = trc.render_rgbd(tbank, state, atlas, **env_args)
    rgb_p, depth_p = trc.render_rgbd(tbank, state, atlas, use_kernels=False, **env_args)
    assert torch.equal(rgb_k, rgb_p) and torch.equal(depth_k, depth_p)
    assert float((depth_k < trc.FAR).float().mean()) > 0.3


# ---------------------------------------------------------------------------
# the multi-chunk scan


def _jax_cameras(jstate, w, h):
    def one(state):
        origin = jgeom.cam_position(state.pos, state.dir, state.cam_height, state.cam_fwd_disp)
        return origin, jrc.camera_grid(state, w, h)

    return jax.jit(jax.vmap(one))(jstate)


def _port_camera(jstate, w, h):
    """The port's Camera of a JAX state, its rays equal to JAX's."""
    origin, (fwd, right, up, xv, yv) = _jax_cameras(jstate, w, h)
    cam = trc.camera_grid(to_port_state(jstate), w, h)
    np.testing.assert_array_equal(cam.origin.numpy(), np.asarray(origin))
    np.testing.assert_array_equal(cam.xv().numpy(), np.asarray(xv))
    np.testing.assert_array_equal(cam.yv().numpy(), np.asarray(yv))
    return cam, (origin, (fwd, right, up, xv, yv))


TIE_W, TIE_H, TIE_B = 40, 30, 8


@pytest.fixture(scope="module")
def tie_case():
    """Hallway cameras spread over the hallway facing +x, and a bank of
    4 x 16 prims in front of them: chunk-sized groups of 16 random
    quads and triangles, the second group a copy of the first (the same
    chunk-local indices at tri_chunk 16), the third the first rolled by
    5 rows (other local indices), the fourth new prims, and rows 1 and
    2 equal (a tie inside a chunk). Every copy carries its own colours,
    so the attributes tell the copies apart."""
    jenv = JaxVec("MiniWorld-Hallway-v0", num_envs=TIE_B, obs_width=TIE_W, obs_height=TIE_H)
    jstate, _ = jenv.reset(jax.random.key(5))
    rng = np.random.default_rng(5)
    pos = np.stack([rng.uniform(-0.5, 3.0, TIE_B), np.zeros(TIE_B),
                    rng.uniform(-1.0, 1.0, TIE_B)], 1)
    jstate = jstate.replace(pos=jnp.asarray(pos, jnp.float32),
                            dir=jnp.asarray(rng.uniform(-0.4, 0.4, TIE_B), jnp.float32))
    g = 16
    v0 = np.stack([rng.uniform(4, 10, g), rng.uniform(0.0, 2.5, g), rng.uniform(-2, 2, g)])
    e1 = rng.uniform(-2, 2, (3, g))
    e2 = rng.uniform(-2, 2, (3, g))
    base = np.concatenate([v0, v0 + e1, v0 + e2])  # (9, g)
    base[:, 2] = base[:, 1]
    new = base[:, rng.permutation(g)] + rng.uniform(-0.5, 0.5, (9, 1))
    verts9 = np.concatenate([base, base, np.roll(base, 5, axis=1), new], 1)[None]
    S = verts9.shape[2]
    attr = rng.uniform(-1, 1, (1, S, 16)).astype(np.float32)
    attr[0, :, 15] = np.tile((np.arange(g) % 2).astype(np.float32), 4)
    attr[0, 32:48, 15] = np.roll(attr[0, :16, 15], 5)
    return jstate, verts9.astype(np.float32), attr


@pytest.mark.parametrize("tri_chunk", [16, 4])
def test_tri_pass_chunked_matches_jax_on_ties(tie_case, tri_chunk):
    """tri_pass_chunked equals JAX's ``_tri_pass`` with the same chunk on
    every pixel, t and attributes, on the tie bank; the ties decide
    hundreds of pixels (there the global row index would pick another
    copy than the chunk rule)."""
    jstate, verts9, attr = tie_case

    def one(s, o, r):
        return jrc._tri_pass(jnp.asarray(verts9), jnp.asarray(attr), jnp.int32(0), o, r,
                             tri_chunk)

    origin, rays = _jax_cameras(jstate, TIE_W, TIE_H)
    t_j, a_j = jax.jit(jax.vmap(one))(jstate, origin, rays)
    cam, _ = _port_camera(jstate, TIE_W, TIE_H)
    lid = torch.zeros(TIE_B, dtype=torch.int32)
    v9, at = torch.from_numpy(verts9), torch.from_numpy(attr)
    t_t, a_t = trc.tri_pass_chunked(v9, at, lid, cam, tri_chunk)
    assert a_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(a_t.float().numpy(), np.asarray(a_j.astype(jnp.float32)))
    assert np.isfinite(np.asarray(t_j)).mean() > 0.2
    # the global-index rule of one 64-row chunk picks other copies
    _, a_global = trc.tri_pass_plain(v9, at, lid, cam)
    decided = int((a_global != a_t).any(-1).sum())
    assert decided >= 100, decided


@pytest.mark.parametrize("tri_chunk", [16, 4])
def test_kernel_select_matches_chunk_loop(tie_case, tri_chunk):
    """The multi-chunk kernel's windowed scan (a window of 8 rows, batches
    of 4: the copies at rows 0-15 and 16-31, tied at equal chunk-local
    indices, fall in different windows) gives the chunk loop's winners."""
    jstate, verts9, attr = tie_case
    cam, _ = _port_camera(jstate, TIE_W, TIE_H)
    lid = torch.zeros(TIE_B, dtype=torch.int32)
    v9, at = torch.from_numpy(verts9), torch.from_numpy(attr)
    t_k, a_k = window_select(v9, at, lid, cam, tri_chunk, window=8, block=4)
    t_p, a_p = trc.tri_pass_chunked(v9, at, lid, cam, tri_chunk)
    assert torch.equal(t_k, t_p) and torch.equal(a_k, a_p)


@pytest.mark.parametrize("n_rows", [608, 3072, 4096])
def test_kernel_chunk_index_formula(n_rows):
    """The multi-chunk kernel's row rank, s << 10 | local: for every chunk
    16 <= tri_chunk <= 1024 below n_rows each row's local index is its
    index in the first of JAX's clamped chunks that reads it
    (``trc.chunk_starts``), under 1024, and the packing round-trips
    within 31 bits (S <= 4096), so that ascending rows are ascending
    first chunks."""
    s = torch.arange(n_rows)
    for tc in range(16, min(n_rows, 1024) + 1):
        chunk, local = first_chunk_rank(n_rows, tc)
        starts = torch.tensor(trc.chunk_starts(n_rows, tc))
        assert int(local.min()) >= 0 and int(local.max()) < tc
        assert torch.equal(starts[chunk] + local, s), tc
        first = ((s[:, None] >= starts[None]) & (s[:, None] < starts[None] + tc)).long().argmax(1)
        assert torch.equal(chunk, first), tc
        assert bool((chunk[1:] >= chunk[:-1]).all())
        pad = (s << 10) | local
        assert int(pad.max()) < 2 ** 31
        assert torch.equal(pad >> 10, s) and torch.equal(pad & 1023, local)


@pytest.fixture(scope="module")
def sidewalk():
    """Sidewalk at B=4, 40x30 (3 chunks of 1024) and its reset state."""
    env = MiniWorldVec("MiniWorld-Sidewalk-v0", 4, obs_width=40, obs_height=30, device="cpu")
    state, obs = env.reset(2)
    return env, state, obs


def test_render_plain_multi_chunk(sidewalk):
    """Sidewalk at B=4, 40x30, plans 3 chunks of 1024; its render with
    use_kernels=False scans them with tri_pass_chunked, as the wrapper
    does for CPU tensors."""
    env, state, (rgb, depth) = sidewalk
    assert env.plan["kind"] == "dense" and env.tri_chunk == 1024
    assert env._bank.tri_verts9.shape[2] == 3072
    env.use_kernels = False
    try:
        rgb_p, depth_p = env.render(state)
    finally:
        env.use_kernels = True
    assert torch.equal(rgb, rgb_p) and torch.equal(depth, depth_p)


def _sidewalk_view(sidewalk):
    env, state, _ = sidewalk
    u = torch.rand((4, 2), generator=torch.Generator().manual_seed(6))
    state = state.replace(dir=(u[:, 0] * 2.0 - 1.0) * math.pi, cam_pitch=(u[:, 1] - 0.5) * 20.0)
    cam = trc.camera_grid(state, 40, 30)
    bank = env._bank
    return env, state, (bank.tri_verts9, bank.tri_attr, state.layout_id, cam, env._all_quads)


def test_window_model_sidewalk(sidewalk):
    """The multi-chunk kernel's scan, copied in torch, on Sidewalk views
    at 3 chunks of 1024 with a window of 256 rows (batches of 96): each
    view's image survivors fill several windows, and t and all 16
    attributes equal tri_pass_chunked's on every pixel."""
    env, _, (v9, at, lid, cam, quads) = _sidewalk_view(sidewalk)
    rows = trc.stage_rows(v9, at, lid, cam)
    survivors = trc.tile_cull_plain(rows, cam, 40, 30, quads)[:, 0].sum(1)
    assert int(survivors.min()) > 256, survivors
    t_k, a_k = window_select(v9, at, lid, cam, env.tri_chunk, quads, window=256, block=96)
    t_p, a_p = trc.tri_pass_chunked(v9, at, lid, cam, env.tri_chunk, quads)
    assert torch.equal(t_k, t_p) and torch.equal(a_k, a_p)
    assert float(torch.isfinite(t_p).float().mean()) > 0.3


@pytest.mark.parametrize("group", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
def test_group_box_keeps_hits_sidewalk(sidewalk, group):
    """A group of 16x12 tiles' box keeps every Sidewalk row that hits a
    pixel of the group (row_hits_plain), and drops most of them."""
    env, _, (v9, at, lid, cam, quads) = _sidewalk_view(sidewalk)
    rows = trc.stage_rows(v9, at, lid, cam)
    missed, keep = group_cull_misses(rows, cam, quads, (16, 12), group)
    assert missed == 0
    assert float(keep.float().mean()) < 0.5


def test_texel_skip_sidewalk(sidewalk):
    """Sidewalk has no ceiling: a share of its samples is sky. The
    epilogue reads a sample's attributes and texel only where
    texel_read_mask holds; with every other sample's attributes replaced
    by noise the plain epilogue's output is unchanged."""
    env, state, _ = _sidewalk_view(sidewalk)
    args = epilogue_inputs(env, state, 40, 30)
    t_tri, attr, t_ent = args[0], args[1], args[2]
    mask = texel_read_mask(t_tri, t_ent)
    assert 0.05 < float(mask.float().mean()) < 0.95
    noise = (torch.rand(attr.shape, generator=torch.Generator().manual_seed(3)) * 40 - 20)
    attr_n = torch.where(mask[..., None], attr, noise.to(attr.dtype))
    rgb, depth = trc.pixel_epilogue_plain(*args)
    rgb_n, depth_n = trc.pixel_epilogue_plain(t_tri, attr_n, *args[2:])
    assert torch.equal(rgb, rgb_n) and torch.equal(depth, depth_n)


# ---------------------------------------------------------------------------
# the packed-PVS plan (the 8x8 Maze's layout bank)


@pytest.fixture(scope="module")
def maze_bank():
    """The 8x8 Maze's layout bank from its first 4 layouts, in the JAX
    package and the port, at B=16 (packed PVS: chunks of 176, one a
    render, as the full 64-layout bank plans)."""
    b = 16
    jenv = JaxVec(jax_make_spec("MiniWorld-Maze-v0", num_layouts=4), num_envs=b,
                  obs_width=TIE_W, obs_height=TIE_H, procgen=False)
    tenv = MiniWorldVec(make_spec("MiniWorld-Maze-v0", num_layouts=4), b, obs_width=TIE_W,
                        obs_height=TIE_H, procgen=False, device="cpu")
    assert jenv._pvs_packed and (jenv.tri_chunk, jenv._sched_len) == (176, 1)
    assert tenv.plan["kind"] == "packed_pvs" and tenv.tri_chunk == 176
    return jenv, tenv


def test_packed_bank_matches_jax(maze_bank):
    """The installed packed bank (copies, room bases, chunk rows, baked
    slot columns) equals the JAX package's, array for array."""
    jenv, tenv = maze_bank
    for name in ("pvs_verts9", "pvs_attr", "pvs_tri_tex_base", "pvs_room_base",
                 "pvs_room_nchunks", "pvs_v9_rows", "pvs_attr_rows", "tri_attr"):
        np.testing.assert_array_equal(getattr(tenv._bank_np, name),
                                      getattr(jenv._bank_np, name), err_msg=name)


def test_packed_scan_matches_jax(maze_bank):
    """Each env scans its camera room's packed chunk: tri_pass on the
    port's static_rows equals JAX's packed ``_tri_pass`` (the schedule
    room_base + arange(1), the one-hot chunk read) on every pixel, t and
    attributes, with the agents spread over every cell of the maze."""
    jenv, tenv = maze_bank
    b = tenv.num_envs
    jstate, _ = jenv.reset(jax.random.key(8))
    rng = np.random.default_rng(8)
    cells = rng.permutation(64)[:b]
    pos = np.stack([(cells % 8) * 3.25 + rng.uniform(0.5, 2.5, b), np.zeros(b),
                    (cells // 8) * 3.25 + rng.uniform(0.5, 2.5, b)], 1)
    jstate = jstate.replace(pos=jnp.asarray(pos, jnp.float32),
                            dir=jnp.asarray(rng.uniform(-np.pi, np.pi, b), jnp.float32))
    jbank = jenv._bank
    ncl = jbank.pvs_v9_rows.shape[0] // jbank.pvs_verts9.shape[0]

    def one(s, o, r):
        room = jrc.room_of_point(jbank, s.layout_id, o[jnp.array([0, 2])])
        sched = jbank.pvs_room_base[s.layout_id, room] + jnp.arange(1, dtype=jnp.int32)
        return jrc._tri_pass(jbank.pvs_verts9, jbank.pvs_attr, s.layout_id, o, r, 176,
                             chunk_sched=sched,
                             chunk_rows=(jbank.pvs_v9_rows, jbank.pvs_attr_rows, ncl),
                             all_quads=jenv._all_quads)

    origin, rays = _jax_cameras(jstate, TIE_W, TIE_H)
    t_j, a_j = jax.jit(jax.vmap(one))(jstate, origin, rays)
    cam, _ = _port_camera(jstate, TIE_W, TIE_H)
    bank = layout_from_numpy(tenv._bank_np)
    rows, paired = trc.static_rows(bank, to_port_state(jstate), cam, plan=tenv.plan)
    assert paired is None and rows[0].shape == (4 * ncl, 9, 176)
    t_t, a_t = trc.tri_pass(*rows, cam, tenv._all_quads, tri_chunk=176)
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(a_t.float().numpy(), np.asarray(a_j.astype(jnp.float32)))
    assert np.isfinite(np.asarray(t_j)).mean() > 0.5

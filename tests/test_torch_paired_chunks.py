"""The paired procgen tri_pass over more than one chunk, against the JAX
package on the CPU.

The 8x8 Maze's paired super bank has Sp = 608 rows. At B >= 1024 with
19,200 samples a frame (80x60 at supersample=2) the JAX package scans
it in chunks of 496, and ``dynamic_slice`` clamps the last chunk's
start: chunk 1 reads rows 112-607 at local indices 0-495, so rows
112-495 compete in both chunks at other local indices, and which row
wins a tie at equal quantized depth depends on that. The port's plain
scan (``tri_pass_chunked`` with ``paired``) is held against JAX's
``_tri_pass`` on the Maze's views, with and without the texture-variant
override, and on a synthetic paired bank whose prims repeat across rows
0-111, 112-495 and 496-607: t and all 16 attributes equal on every
pixel. The multi-chunk kernel's windowed scan (each row keyed in its
first chunk only, rows in row order, a strict > carried across windows;
tests/_kernel_models.py) is held against the chunk loop on the tie bank
and on the Maze's views; the plan of ``install_statics`` is JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu.render import raycast as jrc
from miniworld_tpu_torch import MiniWorldVec, vector as tvector
from miniworld_tpu_torch.convert import layout_from_numpy
from miniworld_tpu_torch.envs import make_spec
from miniworld_tpu_torch.ops import mazegen
from miniworld_tpu_torch.render import raycast as trc

from _kernel_models import window_select
from _torch_parity import to_port_state
from test_torch_chunks import _jax_cameras, _port_camera
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

MAZE_ID = "MiniWorld-Maze-v0"
B, W, H = 4, 40, 30
TC, SP = 496, 608


def _assert_equal(t_j, a_j, t_t, a_t):
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(a_t.float().numpy(), np.asarray(a_j.astype(jnp.float32)))


@pytest.fixture(scope="module")
def maze8():
    """The 8x8 Maze with domain randomisation at B=4: agents spread over
    the maze facing all ways, each env with its own maze; the JAX env and
    state, and the port's bank and statics."""
    jenv = JaxVec(MAZE_ID, num_envs=B, obs_width=W, obs_height=H, domain_rand=True)
    jstate, _ = jenv.reset(jax.random.key(8))
    rng = np.random.default_rng(4)
    pos = np.stack([rng.uniform(0.3, 26.5, B), np.zeros(B), rng.uniform(0.3, 26.5, B)], 1)
    walls = np.stack([mazegen.host_gen_walls(np.random.default_rng(20 + i), 8, 8)
                      for i in range(B)]).astype(np.float32)
    jstate = jstate.replace(pos=jnp.asarray(pos, jnp.float32),
                            dir=jnp.asarray(rng.uniform(-np.pi, np.pi, B), jnp.float32),
                            wall_open=jnp.asarray(walls))
    bank_np, statics = tvector.install_statics(
        *tvector.build_super_bank(make_spec(MAZE_ID)), B, W * H, domain_rand=True)
    return jenv, jstate, layout_from_numpy(bank_np), statics


@pytest.mark.parametrize("override", [False, True], ids=["plain", "override"])
def test_maze_paired_two_chunks_match_jax(maze8, override):
    """JAX's ``_tri_pass`` on the paired bank at tri_chunk 496 and the
    port's tri_pass_chunked: t and attributes equal on every pixel, with
    and without each env's texture variants; the wrapper takes the same
    plain scan for CPU tensors."""
    jenv, jstate, tb, statics = maze8
    jb = jenv._bank
    assert jb.pg_verts9.shape[2] == SP
    origin, rays = _jax_cameras(jstate, W, H)

    def one(s, o, r):
        use_p = jb.pg_sel_base[0] + s.wall_open @ jb.pg_sel_onehot[0]
        return jrc._tri_pass(jb.pg_verts9, jb.pg_attr, s.layout_id, o, r, TC,
                             slot_key=s.tri_slots if override else None, dr_active=override,
                             all_quads=True,
                             paired=(use_p, jb.pg_verts9_alt, jb.pg_attr_alt, jb.pg_tex))

    t_j, a_j = jax.jit(jax.vmap(one))(jstate, origin, rays)
    cam, _ = _port_camera(jstate, W, H)
    ts = to_port_state(jstate)
    paired = (tb.pg_verts9_alt, tb.pg_attr_alt, torch.from_numpy(statics["pg_wall"]),
              ts.wall_open)
    ov = None
    if override:
        ov = (ts.tri_slots, *(torch.from_numpy(t) for t in statics["slot_tex"]))
    t_t, a_t = trc.tri_pass_chunked(tb.pg_verts9, tb.pg_attr, ts.layout_id, cam, TC, True,
                                    ov, paired)
    _assert_equal(t_j, a_j, t_t, a_t)
    assert np.isfinite(np.asarray(t_j)).mean() > 0.9
    t_w, a_w = trc.tri_pass(tb.pg_verts9, tb.pg_attr, ts.layout_id, cam, True, None, paired,
                            TC, ov)
    assert torch.equal(t_w, t_t) and torch.equal(a_w, a_t)


@pytest.fixture(scope="module")
def paired_ties():
    """A paired bank of Sp = 608 rows in front of 8 cameras (Hallway's,
    facing +x): a group of 48 random quads and triangles at rows 40-87
    (read by chunk 0 only), again at 90-137 (across row 112) and at
    300-347 (read by both chunks), rolled by 7 rows at 540-587 (chunk 1
    only), and new prims at 400-447; the other rows never hit. Half of
    the rows carry one of 6 walls whose alternative variant is the same
    prim with other attributes, closed in some envs. Every copy has its
    own attributes. Returns (JAX state, verts9, attr, verts9_alt,
    attr_alt, pg_wall, wall_open) as numpy."""
    jenv = JaxVec("MiniWorld-Hallway-v0", num_envs=8, obs_width=W, obs_height=H)
    jstate, _ = jenv.reset(jax.random.key(5))
    rng = np.random.default_rng(12)
    pos = np.stack([rng.uniform(-0.5, 3.0, 8), np.zeros(8), rng.uniform(-1.0, 1.0, 8)], 1)
    jstate = jstate.replace(pos=jnp.asarray(pos, jnp.float32),
                            dir=jnp.asarray(rng.uniform(-0.4, 0.4, 8), jnp.float32))
    g = 48
    v0 = np.stack([rng.uniform(4, 10, g), rng.uniform(0.0, 2.5, g), rng.uniform(-2, 2, g)])
    base = np.concatenate([v0, v0 + rng.uniform(-2, 2, (3, g)), v0 + rng.uniform(-2, 2, (3, g))])
    base[:, 2] = base[:, 1]  # rows 1 and 2 of the group equal: a tie inside a chunk
    kinds = (rng.uniform(size=g) < 0.5).astype(np.float32)
    verts9 = np.zeros((1, 9, SP), np.float32)
    kind = np.zeros(SP, np.float32)
    for start, roll in ((40, 0), (90, 0), (300, 0), (540, 7)):
        verts9[0, :, start:start + g] = np.roll(base, roll, axis=1)
        kind[start:start + g] = np.roll(kinds, roll)
    verts9[0, :, 400:400 + g] = base[:, rng.permutation(g)] + rng.uniform(-0.5, 0.5, (9, 1))
    kind[400:400 + g] = kinds
    attr = rng.uniform(-1, 1, (1, SP, 16)).astype(np.float32)
    attr[0, :, 15] = kind
    attr_alt = rng.uniform(-1, 1, (1, SP, 16)).astype(np.float32)
    attr_alt[0, :, 15] = kind
    pg_wall = np.where(rng.uniform(size=(1, SP)) < 0.5, rng.integers(0, 6, (1, SP)),
                       -1).astype(np.int32)
    wall_open = (rng.uniform(size=(8, 6)) < 0.5).astype(np.float32)
    return jstate, verts9, attr, verts9.copy(), attr_alt, pg_wall, wall_open


def _port_ties(paired_ties):
    jstate, verts9, attr, v9_alt, attr_alt, pg_wall, wall_open = paired_ties
    cam, _ = _port_camera(jstate, W, H)
    paired = tuple(torch.from_numpy(a) for a in (v9_alt, attr_alt, pg_wall, wall_open))
    lid = torch.zeros(8, dtype=torch.int32)
    return torch.from_numpy(verts9), torch.from_numpy(attr), lid, cam, paired


def test_paired_ties_match_jax(paired_ties):
    """On the tie bank the two-chunk scan equals JAX's on every pixel, and
    the chunk rule decides hundreds of pixels (there a single chunk of
    all 608 rows picks another copy)."""
    jstate, verts9, attr, v9_alt, attr_alt, pg_wall, wall_open = paired_ties
    origin, rays = _jax_cameras(jstate, W, H)
    codes = jnp.asarray(pg_wall[0])

    def one(o, r, wo):
        use_p = ((codes < 0) | (wo[jnp.maximum(codes, 0)] > 0.5)).astype(jnp.float32)
        return jrc._tri_pass(jnp.asarray(verts9), jnp.asarray(attr), jnp.int32(0), o, r, TC,
                             paired=(use_p, jnp.asarray(v9_alt), jnp.asarray(attr_alt), None))

    t_j, a_j = jax.jit(jax.vmap(one))(origin, rays, jnp.asarray(wall_open))
    v9, at, lid, cam, paired = _port_ties(paired_ties)
    t_t, a_t = trc.tri_pass_chunked(v9, at, lid, cam, TC, False, None, paired)
    _assert_equal(t_j, a_j, t_t, a_t)
    assert np.isfinite(np.asarray(t_j)).mean() > 0.2
    _, a_one = trc.tri_pass_plain(v9, at, lid, cam, paired=paired)
    decided = int((a_one != a_t).any(-1).sum())
    assert decided >= 100, decided


@pytest.mark.parametrize("tri_chunk", [TC, 160])
def test_first_chunk_select_matches_chunk_loop(paired_ties, tri_chunk):
    """A row read by two chunks has the same depth bits in both and a
    smaller local index in the clamped last chunk, so keying each row in
    its first chunk only, scanning the rows in order with a strict > (the
    multi-chunk kernel, windows of 32 rows in batches of 16, so the copies
    of a group lie in other windows) gives the chunk loop's winners: at
    496 (2 chunks, 384 rows read twice) and 160 (4 chunks, the last from
    row 448)."""
    v9, at, lid, cam, paired = _port_ties(paired_ties)
    t_k, a_k = window_select(v9, at, lid, cam, tri_chunk, paired=paired, window=32, block=16)
    t_p, a_p = trc.tri_pass_chunked(v9, at, lid, cam, tri_chunk, False, None, paired)
    assert torch.equal(t_k, t_p) and torch.equal(a_k, a_p)


def test_window_model_maze_paired(maze8):
    """The multi-chunk kernel's scan, copied in torch, on the 8x8 procgen
    Maze's paired bank in 2 chunks of 496 (its views, each env's maze),
    with windows of 64 rows: t and all 16 attributes equal
    tri_pass_chunked's on every pixel."""
    _, jstate, tb, statics = maze8
    cam, _ = _port_camera(jstate, W, H)
    ts = to_port_state(jstate)
    paired = (tb.pg_verts9_alt, tb.pg_attr_alt, torch.from_numpy(statics["pg_wall"]),
              ts.wall_open)
    t_k, a_k = window_select(tb.pg_verts9, tb.pg_attr, ts.layout_id, cam, TC, True, paired,
                             window=64, block=32)
    t_p, a_p = trc.tri_pass_chunked(tb.pg_verts9, tb.pg_attr, ts.layout_id, cam, TC, True,
                                    None, paired)
    assert torch.equal(t_k, t_p) and torch.equal(a_k, a_p)


def test_maze_ss2_plan_matches_jax():
    """At B=1024, 80x60, supersample=2 the JAX package scans the 8x8
    Maze's 608 paired rows in 2 chunks of 496, the second reading rows
    112-607 (its dynamic_slice clamped); the port plans the same, and
    MiniWorldVec builds it at the main path's B=8192."""
    jenv = JaxVec(MAZE_ID, num_envs=1024, obs_width=80, obs_height=60, supersample=2)
    assert jenv.tri_chunk == TC and jenv._bank_np.pg_verts9.shape[2] == SP
    _, statics = tvector.install_statics(*tvector.build_super_bank(make_spec(MAZE_ID)), 1024,
                                         80 * 60 * 4)
    assert statics["tri_chunk"] == TC and statics["plan"]["chunk_starts"] == [0, 112]
    rows = jnp.arange(SP)
    for c, start in enumerate(statics["plan"]["chunk_starts"]):
        read = np.asarray(jax.lax.dynamic_slice(rows, (c * TC,), (TC,)))
        np.testing.assert_array_equal(read, np.arange(start, start + TC))
    env = MiniWorldVec(MAZE_ID, 8192, device="cpu", supersample=2)
    assert (env.tri_chunk, env.plan["kind"], env.plan["chunk_starts"]) == (TC, "dense", [0, 112])

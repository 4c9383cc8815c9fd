"""The port's Maze family against the JAX package on the CPU: maze
generation, the procgen super bank and its statics, procgen placement,
the paired tri_pass, and reset plus steps of MazeS3 (procgen and bank
mode) and Maze 8x8 (reset and render).

Tolerances: walls, banks, ints, bools and ``wall_open`` exact; state
floats within FLOAT_ATOL (1e-5); renders under the _torch_parity rules
(winner differs on at most 0.1% of the pixels, depth within rtol 1e-5
and RGB within 2 u8 levels where it agrees).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu import vector as jvector
from miniworld_tpu.envs import make_spec as jax_make_spec
from miniworld_tpu.ops import mazegen as jmazegen, place as jplace, rng as jrng
from miniworld_tpu.render import raycast as jrc
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch import vector as tvector
from miniworld_tpu_torch.convert import layout_from_numpy
from miniworld_tpu_torch.envs import ENV_IDS, make_spec
from miniworld_tpu_torch.ops import mazegen, place as tplace, rng as trng
from miniworld_tpu_torch.render import raycast as trc
from miniworld_tpu_torch.scene.compile import Layout

from _torch_parity import (
    H, W, assert_images_match, assert_states_match, drop_paired, to_port_state,
)
from test_torch_render import _port_camera, _winner_stats
from test_torch_vector import adopt_reset_ulps
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

MAZE_IDS = ["MiniWorld-Maze-v0", "MiniWorld-MazeS3-v0", "MiniWorld-MazeS2-v0"]
B = 8


def _u32_seeds(n, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def _assert_layouts_equal(got, want):
    for f in dataclasses.fields(Layout):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        if b is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


# ---------------------------------------------------------------------------
# maze generation


@pytest.mark.parametrize("rows,cols", [(3, 3), (8, 8)])
def test_gen_walls(rows, cols):
    """64 subseeds: the same walls bit for bit, every maze a spanning tree."""
    np.testing.assert_array_equal(mazegen.wall_cells(rows, cols),
                                  jmazegen.wall_cells(rows, cols))
    for got, want in zip(mazegen.neighbor_tables(rows, cols),
                         jmazegen.neighbor_tables(rows, cols)):
        np.testing.assert_array_equal(got, want)
    seeds = _u32_seeds(64, rows)
    want = jax.jit(jax.vmap(lambda s: jmazegen.gen_walls(s, rows, cols)))(jnp.asarray(seeds))
    got = mazegen.gen_walls_plain(torch.from_numpy(seeds.astype(np.int64)), rows, cols)
    assert got.dtype == torch.float32
    assert got.shape == (64, mazegen.num_walls(rows, cols))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert all(mazegen.maze_is_spanning_tree(w > 0.5, rows, cols) for w in got.numpy())
    # distinct mazes among the 64 (a 3x3 grid has 192 spanning trees)
    assert len({tuple(w) for w in got.numpy()}) >= (60 if rows * cols > 9 else 10)
    rng = np.random.default_rng(0)
    assert mazegen.maze_is_spanning_tree(mazegen.host_gen_walls(rng, rows, cols), rows, cols)


# ---------------------------------------------------------------------------
# banks and statics


@pytest.mark.parametrize("env_id", MAZE_IDS)
def test_super_bank_exact(env_id):
    """build_super_bank: every array of the bank equal, the atlas within
    1e-6 (as tests/test_torch_bank.py holds the layout banks)."""
    want, want_tex, _ = jvector.build_super_bank(jax_make_spec(env_id))
    got, got_tex = tvector.build_super_bank(make_spec(env_id))
    _assert_layouts_equal(got, want)
    assert got.pg_verts9 is not None and got.tri_wall is not None
    np.testing.assert_allclose(got_tex, want_tex, rtol=0, atol=1e-6)


def test_bank_mode_maze8_exact():
    """The 8x8 maze's layout bank (procgen=False) from its first 4 layout
    seeds — the first 4 of the full bank's 64: every array equal."""
    want, want_tex, _ = jvector.build_bank(jax_make_spec("MiniWorld-Maze-v0", num_layouts=4))
    got, got_tex = tvector.build_bank(make_spec("MiniWorld-Maze-v0", num_layouts=4))
    _assert_layouts_equal(got, want)
    np.testing.assert_allclose(got_tex, want_tex, rtol=0, atol=1e-6)


def test_installed_super_bank():
    """install_statics on the MazeS3 super bank gives the JAX package's
    installed bank (both variants' slot columns baked) and statics, and
    its pg_wall lookup selects the variants that the JAX package's
    ``pg_sel_base + wall_open @ pg_sel_onehot`` selects."""
    jenv = JaxVec("MiniWorld-MazeS3-v0", num_envs=2, obs_width=16, obs_height=12)
    bank_np, tex_np = tvector.build_super_bank(make_spec("MiniWorld-MazeS3-v0"))
    got, statics = tvector.install_statics(bank_np, tex_np, 2, 16 * 12)
    _assert_layouts_equal(got, jenv._bank_np)
    assert statics["tri_chunk"] == jenv.tri_chunk
    assert statics["all_quads"] == jenv._all_quads is True
    assert statics["shapes_present"] == jenv._shapes_present
    assert jenv._chunk_vis is None and not jenv._pvs_packed
    pg_wall = statics["pg_wall"]
    n_walls = mazegen.num_walls(3, 3)
    walls = np.stack([mazegen.host_gen_walls(np.random.default_rng(i), 3, 3)
                      for i in range(16)]).astype(np.float32)
    use_p = got.pg_sel_base[0][None] + walls @ got.pg_sel_onehot[0]
    keep = (pg_wall[0][None] < 0) | (walls[:, np.clip(pg_wall[0], 0, n_walls - 1)] > 0.5)
    np.testing.assert_array_equal(keep, use_p > 0.5)
    assert (pg_wall >= 0).sum() == 4 * n_walls

    # the tri-axis padding leaves the paired rows as they are, like the JAX one
    j_rep = jvector._repad_for_chunks(bank_np, 48)
    _assert_layouts_equal(tvector._repad_for_chunks(bank_np, 48), j_rep)

    # without its paired rows the super bank installs as the JAX package's
    # does: its dense rows in the JAX plan, each env's killed by its maze
    dense_np, _ = drop_paired(bank_np, tex_np)
    got_d, statics_d = tvector.install_statics(dense_np, tex_np, 2, 16 * 12)
    jbank, jtex, _ = jvector.build_super_bank(jax_make_spec("MiniWorld-MazeS3-v0"))
    jenv.tri_chunk, jenv._chunk_vis, jenv._sched_len = jenv._chunk_cap, None, None
    jenv._install_bank(drop_paired(jbank, jtex)[0], jtex, fresh=True)
    _assert_layouts_equal(got_d, jenv._bank_np)
    assert statics_d["tri_chunk"] == jenv.tri_chunk and statics_d["plan"]["kind"] == "dense"
    assert jenv._chunk_vis is None and not jenv._pvs_packed and statics_d["pg_wall"] is None
    two = bank_np.pg_sel_onehot.copy()
    two[0, 0, int(np.argmax(pg_wall[0] == 1))] = 1.0  # a row of wall 1 also names wall 0
    with pytest.raises(ValueError, match="one-wall-per-row"):
        tvector.install_statics(dataclasses.replace(bank_np, pg_sel_onehot=two), tex_np, 2,
                                16 * 12)


def test_maze_specs():
    """The four ids are registered; procgen follows the spec when None."""
    for env_id in ("MiniWorld-Maze-v0", "MiniWorld-MazeS2-v0", "MiniWorld-MazeS3-v0",
                   "MiniWorld-MazeS3Fast-v0"):
        assert env_id in ENV_IDS
        spec, jspec = make_spec(env_id), jax_make_spec(env_id)
        assert spec.procgen_default is True and jspec.procgen_default is True
        assert spec.max_episode_steps == jspec.max_episode_steps
        assert (spec.num_rows, spec.num_cols) == (jspec.num_rows, jspec.num_cols)
        for name, p in jspec.params.params.items():
            q = spec.params.params[name]
            for k in ("default", "min", "max"):
                np.testing.assert_array_equal(getattr(q, k), getattr(p, k), err_msg=name)
    assert make_spec("MiniWorld-Maze-v0").max_episode_steps == 8 * 8 * 24
    env = MiniWorldVec("MiniWorld-Maze-v0", 2, obs_width=16, obs_height=12, device="cpu")
    assert env.procgen
    state, _ = env.reset(0)
    assert state.wall_open.shape == (2, mazegen.num_walls(8, 8))
    env = MiniWorldVec("MiniWorld-MazeS2-v0", 2, obs_width=16, obs_height=12, device="cpu",
                       procgen=False)
    assert not env.procgen and env.reset(0)[0].wall_open is None


# ---------------------------------------------------------------------------
# placement


def test_gate_segs4():
    rng = np.random.default_rng(1)
    n, ns, n_walls = 16, 40, 112
    segs4 = rng.uniform(-5, 30, (n, 4, ns)).astype(np.float32)
    codes = rng.integers(-1, n_walls, (n, ns)).astype(np.int32)
    wall_open = (rng.uniform(size=(n, n_walls)) > 0.5).astype(np.float32)
    want = jax.jit(jax.vmap(jplace.gate_segs4))(segs4, codes, wall_open)
    got = tplace.gate_segs4(torch.from_numpy(segs4), torch.from_numpy(codes),
                            torch.from_numpy(wall_open))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != segs4).any() and (got.numpy() == segs4).any()


@pytest.fixture(scope="module")
def maze8():
    jenv = JaxVec("MiniWorld-Maze-v0", num_envs=B, obs_width=16, obs_height=12)
    tenv = MiniWorldVec("MiniWorld-Maze-v0", B, obs_width=16, obs_height=12, device="cpu")
    return jenv, tenv


@pytest.mark.parametrize("budget,radius", [(16, 0.4), (2, 1.4)])
def test_place_procgen(maze8, budget, radius):
    """The box then the agent on the 8x8 super bank (176 rooms, 40
    room-local segments), with each env's maze as room weights and gated
    segments: place_all_plain against the JAX place_one chain. Budget 2
    at radius 1.4 sends some envs to the clamped fallback."""
    jenv, tenv = maze8
    n = 16
    seeds = _u32_seeds(n, budget)
    bank_np, jbank = jenv._bank_np, jenv._bank
    rules = {k: getattr(bank_np, k)[0, :2, 0] for k in tplace.RULE_FIELDS}  # box, agent
    radii = np.array([0.55, radius], np.float32)
    js = jnp.asarray(seeds)

    def one(seed):
        wall_open = jmazegen.gen_walls(jrng.sub(seed, 17), 8, 8)
        lay = jvector.lay_view(jbank, jnp.int32(0))
        rw = lay.room_wall
        w_oh = (rw[:, None] == jnp.arange(wall_open.shape[0])[None, :]).astype(jnp.float32)
        room_weight = jnp.where(rw < 0, 1.0, w_oh @ wall_open)
        gate = (jbank.room_seg_wall, wall_open)
        slot_seeds = jrng.hash_u32(jrng.sub(seed, 18), jnp.arange(2, dtype=jnp.uint32))

        def place(row, ent_xz, mask):
            return jplace.place_one(
                slot_seeds[row], lay, jbank.room_segs, jnp.int32(0),
                *[jnp.asarray(rules[k][row]) for k in tplace.RULE_FIELDS],
                jnp.float32(radii[row]), ent_xz, jnp.asarray(radii[:1]), mask,
                budget=budget, room_weight=room_weight, seg_gate=gate)

        box, box_dir = place(0, jnp.zeros((1, 2), jnp.float32), jnp.zeros(1, bool))
        agent, agent_dir = place(1, box[jnp.array([0, 2])][None], jnp.ones(1, bool))
        return box, box_dir, agent, agent_dir, wall_open, room_weight

    j_out = jax.jit(jax.vmap(one))(js)
    t_seed = torch.from_numpy(seeds.astype(np.int64))
    wall_open = mazegen.gen_walls_plain(trng.sub(t_seed, 17), 8, 8)
    np.testing.assert_array_equal(wall_open.numpy(), np.asarray(j_out[4]))
    bank = tenv._bank
    rw = bank.room_wall[torch.zeros(n, dtype=torch.long)]
    room_weight = torch.where(rw < 0, torch.ones_like(wall_open[:, :1]),
                              torch.gather(wall_open, 1, torch.clamp(rw, min=0).long()))
    np.testing.assert_array_equal(room_weight.numpy(), np.asarray(j_out[5]))
    slot_seeds = trng.hash_u32(trng.sub(t_seed, 18)[:, None], torch.arange(2)[None, :])
    t_rules = {k: torch.from_numpy(np.repeat(v[None], n, 0)) for k, v in rules.items()}
    ent_pos, ent_dir, agent_pos, agent_dir = tplace.place_all_plain(
        slot_seeds, bank, torch.zeros(n, dtype=torch.int32), t_rules,
        torch.from_numpy(np.repeat(radii[None], n, 0)), torch.ones((n, 1), dtype=torch.bool),
        budget=budget, room_weight=room_weight, seg_gate=(bank.room_seg_wall, wall_open))
    for got, want in ((ent_pos[:, 0], j_out[0]), (ent_dir[:, 0], j_out[1]),
                      (agent_pos, j_out[2]), (agent_dir, j_out[3])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # closed junctions take no placements: every junction room drawn is open
    assert float(room_weight.sum(1).min()) < room_weight.shape[1]


# ---------------------------------------------------------------------------
# the paired tri_pass


@pytest.fixture(scope="module")
def maze3():
    """MazeS3 procgen states: the JAX reset at B=4, agents spread over
    the maze facing all ways, each env with its own maze."""
    jenv = JaxVec("MiniWorld-MazeS3-v0", num_envs=4, obs_width=W, obs_height=H)
    jstate, _ = jenv.reset(jax.random.key(8))
    rng = np.random.default_rng(2)
    pos = np.stack([rng.uniform(0.3, 9.2, 4), np.zeros(4), rng.uniform(0.3, 9.2, 4)], 1)
    walls = np.stack([mazegen.host_gen_walls(np.random.default_rng(10 + i), 3, 3)
                      for i in range(4)]).astype(np.float32)
    jstate = jstate.replace(pos=jnp.asarray(pos, jnp.float32),
                            dir=jnp.asarray(rng.uniform(-np.pi, np.pi, 4), jnp.float32),
                            wall_open=jnp.asarray(walls))
    return jenv, jstate


def test_tri_pass_paired(maze3):
    jenv, jstate = maze3
    cam, (origin, rays) = _port_camera(jstate)
    jb = jenv._bank
    sp = jb.pg_verts9.shape[2]

    def one(s, o, r):
        use_p = jb.pg_sel_base[0] + s.wall_open @ jb.pg_sel_onehot[0]
        return jrc._tri_pass(jb.pg_verts9, jb.pg_attr, s.layout_id, o, r, sp,
                             all_quads=True,
                             paired=(use_p, jb.pg_verts9_alt, jb.pg_attr_alt, jb.pg_tex))

    t_j, a_j = jax.jit(jax.vmap(one))(jstate, origin, rays)
    bank_np, statics = tvector.install_statics(
        *tvector.build_super_bank(make_spec("MiniWorld-MazeS3-v0")), 2, 16 * 12)
    tb = layout_from_numpy(bank_np)
    ts = to_port_state(jstate)
    paired = (tb.pg_verts9_alt, tb.pg_attr_alt, torch.from_numpy(statics["pg_wall"]),
              ts.wall_open)
    t_t, a_t = trc.tri_pass_plain(tb.pg_verts9, tb.pg_attr, ts.layout_id, cam, True,
                                  paired=paired)
    a_j = np.asarray(a_j.astype(jnp.float32))
    a_t = a_t.float().numpy()
    hit = np.isfinite(np.asarray(t_j))
    same = np.where(hit, (a_j == a_t).all(-1), np.isinf(t_t.numpy()))
    _winner_stats(t_j, t_t, same)
    assert hit.mean() > 0.9
    # the closed walls show: some winners are rows of the alternative variant
    alt = bank_np.pg_attr_alt[0][statics["pg_wall"][0] >= 0]
    alt = torch.from_numpy(alt).to(torch.bfloat16).float().numpy()
    assert (a_t[hit][:, None, :] == alt[None]).all(-1).any()


def test_plain_passes_blocked(maze3, monkeypatch):
    """The plain passes over blocks of envs equal one block of all of
    them: tri_pass (paired and seeded) and the pixel epilogue."""
    jenv, jstate = maze3
    env = MiniWorldVec("MiniWorld-MazeS3-v0", 4, obs_width=W, obs_height=H, device="cpu")
    state = to_port_state(jstate)
    bank = env._bank
    cam = trc.camera_grid(state, W, H)
    paired = (bank.pg_verts9_alt, bank.pg_attr_alt, env._pg_wall, state.wall_open)
    seed_t = torch.full((4, H * W), 3.0)
    seed_t[:, ::3] = float("inf")
    seed = (seed_t, torch.ones((4, H * W, 16), dtype=torch.bfloat16))

    def passes():
        t, a = trc.tri_pass_plain(bank.pg_verts9, bank.pg_attr, state.layout_id, cam, True,
                                  None, paired)
        seeded = trc.tri_pass_plain(bank.pg_verts9, bank.pg_attr, state.layout_id, cam, True,
                                    seed, paired)
        ent = trc.entity_pass_plain(state.ent_pos, state.ent_size, state.ent_dir,
                                    state.ent_height, state.ent_color,
                                    trc.entity_flags(bank, state), cam, False, True)
        epi = trc.pixel_epilogue_plain(t, a, *ent, env._atlas, cam, state.light_pos,
                                       state.light_color, state.light_ambient,
                                       state.sky_color, env.fourier_k)
        return (t, a, *seeded, *epi)

    whole = passes()
    monkeypatch.setattr(trc, "_PLAIN_BLOCK_ELEMS", 1)  # one env per block
    assert len(trc._env_blocks(4, 100)) == 4
    blocked = passes()
    assert all(torch.equal(x, y) for x, y in zip(whole, blocked))


# ---------------------------------------------------------------------------
# reset and steps


@pytest.mark.parametrize("procgen", [True, False], ids=["procgen", "bank"])
def test_maze_s3_reset_and_ten_steps(procgen):
    """MazeS3 at B=8, 80x60, episodes of 4 steps: two rounds of
    auto-resets (fresh mazes with procgen, fresh layout draws without).
    Rewards and dones exact, states matching (wall_open exactly), renders
    under the parity rules."""
    env_id = "MiniWorld-MazeS3-v0"
    env = MiniWorldVec(make_spec(env_id, max_episode_steps=4), B, obs_width=W, obs_height=H,
                       device="cpu", procgen=procgen)
    jenv = JaxVec(jax_make_spec(env_id, max_episode_steps=4), num_envs=B, obs_width=W,
                  obs_height=H, procgen=procgen)
    jstate, (j_rgb, j_depth) = jenv.reset(jax.random.key(21))
    tstate, (t_rgb, t_depth) = env.reset(21)
    assert_states_match(jstate, tstate)
    assert_images_match(j_rgb, j_depth, t_rgb, t_depth)
    tstate = to_port_state(jstate)
    first = None if tstate.wall_open is None else tstate.wall_open.clone()
    rng = np.random.default_rng(3)
    dones = 0
    for _ in range(10):
        acts = rng.integers(0, 3, B).astype(np.int32)  # turns and forward
        jstate, (j_rgb, j_depth), j_r, j_d, _ = jenv.step(jstate, jnp.asarray(acts))
        tstate, (t_rgb, t_depth), t_r, t_d, _ = env.step(tstate, torch.from_numpy(acts))
        np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
        np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
        assert_states_match(jstate, tstate)
        if procgen:
            np.testing.assert_array_equal(tstate.wall_open.numpy(), np.asarray(jstate.wall_open))
        else:
            assert tstate.wall_open is None and jstate.wall_open is None
        assert_images_match(j_rgb, j_depth, t_rgb, t_depth)
        dones += int(t_d.sum())
        if bool(t_d.any()):
            tstate = adopt_reset_ulps(jstate, tstate, j_d)
    assert dones >= 2 * B, dones
    if procgen:
        assert not torch.equal(tstate.wall_open, first), "resets drew no fresh maze"


def test_maze8_reset_and_render(maze8):
    """Maze 8x8 procgen at B=8, 16x12: reset (maze generation, placement
    over 176 rooms) and the paired render of Sp = 608 rows."""
    jenv, tenv = maze8
    jstate, (j_rgb, j_depth) = jenv.reset(jax.random.key(4))
    tstate, (t_rgb, t_depth) = tenv.reset(4)
    assert_states_match(jstate, tstate)
    np.testing.assert_array_equal(tstate.wall_open.numpy(), np.asarray(jstate.wall_open))
    assert tenv._bank.pg_verts9.shape[2] == 608
    assert_images_match(j_rgb, j_depth, t_rgb, t_depth)

"""The redesigned render kernels' plain pieces on the CPU: the tri_pass
kernel's per-tile row culling (``tile_cull_plain``) and the epilogue
kernel's per-slot Fourier table (``fourier_table``).

The cull must be exact: a (tile, row) it drops has z-key 0 on every
pixel of the tile by the per-row hit test of ``tri_pass_plain``, so the
kernel's max over the survivors is the full scan's. Checked on views of
four ported scenes at B=4, 80x60, at CameraControl's extremes (fov 20 and
90, pitch +-89, 0.1 m from a wall), and on rows built to graze the cull's
margins; so must the multi-chunk kernel's first level, the box of a
group of tiles (the Maze's views and the grazing rows; Sidewalk's in
tests/test_torch_chunks.py). The table must hold the atlas values the epilogue rounds to
bf16 and pi^2 (fu^2 + fv^2) in the kernel's operation order; a texel
evaluated from it the kernel's way equals ``eval_fourier``, which the
render tests hold against the JAX package.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _kernel_models import group_cull_misses
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.render import raycast as trc

from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

W, H = 80, 60
B = 4
TILE = (16, 12)  # csrc/tri_pass.cu TILE_W x TILE_H
K = 16


def _check_cull(rows, cam, all_quads, tile):
    """Every culled (tile, row) misses every pixel of the tile; returns
    (hits (B, S, HW), keep (B, T, S))."""
    tw, th = tile
    hits = trc.row_hits_plain(rows, cam, all_quads)
    keep = trc.tile_cull_plain(rows, cam, tw, th, all_quads)
    n_tx = -(-W // tw)
    tile_of = ((torch.arange(H)[:, None] // th) * n_tx + torch.arange(W)[None, :] // tw)
    assert keep.shape == (B, n_tx * -(-H // th), rows.shape[1])
    keep_px = keep[:, tile_of.reshape(-1), :].transpose(1, 2)  # (B, S, HW)
    culled_hits = int((hits & ~keep_px).sum())
    assert culled_hits == 0, f"{culled_hits} (row, pixel) hits in culled tiles"
    return hits, keep


def _scene(env_id, procgen):
    env = MiniWorldVec(env_id, B, obs_width=W, obs_height=H, device="cpu", procgen=procgen)
    gen = torch.Generator().manual_seed(4321)
    if env.procgen:
        state = chip_smoke.random_maze_states(env, gen)
    else:  # the reset's placements, every yaw, some pitch
        state, _ = env.reset(seed=7)
        u = torch.rand((B, 2), generator=gen)
        state = state.replace(dir=(u[:, 0] * 2.0 - 1.0) * math.pi,
                              cam_pitch=(u[:, 1] - 0.5) * 30.0)
    bank = env._bank
    cam = trc.camera_grid(state, W, H)
    if env.procgen:
        paired = (bank.pg_verts9_alt, bank.pg_attr_alt, env._pg_wall, state.wall_open)
        rows = trc.stage_rows(bank.pg_verts9, bank.pg_attr, state.layout_id, cam, paired)
    else:
        rows = trc.stage_rows(bank.tri_verts9, bank.tri_attr, state.layout_id, cam)
    return env, rows, cam


@pytest.mark.parametrize("env_id,procgen", [
    ("MiniWorld-Hallway-v0", None), ("MiniWorld-FourRooms-v0", None),
    ("MiniWorld-Maze-v0", True), ("MiniWorld-MazeS3-v0", False),
])
def test_cull_keeps_every_hit(env_id, procgen):
    env, rows, cam = _scene(env_id, procgen)
    hits, keep = _check_cull(rows, cam, env._all_quads, TILE)
    assert hits.any(), "the views hit nothing"
    S = rows.shape[1]
    survivors = float(keep.float().sum(2).mean())
    if env.procgen:  # the 8x8 maze: a tile sees a few dozen of its 608 rows
        assert survivors < S / 4, f"{survivors:.1f} of {S} rows survive per tile"


@pytest.mark.parametrize("tile", [TILE, (8, 6), (32, 16)])
def test_cull_grazing_rows(tile):
    """Edges through tile-corner pixel centres, det near 1e-12, r at the
    NEAR and FAR gates: no row with a hit is culled, quads or mixed."""
    verts9, attr, layout_id, cam = chip_smoke.grazing_case(B, tile, n_rows=256)
    rows = trc.stage_rows(verts9, attr, layout_id, cam)
    style = torch.arange(rows.shape[1]) % 4  # corner, corner, tiny, near/far
    for all_quads in (False, True):
        hits, _ = _check_cull(rows, cam, all_quads, tile)
        hit_rows = hits.any(2)
        for k in range(4):  # each kind of grazing row does hit somewhere
            assert hit_rows[:, style == k].float().mean() > 0.1, (all_quads, k)


@pytest.mark.parametrize("fov,pitch", [(20.0, 89.0), (20.0, -89.0), (90.0, 89.0),
                                       (90.0, -89.0)])
def test_cull_at_camera_extremes(fov, pitch):
    """CameraControl's extremes, beside the +-15 degree pitch draw above:
    fov 20 or 90 and pitch +-89, each camera 0.1 m from its wall, env 0
    panned to face that wall, env 1 facing the room, envs 2 and 3 at 45
    degrees to it. The tile cull and the group box of 2x2 tiles keep
    every row with a hit."""
    env = MiniWorldVec("MiniWorld-CameraControl-v0", B, obs_width=W, obs_height=H, device="cpu")
    state, _ = env.reset(seed=5)
    turn = torch.tensor([math.pi, 0.0, math.pi / 4, -math.pi / 4])
    state = state.replace(dir=state.dir + turn, cam_fov_y=torch.full((B,), fov),
                          cam_pitch=torch.full((B,), pitch))
    cam = trc.camera_grid(state, W, H)
    rows = trc.stage_rows(env._bank.tri_verts9, env._bank.tri_attr, state.layout_id, cam)
    hits, _ = _check_cull(rows, cam, env._all_quads, TILE)
    assert bool(hits.any(2).any(1).all()), "a view hits nothing"
    assert group_cull_misses(rows, cam, env._all_quads, TILE, (2, 2))[0] == 0


@functools.lru_cache(maxsize=1)
def _maze_scene():
    return _scene("MiniWorld-Maze-v0", True)


@pytest.mark.parametrize("group", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
def test_group_box_keeps_every_hit(group):
    """The box of a group of 16x12 tiles, the union of its tiles' boxes,
    keeps every row that hits a pixel of the group: on the 8x8 procgen
    Maze's views (where a 2x2 group keeps a small share of the 608 rows)
    and on rows grazing the margins at the groups' corners."""
    env, rows, cam = _maze_scene()
    missed, keep = group_cull_misses(rows, cam, env._all_quads, TILE, group)
    assert missed == 0
    assert float(keep.float().sum(2).mean()) < rows.shape[1] / 4
    gw, gh = TILE[0] * group[0], TILE[1] * group[1]
    verts9, attr, layout_id, cam = chip_smoke.grazing_case(B, (gw, gh), n_rows=256)
    rows = trc.stage_rows(verts9, attr, layout_id, cam)
    for all_quads in (False, True):
        missed, _ = group_cull_misses(rows, cam, all_quads, TILE, group)
        assert missed == 0
        assert trc.row_hits_plain(rows, cam, all_quads).any(2).float().mean() > 0.1


def _bf16(a):
    """The JAX package's bf16 rounding, to float32."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _random_atlas(rng, n=5):
    atlas = rng.uniform(-0.6, 0.6, (n, 4 + 8 * K)).astype(np.float32)
    atlas[:, 3:3 + 2 * K] = rng.integers(-9, 10, (n, 2 * K)) + rng.uniform(-0.01, 0.01,
                                                                           (n, 2 * K))
    atlas[:, :3] = rng.uniform(0, 1, (n, 3))
    atlas[:, -1] = 1.0
    return atlas


@pytest.mark.parametrize("case", ["hallway", "random"])
def test_fourier_table(case):
    rng = np.random.default_rng(3)
    if case == "hallway":
        env = MiniWorldVec("MiniWorld-Hallway-v0", 2, obs_width=16, obs_height=12, device="cpu")
        atlas = env._atlas.numpy()
        np.testing.assert_array_equal(env._fourier_table.numpy(),
                                      trc.fourier_table(env._atlas, K).numpy())
    else:
        atlas = _random_atlas(rng)
    n = atlas.shape[0]
    table = trc.fourier_table(torch.from_numpy(atlas), K).numpy()
    assert table.shape == (n, 4 + 9 * K) and table.dtype == np.float32
    fu, fv = _bf16(atlas[:, 3:3 + K]), _bf16(atlas[:, 3 + K:3 + 2 * K])
    a0 = 3 + 2 * K
    w_a = _bf16(atlas[:, a0:a0 + 3 * K]).reshape(n, 3, K)
    w_b = _bf16(atlas[:, a0 + 3 * K:a0 + 6 * K]).reshape(n, 3, K)
    pf2 = np.float32(math.pi ** 2) * (fu * fu + fv * fv)  # float32, element by element
    p = table[:, 4:4 + 4 * K].reshape(n, K, 4)
    q = table[:, 4 + 4 * K:4 + 8 * K].reshape(n, K, 4)
    for got, want in ((table[:, :3], _bf16(atlas[:, :3])), (table[:, 3], _bf16(atlas[:, -1])),
                      (p[..., 0], fu), (p[..., 1], fv), (p[..., 2], pf2), (p[..., 3], w_a[:, 0]),
                      (q[..., 0], w_a[:, 1]), (q[..., 1], w_a[:, 2]), (q[..., 2], w_b[:, 0]),
                      (q[..., 3], w_b[:, 1]), (table[:, 4 + 8 * K:], w_b[:, 2])):
        np.testing.assert_array_equal(got, want)


def _texel_from_table(table, slot, uv, footprint):
    """The epilogue kernel's texel loop (csrc/pixel_epilogue.cu), in torch
    on the CPU: the table's row by slot, then K terms in order."""
    bf = trc._bf16
    n_rows = table.shape[0]
    slot_i = torch.round(slot).long()
    row = table[slot_i.clamp(0, n_rows - 1)]
    p = row[:, 4:4 + 4 * K].reshape(-1, K, 4)
    q = row[:, 4 + 4 * K:4 + 8 * K].reshape(-1, K, 4)
    r = row[:, 4 + 8 * K:]
    fp2 = footprint * footprint
    acc_a = acc_b = None
    for k in range(K):
        c, s = trc._cos_sin_turns(p[:, k, 0] * uv[:, 0] + p[:, k, 1] * uv[:, 1])
        att = 1.0 / (1.0 + p[:, k, 2] * fp2)
        c, s = bf(c * att), bf(s * att)
        pa = torch.stack([c * p[:, k, 3], c * q[:, k, 0], c * q[:, k, 1]], 1)
        pb = torch.stack([s * q[:, k, 2], s * q[:, k, 3], s * r[:, k]], 1)
        acc_a = pa if k == 0 else acc_a + pa
        acc_b = pb if k == 0 else acc_b + pb
    tex = torch.clamp(row[:, :3] + bf(bf(acc_a) + bf(acc_b)), 0.0, 1.0)
    tex = torch.where(((slot_i >= 0) & (slot_i < n_rows))[:, None], tex, torch.zeros_like(tex))
    return torch.where((slot_i >= 0)[:, None], tex, torch.ones_like(tex))


def test_texel_from_table_equals_eval_fourier():
    """The kernel's loop over the table gives eval_fourier's texels bit
    for bit: the table moved no rounding."""
    rng = np.random.default_rng(5)
    atlas = torch.from_numpy(_random_atlas(rng, 6))
    n = 20000
    slot = torch.from_numpy(rng.integers(-1, 8, n).astype(np.float32))
    uv = torch.from_numpy(rng.uniform(-30, 30, (n, 2)).astype(np.float32))
    fp = torch.from_numpy(rng.uniform(0, 0.08, n).astype(np.float32))
    want = trc.eval_fourier(atlas, slot, uv, K, fp)
    got = _texel_from_table(trc.fourier_table(atlas, K), slot, uv, fp)
    assert torch.equal(got, want)

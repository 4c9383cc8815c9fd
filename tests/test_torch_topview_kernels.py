"""The redesigned top-view kernels' arithmetic on the CPU, held to the
plain versions (render/topview.py) that test_torch_topview.py holds to
the JAX package.

- ``ortho_scan`` (tests/_kernel_models.py), the tri_pass_ortho kernel's
  scan as it runs it (8x8 tile lists staged 32 rows at a time, the live
  rows compacted in list order, the y terms premultiplied, a strict <),
  equals ``tri_pass_ortho_plain`` on the 8x8 procgen Maze's top view with
  each env's killed rows, on the MazeS3 bank's mixed layouts, and on the
  tie bank of ``test_tri_pass_ortho_ties_across_chunks`` (equal prims,
  the first must win), also where a tile lists more than 32 rows;
- every tile list of a layout starts where the layout before it ends;
- ``texel_nofp``, the top-view epilogue's Fourier texel without a
  footprint (no attenuation), equals ``eval_fourier(..., None, ...)`` bit
  for bit, with and without the glyph branch.
"""

import numpy as np
import pytest
import torch

from _kernel_models import ortho_scan, texel_nofp
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.render import raycast as trc
from miniworld_tpu_torch.render import topview as ttop
from test_torch_topview import _tie_bank
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

K = 16


@pytest.mark.parametrize("env_id,size,kw", [
    ("MiniWorld-Maze-v0", (96, 72), {}), ("MiniWorld-Maze-v0", (80, 60), {}),
    ("MiniWorld-MazeS3-v0", (80, 60), {"procgen": False})],
    ids=["maze8x8-procgen-96x72", "maze8x8-procgen-80x60", "mazes3-bank"])
def test_ortho_scan_matches_plain(env_id, size, kw):
    """The kernel's scan and the full one agree on t (bit for bit) and the
    winner on every pixel. At 96x72 pixel centres fall in the 8x8 Maze's
    junction strips, so each env's kill decides winners there (at 80x60
    none does)."""
    w, h = size
    env = MiniWorldVec(env_id, 6, obs_width=w, obs_height=h, device="cpu", view="top", **kw)
    state, _ = env.reset(seed=9)
    wall_open = state.wall_open if env.procgen else None
    st = env._top
    t_m, row_m = ortho_scan(st, state.layout_id, wall_open)
    t_p, row_p = ttop.tri_pass_ortho_plain(st, state.layout_id, wall_open)
    assert torch.equal(t_m.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(row_m, row_p)
    assert float((row_p >= 0).float().mean()) > 0.3
    if env.procgen:
        killed = ~ttop.row_live(st.row_code[state.layout_id.long()], wall_open)
        assert bool((killed & (st.row_code[state.layout_id.long()] >= 0)).any())
        assert bool((row_p[0] != row_p[1]).any()) == (size == (96, 72))
    else:
        assert len(torch.unique(state.layout_id)) > 1


@pytest.mark.parametrize("size", [(48, 36), (80, 60)], ids=str)
def test_ortho_scan_ties(size):
    """Equal prims in one tile: the first row wins in the kernel's scan as
    in the plain version; at 80x60 tiles list more than 32 rows."""
    _, tbank = _tie_bank()
    st = ttop.top_statics(tbank, *size)
    lid = torch.zeros(2, dtype=torch.int32)
    t_m, row_m = ortho_scan(st, lid)
    t_p, row_p = ttop.tri_pass_ortho_plain(st, lid)
    assert torch.equal(t_m.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(row_m, row_p)
    won = set(torch.unique(row_m).tolist())
    assert {127, 180, 250} <= won and not won & {128, 290, 260}
    if size == (80, 60):
        assert int((st.tile_off[0, 1:] - st.tile_off[0, :-1]).max()) > 32


def test_tile_lists_follow_each_layout():
    """tile_off[l, 0] is where layout l - 1's lists end: each list holds
    only its own layout's rows."""
    env = MiniWorldVec("MiniWorld-MazeS3-v0", 2, obs_width=48, obs_height=36, device="cpu",
                       view="top", procgen=False)
    off = env._top.tile_off
    assert int(off[0, 0]) == 0
    assert torch.equal(off[1:, 0], off[:-1, -1])
    assert bool((off[:, 1:] >= off[:, :-1]).all())


def _random_atlas(rng, n, gains):
    atlas = rng.uniform(-0.3, 0.3, (n, 4 + 8 * K)).astype(np.float32)
    atlas[:, 3:3 + 2 * K] = rng.integers(-9, 10, (n, 2 * K)) + rng.uniform(-0.01, 0.01,
                                                                           (n, 2 * K))
    atlas[:, :3] = rng.uniform(0, 1, (n, 3))
    atlas[:, -1] = gains
    return torch.from_numpy(atlas)


@pytest.mark.parametrize("has_gain", [False, True], ids=["fourier", "gain"])
def test_texel_nofp_equals_eval_fourier(has_gain):
    """The top view's texel (no footprint, no attenuation) from the table
    is eval_fourier without a footprint, bit for bit; with glyph rows
    (gain < 0) and contrast rows (gain > 1) too."""
    rng = np.random.default_rng(13)
    gains = rng.choice([1.0, -0.37, -2.5, 1.8], 8) if has_gain else np.ones(8)
    atlas = _random_atlas(rng, 8, gains.astype(np.float32))
    n = 20000
    slot = torch.from_numpy(rng.integers(-1, 10, n).astype(np.float32))
    uv = torch.from_numpy(rng.uniform(-30, 30, (n, 2)).astype(np.float32))
    want = trc.eval_fourier(atlas, slot, uv, K, None, has_gain)
    got = texel_nofp(trc.fourier_table(atlas, K), slot, uv, K, has_gain)
    assert torch.equal(got, want)
    inside = (slot >= 0) & (slot < 8)
    assert len(torch.unique(got[inside, 0])) > 1000

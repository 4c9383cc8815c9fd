"""The dense super bank's live-row bound and the compacted ACTIVE staging
of the tri_pass kernel, on the CPU.

``raycast.live_row_bound`` sizes the one-chunk kernel's staging of a
procgen super bank rendered from its dense rows (the JAX package's
``tri_active``, raycast.py:1220-1227): it must be at least every env's
live count, over seeded random ``wall_open`` and over mazes from
mazegen's plain version, and it is the largest count some wall
configuration reaches. ``_kernel_models.active_compact_select`` copies
the kernel's staging (live rows only, compacted in any order, each
carrying its row index into the z-key) and is held against the JAX
package's dense render in one chunk, with and without domain
randomisation.

Tolerances: counts and bounds exact; t on every pixel and the 16
attributes on every pixel that a row hits, bit for bit (JAX's single
chunk leaves zeros where nothing hits, the kernel row 0's attributes,
which nothing downstream reads; against the port's plain version
everywhere).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu.render import raycast as jrc
from miniworld_tpu_torch import vector as tvector
from miniworld_tpu_torch.convert import layout_from_numpy
from miniworld_tpu_torch.envs import make_spec
from miniworld_tpu_torch.ops import mazegen
from miniworld_tpu_torch.render import raycast as trc

from _kernel_models import active_compact_select
from _torch_parity import drop_paired, installed_pair, to_port_state
from test_torch_chunks import _port_camera
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

GRIDS = {"MiniWorld-MazeS2-v0": (2, 2), "MiniWorld-MazeS3-v0": (3, 3), "MiniWorld-Maze-v0": (8, 8)}
B, W, H = 4, 32, 24


def _counts(code, n_walls):
    """(L, n_walls, 2) rows live where wall w is open / closed."""
    walled = code >= 0
    c = torch.zeros((code.shape[0], 2 * n_walls), dtype=torch.long)
    c.scatter_add_(1, torch.where(walled, code, 0).long(), walled.long())
    return c.view(-1, n_walls, 2)


@pytest.fixture(scope="module", params=sorted(GRIDS))
def maze_codes(request):
    """(id, (rows, cols), codes (1, S)) of a procgen super bank's dense rows."""
    bank, _ = tvector.build_super_bank(make_spec(request.param))
    codes = trc.wall_codes(layout_from_numpy(tvector.drop_paired_rows(bank)))
    return request.param, GRIDS[request.param], codes


def test_live_bound_covers_every_maze(maze_codes):
    """The bound is at least every env's live count over 256 random
    ``wall_open`` and 256 mazes from mazegen's plain version, is reached
    by the configuration that keeps each wall's larger side live, and is
    below the bank's S (the kernel stages fewer rows than the dense scan)."""
    _, (rows, cols), codes = maze_codes
    bound = trc.live_row_bound(codes)
    n_w = mazegen.num_walls(rows, cols)
    rng = np.random.default_rng(5)
    random_walls = torch.from_numpy(rng.integers(0, 2, (256, n_w)).astype(np.float32))
    seeds = torch.from_numpy(rng.integers(0, 1 << 32, 256, dtype=np.int64))
    mazes = mazegen.gen_walls_plain(seeds, rows, cols)
    assert set(torch.unique(mazes).tolist()) <= {0.0, 1.0}
    for walls in (random_walls, mazes):
        live = trc.row_live(codes[0].expand(walls.shape[0], -1), walls).sum(1)
        assert int(live.max()) <= bound
    c = _counts(codes, n_w)[0]
    best = (c[:, 0] >= c[:, 1]).float()[None]  # open where the open side has more rows
    assert int(trc.row_live(codes, best).sum()) == bound
    assert bound < codes.shape[1]


@pytest.mark.parametrize("seed", range(4))
def test_live_bound_is_the_largest_reachable(seed):
    """Synthetic banks of 3 layouts and 5 walls (codes -2, -1, 2w, 2w + 1
    at random): the bound equals the largest live count over all 32
    wall configurations of every layout."""
    rng = np.random.default_rng(seed)
    n_w, S = 5, 40
    codes = torch.from_numpy(rng.integers(-2, 2 * n_w, (3, S)).astype(np.int32))
    configs = torch.tensor(list(itertools.product((0.0, 1.0), repeat=n_w)))
    most = max(int(trc.row_live(codes[l].expand(len(configs), -1), configs).sum(1).max())
               for l in range(3))
    assert trc.live_row_bound(codes) == most
    assert trc.live_row_bound(torch.full((2, S), -1, dtype=torch.int32)) == S


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "domain_rand"])
def dense(request):
    """(JAX env, port env) of MazeS3 procgen with the paired rows dropped."""
    return installed_pair("MiniWorld-MazeS3-v0", B, W, H, drop_paired,
                          domain_rand=request.param)


def test_env_installs_live_bound(dense):
    """The wrapper's bound of the env's codes is below S, taken once per
    codes tensor, and taken again for new codes."""
    _, env = dense
    code = env._row_code
    bound = trc.live_row_bound(code)
    assert trc._live_bound(code) == bound < code.shape[1]
    assert trc._LIVE_BOUNDS[id(code)][2] == bound
    assert trc._live_bound(torch.full_like(code, -1)) == code.shape[1]
    code2 = code.clone()
    assert trc._live_bound(code2) == bound
    code2.fill_(-1)  # in place: the version moves on
    assert trc._live_bound(code2) == code.shape[1]


def test_compact_staging_matches_jax(dense):
    """The kernel's compacted ACTIVE staging (live rows only, in a random
    slot order, each row's index in its key) gives the JAX package's
    dense ``tri_active`` render in one chunk: t on every pixel and the
    winners' attributes exactly (each env's texture variants with
    domain_rand), and the port's plain version on every pixel."""
    jenv, env = dense
    override = env.domain_rand
    jb = jax.tree.map(jnp.asarray, jenv._bank_np)
    S = jb.tri_verts9.shape[2]
    jstate, _ = jenv.reset(jax.random.key(17))
    rng = np.random.default_rng(9)
    jstate = jstate.replace(dir=jnp.asarray(rng.uniform(-np.pi, np.pi, B), jnp.float32))
    cam, (origin, rays) = _port_camera(jstate, W, H)

    def one(s, o, r):
        act = jb.tri_active_base[0] + s.wall_open @ jb.tri_wall_onehot[0]
        return jrc._tri_pass(jb.tri_verts9, jb.tri_attr, s.layout_id, o, r, S,
                             slot_key=s.tri_slots if override else None,
                             tex_banks=(jb.tri_tex, jb.tri_tex_base, jb.tri_tex_count),
                             dr_active=override, tri_active=act, all_quads=env._all_quads)

    t_j, a_j = jax.jit(jax.vmap(one))(jstate, origin, rays)
    t_j, a_j = np.asarray(t_j), np.asarray(a_j.astype(jnp.float32))
    ts = to_port_state(jstate)
    bank = env._bank
    ov = None
    if override:
        tex_np = env._bank_np
        tex = np.stack([tex_np.tri_tex.astype(np.float32), tex_np.tri_tex_base,
                        tex_np.tri_tex_count, np.zeros_like(tex_np.tri_tex_base)], -1)
        ov = (ts.tri_slots, torch.from_numpy(tex), None)
    t_m, a_m = active_compact_select(bank.tri_verts9, bank.tri_attr, ts.layout_id, cam,
                                     env._row_code, ts.wall_open, env._all_quads, ov)
    hit = np.isfinite(t_j)
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(t_m.numpy(), t_j)
    np.testing.assert_array_equal(a_m.float().numpy()[hit], a_j[hit])
    t_p, a_p = trc.tri_pass(bank.tri_verts9, bank.tri_attr, ts.layout_id, cam, env._all_quads,
                            override=ov, active=(env._row_code, ts.wall_open))
    assert torch.equal(t_p, t_m) and torch.equal(a_p, a_m)

"""The port's top view (``view="top"``, render/topview.py) against the JAX
package's ``render/topview.py`` on the CPU, stage by stage.

- the ortho grid: JAX's pixel centres as its jitted ``render_top_view``
  computes them (read back through its depth, with its scan replaced by
  one that returns the origins' x or z) equal ``ortho_grid``'s exactly,
  at three image sizes over the ported ids' extents and random ones;
- ``_tri_pass_ortho`` against ``tri_pass_ortho_plain`` on the same
  origins, t exact and winners equal: Hallway, PickupObjects, FourRooms,
  Sidewalk, MazeS3 procgen (the dense ``tri_active`` kill from each
  env's maze) and a synthetic bank whose equal prims tie across the
  128-row chunk boundary and inside the clamped last chunk;
- every (tile, row) hit lies in the tile's list (``top_statics``), so
  the kernel's culled scan equals the full one;
- ``_entity_pass_ortho`` against ``entity_pass_ortho_plain``: spheres,
  boxes and mesh entities (box footprints), static and dead ones left
  out, t, colour and normal exact;
- Sign's reset and 3 steps with ``view="top"`` (glyphs with no
  footprint, dict observations), as test_torch_topview_ids.py runs the
  other ids';
- ``view="top"`` with Fourier ``domain_rand`` raises and names the
  reference's fault (topview.py:102-110).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu import MiniWorldVec as JaxVec
from miniworld_tpu.render import topview as jtop
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.ops import geom
from miniworld_tpu_torch.render import topview as ttop

from _torch_parity import to_port_state
from test_torch_topview_ids import top_view_steps
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

B, W, H = 3, 48, 36
DOWN = np.array([0.0, -1.0, 0.0], np.float32)


def _origins(st, layout_id):
    """(B, HW, 3) f32 ortho origins of the port's grid."""
    px, pz = ttop._pixel_coords(st, torch.as_tensor(layout_id).long())
    return torch.stack([px, torch.full_like(px, ttop.TOP_CAM_HEIGHT), pz], -1).numpy()


@pytest.mark.parametrize("size", [(48, 36), (80, 60), (33, 17)], ids=str)
def test_ortho_grid_matches_jax(size):
    """The pixel centres equal JAX's inside its jitted top view (where XLA
    turns its divisions by constants into products with reciprocals)."""
    w, h = size
    jenv = JaxVec("MiniWorld-Hallway-v0", num_envs=1, obs_width=w, obs_height=h)
    state, _ = jenv.reset(jax.random.key(0))
    one = jax.tree.map(lambda x: x[0] if hasattr(x, "ndim") and x.ndim > 0 else x, state)
    one = one.replace(ent_alive=jnp.zeros_like(one.ent_alive))  # t_hit = the fake scan's t
    tex = {"mode": "fourier", "coeffs": jenv._atlas, "k": jenv.fourier_k, "has_gain": False}
    rng = np.random.default_rng(3)
    lo = rng.uniform(-90.0, 40.0, (24, 2)).astype(np.float32)
    span = rng.uniform(0.5, 90.0, (24, 2)).astype(np.float32)
    extents = np.concatenate([
        np.array([[-1, 11, -2, 2], [0, 12, 0, 12], [-7, 7, -7, 7], [-3, 6, -80, 80],
                  [0, 25.75, 0, 25.75], [0, 9.5, 0, 9.5]], np.float32),
        np.stack([lo[:, 0], lo[:, 0] + span[:, 0], lo[:, 1], lo[:, 1] + span[:, 1]], 1)])
    real = jtop._tri_pass_ortho

    def depth_of(axis, ext):
        def fake(bank, layout_id, origins, dirs, tri_active=None):
            return origins[:, axis], jnp.zeros((origins.shape[0], 16), jnp.float32)

        jtop._tri_pass_ortho = fake
        try:
            return jtop.render_top_view(jenv._bank, one, tex, width=w, height=h, extents=ext,
                                        render_agent=False, with_depth=True)[1]
        finally:
            jtop._tri_pass_ortho = real

    both = jax.jit(jax.vmap(lambda e: (depth_of(0, e), depth_of(2, e))))
    jx, jz = (np.asarray(a)[..., 0] for a in both(jnp.asarray(extents)))
    xs, zs = ttop.ortho_grid(torch.from_numpy(extents), w, h)
    np.testing.assert_array_equal(xs.numpy(), jx[:, 0, :])
    np.testing.assert_array_equal(zs.numpy(), jz[:, :, 0])


def _jax_scan(bank, layout_id, origins, wall_open=None):
    """JAX's ``_tri_pass_ortho`` per env, jitted and vmapped as its
    ``view="top"`` render runs it."""
    def one(lid, orig, wo):
        active = None
        if wo is not None:
            active = bank.tri_active_base[0] + wo @ bank.tri_wall_onehot[0]
        return jtop._tri_pass_ortho(bank, lid, orig, jnp.broadcast_to(DOWN, orig.shape),
                                    tri_active=active)

    fn = jax.jit(jax.vmap(one, in_axes=(0, 0, None if wall_open is None else 0)))
    t, attr = fn(jnp.asarray(layout_id), jnp.asarray(origins),
                 None if wall_open is None else jnp.asarray(wall_open))
    return np.asarray(t), np.asarray(attr)


def _assert_scan_matches(bank_attr, t_j, a_j, t_p, row_p):
    """t bit for bit; the port's winner row, read from the one-layout
    bank's (S, 16) attributes, equals JAX's carried row, zeros where
    nothing is hit. Returns the share of pixels hit."""
    np.testing.assert_array_equal(t_p.numpy(), t_j)
    rows = row_p.numpy()
    attr = np.where((rows >= 0)[..., None], bank_attr[np.maximum(rows, 0)], 0.0)
    np.testing.assert_array_equal(attr, a_j)
    return float((rows >= 0).mean())


def _assert_tiles_cover(st, layout_id, wall_open=None):
    """Every row that hits a pixel is in that pixel's tile list."""
    t = ttop.ortho_row_t(st, torch.as_tensor(layout_id, dtype=torch.int32), wall_open)
    hits = torch.isfinite(t)  # (B, HW, Sc)
    n_tx = -(-st.width // ttop.TILE_W)
    y, x = np.divmod(np.arange(st.width * st.height), st.width)
    tile = (y // ttop.TILE_H) * n_tx + x // ttop.TILE_W
    off, lst = st.tile_off.numpy(), st.tile_rows.numpy()
    for b, lid in enumerate(np.asarray(layout_id)):
        bb, p, r = np.nonzero(hits[b:b + 1].numpy())
        for tl in np.unique(tile[p]):
            listed = set(lst[off[lid, tl]:off[lid, tl + 1]].tolist())
            assert set(r[tile[p] == tl].tolist()) <= listed, (lid, tl)
    return int(hits.sum())


@pytest.mark.parametrize("env_id", ["MiniWorld-Hallway-v0", "MiniWorld-PickupObjects-v0",
                                    "MiniWorld-FourRooms-v0", "MiniWorld-Sidewalk-v0",
                                    "MiniWorld-MazeS3-v0"])
def test_tri_pass_ortho_matches_jax(env_id):
    """The scan on the id's installed bank (the super bank with each env's
    maze for MazeS3, at 96x72, where pixel centres fall in the 0.25 m
    junction strips), same origins: t and winners equal; tile lists
    cover every hit."""
    w, h = (96, 72) if env_id == "MiniWorld-MazeS3-v0" else (W, H)
    env = MiniWorldVec(env_id, B, obs_width=w, obs_height=h, device="cpu", view="top")
    jenv = JaxVec(env_id, num_envs=B, obs_width=w, obs_height=h, view="top")
    state, _ = env.reset(seed=4)
    st = env._top
    lid = state.layout_id
    wall_open = state.wall_open if env.procgen else None
    t_p, row_p = ttop.tri_pass_ortho_plain(st, lid, wall_open)
    t_j, a_j = _jax_scan(jenv._bank, lid.numpy(), _origins(st, lid.numpy()),
                         None if wall_open is None else wall_open.numpy())
    assert env.num_layouts == 1
    hit = _assert_scan_matches(env._bank.tri_attr[0].numpy(), t_j, a_j, t_p, row_p)
    assert hit > 0.01  # Sidewalk: a 9 m strip in a 216 m wide view
    assert _assert_tiles_cover(st, lid.numpy(), wall_open) > 0
    if env.procgen:  # the kill matters: the mazes differ in their junctions' winners
        assert bool((row_p[0] != row_p[1]).any() | (row_p[0] != row_p[2]).any())


def _tie_bank(seed=5, S=300):
    """A bank of S floor prims in [0, 10]^2 at heights 0-2: random quads
    and triangles, some masked, and equal quads (same t everywhere) at
    rows 127 and 128 (across the first chunk boundary of 128), 180 and
    290 (180 is read by chunks 1 and 2, the last clamped to rows
    172-299), 250 and 260; attr column 11 holds each row's index."""
    rng = np.random.default_rng(seed)
    verts = np.zeros((S, 3, 3), np.float32)
    for i in range(S):
        x0, z0 = rng.uniform(0, 9, 2)
        sx, sz = rng.uniform(0.3, 3.0, 2)
        y = rng.choice([0.0, 0.5, 1.25, 2.0])
        # counter-clockwise from above: det = e1 x e2 . up > 0 under -y rays
        verts[i] = [[x0, y, z0], [x0, y, z0 + sz], [x0 + sx, y, z0]]
    for a, b, box in ((127, 128, (2, 2, 4, 4)), (180, 290, (6, 1, 3, 3)), (250, 260, (1, 7, 2, 2))):
        x0, z0, sx, sz = box
        verts[a] = verts[b] = [[x0, 3.0, z0], [x0, 3.0, z0 + sz], [x0 + sx, 3.0, z0]]
    attr = np.zeros((S, 16), np.float32)
    attr[:, 11] = np.arange(S)
    attr[:, 15] = rng.choice([0.0, 1.0], S)
    attr[[127, 128, 180, 290, 250, 260], 15] = 0.0
    mask = rng.random(S) > 0.1
    mask[[127, 128, 180, 290, 250, 260]] = True
    ext = np.array([0.0, 12.0, 0.0, 12.0], np.float32)
    jbank = types.SimpleNamespace(tri_verts=jnp.asarray(verts[None]),
                                  tri_attr=jnp.asarray(attr[None]),
                                  tri_mask=jnp.asarray(mask[None]))
    tbank = types.SimpleNamespace(tri_verts=torch.from_numpy(verts[None]),
                                  tri_attr=torch.from_numpy(attr[None]),
                                  tri_mask=torch.from_numpy(mask[None]),
                                  tri_wall_onehot=None, extents=torch.from_numpy(ext[None]))
    return jbank, tbank


def test_tri_pass_ortho_ties_across_chunks():
    """Equal prims: JAX's chunk rule (argmin in a chunk, strict < across
    chunks, the clamped last chunk) and the port's first row agree."""
    jbank, tbank = _tie_bank()
    st = ttop.top_statics(tbank, W, H)
    lid = np.zeros(1, np.int32)
    t_p, row_p = ttop.tri_pass_ortho_plain(st, torch.from_numpy(lid))
    t_j, a_j = _jax_scan(jbank, lid, _origins(st, lid))
    _assert_scan_matches(tbank.tri_attr[0].numpy(), t_j, a_j, t_p, row_p)
    won = set(np.unique(row_p.numpy()).tolist())
    assert {127, 180, 250} <= won and not won & {128, 290, 260}
    _assert_tiles_cover(st, lid)


def test_entity_pass_ortho_matches_jax():
    """PickupObjects' entities (balls, boxes, keys as mesh entities) moved
    over the view, turned, resized, some dead: the footprints' t, colour
    and normal exact, overlaps resolved by the same slot."""
    env = MiniWorldVec("MiniWorld-PickupObjects-v0", 6, obs_width=W, obs_height=H,
                       device="cpu", view="top")
    jenv = JaxVec("MiniWorld-PickupObjects-v0", num_envs=6, obs_width=W, obs_height=H,
                  view="top")
    jstate, _ = jenv.reset(jax.random.key(8))
    rng = np.random.default_rng(8)
    E = jstate.ent_pos.shape[1]
    pos = np.asarray(jstate.ent_pos).copy()
    pos[..., 0] = rng.uniform(0.0, 12.0, (6, E))
    pos[..., 2] = rng.uniform(0.0, 12.0, (6, E))
    jstate = jstate.replace(
        ent_pos=jnp.asarray(pos),
        ent_dir=jnp.asarray(rng.uniform(-np.pi, np.pi, (6, E)).astype(np.float32)),
        ent_height=jnp.asarray(rng.uniform(0.5, 3.0, (6, E)).astype(np.float32)),
        ent_size=jnp.asarray(rng.uniform(0.5, 3.0, (6, E, 3)).astype(np.float32)),
        ent_alive=jnp.asarray(np.asarray(jstate.ent_alive) & (rng.random((6, E)) > 0.15)))
    state = to_port_state(jstate)
    st = env._top
    origins = _origins(st, state.layout_id.numpy())
    fn = jax.jit(jax.vmap(lambda s, o: jtop._entity_pass_ortho(
        jenv._bank, s, o, jnp.broadcast_to(DOWN, o.shape))))
    t_j, c_j, n_j = (np.asarray(a) for a in fn(jstate, jnp.asarray(origins)))
    px, pz = ttop._pixel_coords(st, state.layout_id.long())
    cs = torch.stack([geom.cos(state.ent_dir), geom.sin(state.ent_dir)], -1)
    t_p, c_p, n_p = ttop.entity_pass_ortho_plain(
        px, pz, state.ent_pos, state.ent_size, state.ent_height, state.ent_color, cs,
        ttop.ortho_entity_flags(env._bank, state))
    np.testing.assert_array_equal(t_p.numpy(), t_j)
    np.testing.assert_array_equal(c_p.numpy(), c_j)
    np.testing.assert_array_equal(n_p.numpy(), n_j)
    assert np.isfinite(t_j).mean() > 0.02  # footprints cover pixels


def test_top_view_steps_match_jax_sign():
    top_view_steps("MiniWorld-Sign-v0", {})


def test_top_view_refuses_fourier_domain_rand():
    """The reference reads layout-local slot ids as atlas rows under
    view="top" with Fourier domain_rand; the port refuses and names it."""
    with pytest.raises(ValueError, match="topview.py:102-110"):
        MiniWorldVec("MiniWorld-FourRooms-v0", 2, device="cpu", view="top", domain_rand=True)
    with pytest.raises(ValueError, match="view must be"):
        MiniWorldVec("MiniWorld-FourRooms-v0", 2, device="cpu", view="side")

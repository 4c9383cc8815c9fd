"""The visible_ents kernel's tile cull and occlusion scan, as
tests/_kernel_models.py copies them, against the port's plain version on
the CPU (tests/test_torch_visibility.py holds that one to JAX).

- ``vis_tile_keep`` keeps every (tile, entity) at which ``box_entry``, the
  plain version's slab test, hits a pixel: query boxes grazing tiles'
  edges, straddling the near plane, behind the eye, around it, and random
  ones, under seeded cameras (fov 20-90 degrees, pitch up to +-89); and it
  drops most (tile, entity) pairs of the random ones.
- ``vis_occluded``, the scan that stops at the first live room row hit at
  t <= t_in, says "hidden" exactly where ``t_in < room_depth_plain`` fails,
  at every pixel and entity, and the model's whole query (``vis_visible``)
  equals ``visible_ents_plain`` on every (env, entity): the 8x8 procgen
  Maze (each env's walls) with boxes behind closed walls and flush with
  them (pixels where t_in equals the depth), FourRooms (no walls to kill)
  and PickupObjects with the agent close to its boxes.
- The model's constants are the kernel's #defines.
"""

import math
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _kernel_models import VIS_CULL_MARGIN, entity_tile_of_pixel, vis_occluded, \
    vis_tile_keep, vis_visible
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.ops import mazegen
from miniworld_tpu_torch.render import cuda_build, raycast as trc
from miniworld_tpu_torch.render import visibility as tvis

from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

BOX = np.array([[-tvis.BOX_R, 0.0, -tvis.BOX_R], [tvis.BOX_R, tvis.BOX_H, tvis.BOX_R]])


def test_constants_match_kernel():
    with open(os.path.join(cuda_build.CSRC_DIR, "visible_ents.cu")) as f:
        src = f.read()

    def define(name):
        return float(re.search(rf"#define {name} ([0-9.e]+)f?\b", src).group(1))

    assert (define("TILE_W"), define("TILE_H")) == tvis.VIS_TILE
    assert define("MAX_E") == tvis.MAX_KERNEL_ENTS
    assert define("N_STATS") == tvis.N_STATS
    assert define("VIS_FIELDS") == tvis.VIS_FIELDS
    assert define("CULL_MARGIN") == VIS_CULL_MARGIN
    assert np.float32(define("NEAR")) == np.float32(trc.NEAR)
    assert np.float32(define("FAR")) == np.float32(trc.FAR)
    assert (define("BOX_R"), define("BOX_H")) == (tvis.BOX_R, tvis.BOX_H)


def f32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _cameras(rng, b, w, h, fov, pitch):
    """Cameras of ``b`` agents over a 10 x 10 floor, every yaw; fov_y and
    pitch drawn in [20, 90] and [-89, 89] degrees unless given."""
    state = SimpleNamespace(
        pos=f32(np.stack([rng.uniform(-5, 5, b), np.zeros(b), rng.uniform(-5, 5, b)], 1)),
        dir=f32(rng.uniform(-np.pi, np.pi, b)),
        cam_height=f32(rng.uniform(0.5, 2.0, b)),
        cam_fwd_disp=f32(rng.uniform(0.0, 0.2, b)),
        cam_pitch=f32(rng.uniform(-89, 89, b) if pitch is None else np.full(b, pitch)),
        cam_fov_y=f32(rng.uniform(20, 90, b) if fov is None else np.full(b, fov)))
    return trc.camera_grid(state, w, h)


def _ray(cam, i, x, y):
    """float64 ray direction of env i's pixel (x, y)."""
    xv = float(cam.xbase[x] * cam.tan_x[i])
    yv = float(cam.ybase[y] * cam.tan_y[i])
    f, r, u = (v[i].double().numpy() for v in (cam.fwd, cam.right, cam.up))
    return f + xv * r + yv * u


def _grazing_boxes(rng, cam, n):
    """(B, n, 3) query-box positions against the tiles' edges: each takes a
    pixel of a tile's edge column or row, a point q on its ray and puts the
    corner of its box nearest q's tile within 1e-3 of its size of q, the
    box across the edge in the next tile; one in eight at 0.02-0.3 from
    the eye (astride the near plane)."""
    b, w, h = cam.origin.shape[0], cam.width, cam.height
    tw, th = tvis.VIS_TILE
    corners = np.array([[BOX[i, 0], BOX[j, 1], BOX[k, 2]]
                        for i in range(2) for j in range(2) for k in range(2)])
    pos = np.zeros((b, n, 3))
    for i in range(b):
        o = cam.origin[i].double().numpy()
        for s in range(n):
            vertical, far_side = rng.uniform() < 0.5, rng.uniform() < 0.5
            if vertical:
                tx = rng.integers(0, -(-w // tw))
                x, y = min(tx * tw + (tw - 1 if far_side else 0), w - 1), rng.integers(0, h)
                axis = cam.right[i].double().numpy()
            else:
                ty = rng.integers(0, -(-h // th))
                x, y = rng.integers(0, w), min(ty * th + (th - 1 if far_side else 0), h - 1)
                axis = -cam.up[i].double().numpy()  # rows run down the image
            away = axis if far_side else -axis
            t = rng.uniform(0.02, 0.3) if rng.uniform() < 0.125 else rng.uniform(0.3, 15.0)
            q = o + t * _ray(cam, i, x, y)
            corner = corners[np.argmin(corners @ away)]  # the box extends away from q
            pos[i, s] = q - corner * (1.0 + rng.uniform(-1e-3, 1e-3, 3))
    return pos


def _eye_boxes(rng, cam, n):
    """(B, n, 3): boxes behind the eye, around it (the eye inside) and
    astride it, within 0.3 of it."""
    b = cam.origin.shape[0]
    o = cam.origin.double().numpy()[:, None, :]
    f = cam.fwd.double().numpy()[:, None, :]
    kind = rng.integers(0, 3, (b, n))[..., None]
    behind = o - rng.uniform(0.05, 1.0, (b, n, 1)) * f + rng.uniform(-0.3, 0.3, (b, n, 3))
    around = o - np.array([0.0, 0.1, 0.0]) + rng.uniform(-0.08, 0.08, (b, n, 3))
    astride = o - np.array([0.0, 0.1, 0.0]) + rng.uniform(-0.3, 0.3, (b, n, 3))
    return np.where(kind == 0, behind, np.where(kind == 1, around, astride))


@pytest.mark.parametrize("seed,fov,pitch,size", [
    (0, None, None, (48, 36)),
    (1, 20.0, 89.0, (48, 36)),
    (2, 90.0, -89.0, (42, 30)),
    (3, 90.0, 89.0, (80, 60)),
    (4, 20.0, -89.0, (42, 30)),
], ids=["random", "fov20-pitch89", "fov90-pitch-89-42x30", "fov90-pitch89-80x60",
        "fov20-pitch-89"])
def test_cull_keeps_every_hit(seed, fov, pitch, size):
    """No (tile, entity) at which the plain slab test hits a pixel is
    culled; the grazing boxes hit many tiles through a few edge pixels,
    and the cull drops most random pairs and every dead entity."""
    rng = np.random.default_rng(seed)
    b, n_graze, n_eye, n_rand = 16, 12, 6, 8
    w, h = size
    cam = _cameras(rng, b, w, h, fov, pitch)
    rand = cam.origin.double().numpy()[:, None, :] + rng.uniform(-12, 12, (b, n_rand, 3))
    pos = f32(np.concatenate([_grazing_boxes(rng, cam, n_graze), _eye_boxes(rng, cam, n_eye),
                              rand], 1))
    alive = torch.from_numpy(rng.uniform(size=pos.shape[:2]) < 0.85)
    _, hit = tvis.box_entry(cam, pos)  # (B, HW, E)
    hit = hit & alive[:, None, :]
    keep = vis_tile_keep(cam, pos, alive)  # (B, T, E)
    tile_of = entity_tile_of_pixel(w, h, tvis.VIS_TILE)
    assert int((hit & ~keep[:, tile_of, :]).sum()) == 0
    assert not (keep & ~alive[:, None, :]).any()
    per_tile = torch.zeros((b, keep.shape[1], pos.shape[1]), dtype=torch.long)
    per_tile.index_add_(1, tile_of, hit.long())
    graze = per_tile[:, :, :n_graze]
    assert int(((graze > 0) & (graze <= 3)).sum()) >= 10
    assert int((graze > 0).sum()) >= 40
    rand_keep = keep[:, :, n_graze + n_eye:]
    rand_alive = alive[:, None, n_graze + n_eye:].expand_as(rand_keep)
    assert float(rand_keep[rand_alive].float().mean()) < 0.5


def _face(env, state, rng, near, behind, closed_walls):
    """States of ``env`` with each agent facing a wall of its maze cell
    (a closed one where ``closed_walls``) from ``near`` metres in front of
    its eye, its entity slot 0 ``behind`` metres behind that wall at eye
    height (the box's centre, give or take 0.3), and pitch within 30
    degrees."""
    spec, b = env.spec, env.num_envs
    pitch, size = spec.room_size + spec.gap_size, spec.room_size
    nbr_cell, nbr_wall = mazegen.neighbor_tables(spec.num_rows, spec.num_cols)
    wall_open = state.wall_open.numpy()
    pos, yaw = np.zeros((b, 3)), np.zeros(b)
    ent = state.ent_pos.double().numpy().copy()
    eye_h = state.cam_height.double().numpy() + 0.0
    disp = state.cam_fwd_disp.double().numpy()
    for i in range(b):
        for _ in range(100):
            cell, k = rng.integers(0, spec.num_rows * spec.num_cols), rng.integers(0, 4)
            wall = nbr_wall[cell, k]
            if not closed_walls or wall < 0 or wall_open[i, wall] < 0.5:
                break
        ci, cj = divmod(int(cell), spec.num_cols)
        axis, sign = (0, 1.0) if k == 0 else (0, -1.0) if k == 1 else (2, 1.0) if k == 2 \
            else (2, -1.0)
        lo = np.array([cj * pitch, 0.0, ci * pitch])
        face = lo[axis] + (size if sign > 0 else 0.0)
        other = 2 - axis
        lateral = lo[other] + rng.uniform(0.6, size - 0.6)
        a = rng.uniform(*near)
        p = np.zeros(3)
        p[axis] = face - sign * (a + disp[i])
        p[other] = lateral
        pos[i] = p
        yaw[i] = {0: 0.0, 1: math.pi, 2: -math.pi / 2, 3: math.pi / 2}[int(k)]
        e = np.zeros(3)
        e[axis] = face + sign * (rng.uniform(*behind) + tvis.BOX_R)
        e[other] = lateral + rng.uniform(-0.3, 0.3)
        e[1] = eye_h[i] - 0.1 + rng.uniform(-0.3, 0.3)
        ent[i, 0] = e
    return state.replace(pos=f32(pos), dir=f32(yaw), ent_pos=f32(ent),
                         cam_pitch=f32(rng.uniform(-30, 30, b)))


def _facing(state, rng, dist, slot=None):
    """States with agent i ``dist`` metres (drawn) from its entity slot
    ``slot`` (i mod E by default) on a random bearing, facing it, the
    box's centre at eye height."""
    b, e_n = state.ent_pos.shape[:2]
    idx = np.arange(b) % e_n if slot is None else np.full(b, slot)
    ent = state.ent_pos.double().numpy().copy()
    target = ent[np.arange(b), idx]
    bearing = rng.uniform(-np.pi, np.pi, b)
    r = rng.uniform(*dist, b)
    disp = state.cam_fwd_disp.double().numpy()
    fwd = np.stack([np.cos(bearing), np.zeros(b), -np.sin(bearing)], 1)
    pos = target - (r + disp)[:, None] * fwd
    pos[:, 1] = 0.0
    ent[np.arange(b), idx, 1] = state.cam_height.double().numpy() - 0.1
    return state.replace(pos=f32(pos), dir=f32(bearing), ent_pos=f32(ent),
                         cam_pitch=f32(rng.uniform(-20, 20, b)))


def _random_view(state, rng, lo, hi):
    b = state.pos.shape[0]
    pos = np.stack([rng.uniform(lo[0], hi[0], b), np.zeros(b), rng.uniform(lo[1], hi[1], b)], 1)
    return state.replace(pos=f32(pos), dir=f32(rng.uniform(-np.pi, np.pi, b)))


def _maze_states(env, rng):
    state, _ = env.reset(seed=3)
    return [_face(env, state, rng, (0.05, 0.6), (0.0, 0.6), True),
            _face(env, state, rng, (0.3, 1.2), (0.0, 0.3), False),
            _face(env, state, rng, (0.2, 1.5), (0.0, 0.0), True),  # flush with the wall
            _random_view(state, rng, (0.5, 0.5), (25.5, 25.5))]


def _fourrooms_states(env, rng):
    state, _ = env.reset(seed=4)
    return [_facing(state, rng, (0.15, 6.0)), _random_view(state, rng, (-6.5, -6.5), (6.5, 6.5))]


def _pickup_states(env, rng):
    state, _ = env.reset(seed=5)
    near = _facing(state, rng, (0.15, 0.6))
    alive = near.ent_alive.clone()
    alive[::3, -1] = False  # dead entities in view
    return [near.replace(ent_alive=alive), _facing(state, rng, (0.6, 4.0))]


@pytest.mark.parametrize("env_id,states,size", [
    ("MiniWorld-Maze-v0", _maze_states, (40, 30)),
    ("MiniWorld-FourRooms-v0", _fourrooms_states, (48, 36)),
    ("MiniWorld-PickupObjects-v0", _pickup_states, (48, 36)),
], ids=["maze-procgen", "fourrooms", "pickupobjects-close"])
def test_occlusion_scan_matches_depth(env_id, states, size):
    """At every pixel and entity with a finite t_in, the scan's "hidden"
    is ``t_in < room_depth_plain`` failed; the model's query equals
    ``visible_ents_plain`` on every (env, entity); boxes in view both
    visible and hidden occur."""
    w, h = size
    env = MiniWorldVec(env_id, 6, obs_width=w, obs_height=h, device="cpu")
    rng = np.random.default_rng(7)
    n_vis = n_hidden = n_ties = 0
    for state in states(env, rng):
        wall_open = state.wall_open if env._bank.tri_wall_onehot is not None else None
        assert (wall_open is not None) == (env_id == "MiniWorld-Maze-v0")
        cam = trc.camera_grid(state, w, h)
        args = (env._vis, state.layout_id, wall_open, cam)
        t_in, hit = tvis.box_entry(cam, state.ent_pos)
        depth = tvis.room_depth_plain(*args)
        occluded = vis_occluded(*args, t_in)
        finite = torch.isfinite(t_in)
        want = ~(t_in < depth[:, :, None])
        assert torch.equal(occluded[finite], want[finite])
        got = vis_visible(*args, state.ent_pos, state.ent_alive)
        plain = tvis.visible_ents_plain(*args, state.ent_pos, state.ent_alive)
        assert torch.equal(got, plain)
        in_view = (hit.any(dim=1) & state.ent_alive)
        n_vis += int(plain.sum())
        n_hidden += int((in_view & ~plain).sum())
        n_ties += int((hit & (t_in == depth[:, :, None])).sum())
    assert n_vis > 0
    if env_id == "MiniWorld-Maze-v0":  # boxes flush with walls: t_in == depth decides
        assert n_ties > 0
    if env_id != "MiniWorld-PickupObjects-v0":  # one room: nothing hides a box
        assert n_hidden > 0

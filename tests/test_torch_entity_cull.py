"""The entity_pass kernel's narrower contract and its per-tile cull, on
the CPU.

- The kernel writes colour and normal only where t is finite; the pixel
  epilogue (SS=1 and SS=2) fed NaN there gives the same image and depth,
  bit for bit, as fed the plain version's zeros: no consumer reads the
  undefined part.
- ``entity_tile_keep`` (tests/_kernel_models.py), the kernel's cull as it
  computes it, keeps every slot that ``entity_pass_plain`` hits at a
  sample of the tile, over seeded cameras (fov 20-90 degrees, pitch up
  to +-89 degrees) and entities placed to graze: spheres that reach a
  tile's edge samples from the next tile, boxes whose corner a ray just
  clips, shapes astride the near plane, and random ones; and it culls
  most (tile, slot) pairs of the random ones.
- The model's tile, margin and slot limit are the kernel's #defines.
"""

import math
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _kernel_models import ENT_CULL_MARGIN, entity_tile_keep, entity_tile_of_pixel, \
    epilogue_inputs
from miniworld_tpu_torch import MiniWorldVec
from miniworld_tpu_torch.render import cuda_build, raycast as trc

from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

ACT, SPH, BOX = trc.ENT_ACTIVE, trc.ENT_SPHERE, trc.ENT_BOX


def test_cull_constants_match_kernel():
    with open(os.path.join(cuda_build.CSRC_DIR, "entity_pass.cu")) as f:
        src = f.read()

    def define(name):
        return re.search(rf"#define {name} ([0-9.]+)f?", src).group(1)

    assert int(define("TILE_W")) == trc.ENT_TILE_W
    assert int(define("TILE_H")) == trc.ENT_TILE_H
    assert int(define("MAX_ENTS")) == trc.ENT_MAX_SLOTS
    assert float(define("CULL_MARGIN")) == ENT_CULL_MARGIN


def _cameras(rng, b, w, h, fov=None, pitch=None):
    """Cameras of ``b`` agents spread over a 10 x 10 floor, every yaw;
    fov_y and pitch drawn in [20, 90] and [-89, 89] degrees unless given."""
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    state = SimpleNamespace(
        pos=f32(np.stack([rng.uniform(-5, 5, b), np.zeros(b), rng.uniform(-5, 5, b)], 1)),
        dir=f32(rng.uniform(-np.pi, np.pi, b)),
        cam_height=f32(rng.uniform(0.5, 2.0, b)),
        cam_fwd_disp=f32(rng.uniform(0.0, 0.2, b)),
        cam_pitch=f32(rng.uniform(-89, 89, b) if pitch is None else np.full(b, pitch)),
        cam_fov_y=f32(rng.uniform(20, 90, b) if fov is None else np.full(b, fov)))
    return trc.camera_grid(state, w, h)


def _rays(cam, xs, ys):
    """(B, n, 3) float64 ray directions of the samples (xs[i], ys[i])."""
    xv = (cam.xbase[xs][None, :] * cam.tan_x[:, None]).double()
    yv = (cam.ybase[ys][None, :] * cam.tan_y[:, None]).double()
    f, r, u = (v.double()[:, None, :] for v in (cam.fwd, cam.right, cam.up))
    return f + xv[..., None] * r + yv[..., None] * u


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _grazing_entities(rng, cam, n):
    """(pos, size, dir, height, flags) (B, n, ...) of slots placed against
    the tiles' edges. Each slot takes a sample on a tile's edge column or
    row, a point q on its ray, and either a sphere whose surface passes
    within 1e-3 of its radius of q, its centre across the edge in the next
    tile, or a box with one corner within 1e-3 of its size of q; one slot
    in eight lies at 0.02-0.3 from the eye (astride the near plane)."""
    b, w, h = cam.origin.shape[0], cam.width, cam.height
    tw, th = trc.ENT_TILE_W, trc.ENT_TILE_H
    vertical = rng.uniform(size=(b, n)) < 0.5
    tx = rng.integers(0, -(-w // tw), (b, n))
    ty = rng.integers(0, -(-h // th), (b, n))
    right_side = rng.uniform(size=(b, n)) < 0.5
    xs = np.where(vertical, np.clip(tx * tw + np.where(right_side, tw - 1, 0), 0, w - 1),
                  rng.integers(0, w, (b, n)))
    ys = np.where(vertical, rng.integers(0, h, (b, n)),
                  np.clip(ty * th + np.where(right_side, th - 1, 0), 0, h - 1))
    d = np.stack([_rays(cam, xs[i], ys[i])[i].numpy() for i in range(b)])  # (B, n, 3)
    near = rng.uniform(size=(b, n)) < 0.125
    t = np.where(near, rng.uniform(0.02, 0.3, (b, n)), rng.uniform(0.3, 15.0, (b, n)))
    o = cam.origin.double().numpy()[:, None, :]
    q = o + t[..., None] * d
    # away from the tile, across its edge: +-right for a column edge, +-up
    # for a row edge, made orthogonal to the ray
    axis = np.where(vertical[..., None], cam.right.double().numpy()[:, None, :],
                    cam.up.double().numpy()[:, None, :])
    away = np.where(right_side[..., None], axis, -axis)
    away = _unit(away - (away * _unit(d)).sum(-1, keepdims=True) * _unit(d))
    sphere = rng.uniform(size=(b, n)) < 0.5
    jitter = rng.uniform(-1e-3, 1e-3, (b, n))
    height = rng.uniform(0.1, 2.0, (b, n))
    radius = 0.5 * height
    centre = q + (radius * (1.0 + jitter))[..., None] * away
    sph_pos = centre - np.stack([np.zeros_like(height), radius, np.zeros_like(height)], -1)
    size = rng.uniform(0.1, 2.0, (b, n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (b, n))
    cd, sd = np.cos(yaw), np.sin(yaw)
    corner = np.stack([rng.choice([-0.5, 0.5], (b, n)) * size[..., 0],
                       rng.choice([0.0, 1.0], (b, n)) * size[..., 1],
                       rng.choice([-0.5, 0.5], (b, n)) * size[..., 2]], -1)
    corner = corner * (1.0 + rng.uniform(-1e-3, 1e-3, (b, n, 3)))
    # local -> world: x along (cd, 0, -sd), y up, z along (sd, 0, cd)
    world = (corner[..., 0:1] * np.stack([cd, 0 * cd, -sd], -1)
             + corner[..., 1:2] * np.array([0.0, 1.0, 0.0])
             + corner[..., 2:3] * np.stack([sd, 0 * cd, cd], -1))
    box_pos = q - world
    pos = np.where(sphere[..., None], sph_pos, box_pos)
    flags = np.where(sphere, ACT | SPH, ACT | BOX)
    return pos, size, yaw, height, flags


def _random_entities(rng, cam, n):
    """Slots anywhere within 12 of the eye, some inactive or shapeless."""
    b = cam.origin.shape[0]
    pos = cam.origin.double().numpy()[:, None, :] + rng.uniform(-12, 12, (b, n, 3))
    pos[..., 1] = rng.uniform(-0.5, 2.5, (b, n))
    flags = rng.choice([ACT | SPH, ACT | BOX, ACT | SPH, ACT | BOX, BOX, SPH, ACT, 0], (b, n))
    return (pos, rng.uniform(0.1, 2.5, (b, n, 3)), rng.uniform(-np.pi, np.pi, (b, n)),
            rng.uniform(0.1, 2.0, (b, n)), flags)


def _per_slot_hits(ents, cam, has_sphere, has_box):
    """(B, E, HW) bool: where entity_pass_plain hits each slot alone."""
    pos, size, yaw, height, color, flags = ents
    return torch.stack([torch.isfinite(trc.entity_pass_plain(
        pos[:, e:e + 1], size[:, e:e + 1], yaw[:, e:e + 1], height[:, e:e + 1],
        color[:, e:e + 1], flags[:, e:e + 1], cam, has_sphere, has_box)[0])
        for e in range(flags.shape[1])], 1)


@pytest.mark.parametrize("seed,fov,pitch,size,shapes", [
    (0, None, None, (48, 36), (True, True)),
    (1, 20.0, 89.0, (48, 36), (True, True)),
    (2, 90.0, -89.0, (42, 30), (True, True)),
    (3, 90.0, 89.0, (80, 60), (True, False)),
    (4, 20.0, -89.0, (42, 30), (False, True)),
], ids=["random", "fov20-pitch89", "fov90-pitch-89-42x30", "fov90-pitch89-spheres",
        "fov20-pitch-89-boxes"])
def test_cull_keeps_every_hit(seed, fov, pitch, size, shapes):
    """No slot that the plain pass hits at a sample of a tile is culled
    for that tile; the grazing placements hit many tiles through a few
    edge samples only, and the cull drops most random (tile, slot) pairs."""
    rng = np.random.default_rng(seed)
    b, n_graze, n_rand = 24, 12, 8
    w, h = size
    cam = _cameras(rng, b, w, h, fov, pitch)
    parts = [_grazing_entities(rng, cam, n_graze), _random_entities(rng, cam, n_rand)]
    pos, size3, yaw, height, flags = (np.concatenate(p, 1) for p in zip(*parts))
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    ents = (f32(pos), f32(size3), f32(yaw), f32(height),
            f32(rng.uniform(0, 1, pos.shape)), torch.from_numpy(flags.astype(np.uint8)))
    hits = _per_slot_hits(ents, cam, *shapes)  # (B, E, HW)
    keep = entity_tile_keep(ents[0], ents[1], ents[3], ents[5], cam, *shapes)  # (B, T, E)
    tile_of = entity_tile_of_pixel(w, h)
    keep_px = keep[:, tile_of, :].transpose(1, 2)  # (B, E, HW)
    assert int((hits & ~keep_px).sum()) == 0
    # per (env, tile, slot): samples hit; grazing slots hit many tiles
    # through few samples, the test's edge cases
    n_tiles = keep.shape[1]
    per_tile = torch.zeros((b, flags.shape[1], n_tiles), dtype=torch.long)
    per_tile.index_add_(2, tile_of, hits.long())
    graze = per_tile[:, :n_graze]
    assert int(((graze > 0) & (graze <= 3)).sum()) >= 20
    assert int((graze > 0).sum()) >= 60
    fl = ents[5][:, None, n_graze:]
    live = ((fl & ACT) != 0) & torch.where((fl & SPH) != 0, shapes[0],
                                           ((fl & BOX) != 0) & shapes[1])
    rand_keep = keep[:, :, n_graze:]
    assert not (rand_keep & ~live).any()
    assert float(rand_keep[live.expand_as(rand_keep)].float().mean()) < 0.5


@pytest.fixture(scope="module")
def pickup():
    env = MiniWorldVec("MiniWorld-PickupObjects-v0", 6, obs_width=16, obs_height=12,
                       device="cpu")
    state, _ = env.reset(seed=5)
    # face each agent towards one of its balls, so entities fill samples
    slot = torch.arange(6) % state.ent_pos.shape[1]
    target = state.ent_pos[torch.arange(6), slot]
    yaw = torch.atan2(-(target[:, 2] - state.pos[:, 2]), target[:, 0] - state.pos[:, 0])
    return env, state.replace(dir=yaw)


@pytest.mark.parametrize("ss", [1, 2])
def test_epilogue_ignores_entity_attrs_at_misses(pickup, ss):
    """pixel_epilogue_plain with NaN colour and normal wherever t_ent is inf
    equals its output with zeros there (the plain entity pass's), on
    PickupObjects' samples at SS=1 and SS=2."""
    env, state = pickup
    w, h = env.obs_width * ss, env.obs_height * ss
    args = list(epilogue_inputs(env, state, w, h))
    t_tri, t_ent, col, nrm = args[0], args[2], args[3], args[4]
    miss = torch.isinf(t_ent)
    assert miss.any() and (~miss).any() and bool((t_ent < t_tri).any())
    want = trc.pixel_epilogue_plain(*args, ss=ss)
    nan = torch.full_like(col, math.nan)
    args[3] = torch.where(miss[..., None], nan, col)
    args[4] = torch.where(miss[..., None], nan, nrm)
    got = trc.pixel_epilogue_plain(*args, ss=ss)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.isnan(got[1]).any()

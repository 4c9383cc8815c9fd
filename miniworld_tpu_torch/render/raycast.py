"""Raycaster of the PyTorch port: RGB-D observations for a batch of envs.

Counterpart of ``miniworld_tpu/render/raycast.py`` (the reference's GL
pipeline, miniworld/miniworld.py:1260-1318 and opengl.py:197-435,
rebuilt as a raycaster). The render runs three stages, each a
hand-written CUDA kernel for Hopper (``miniworld_tpu_torch/csrc``) with
its plain PyTorch version beside it in this module:

  1. ``tri_pass``: static prims — separable-ray hit test, keyed-z
     winner, the winner's 16-float attribute row in the JAX package's
     carry dtype (``attr_carry_dtype``: bf16, or float32 where the slot
     ids exceed 256); on a procgen maze each row's live
     variant (junction or closed wall) picked per env. In scenes with
     dynamic mesh entities the same launch first hit-tests the
     entities' triangle rows, moved to world space per frame by the
     ``entity_mesh_rows`` kernel (``entity_mesh_rows_plain`` its plain
     version), and seeds the static rows' z-competition with that
     result (``entity_mesh_pass_plain`` is the mesh pass's plain
     version). The kernel culls rows per screen tile
     before the hit test (``tile_cull_plain`` is that cull's plain
     version) with the full scan's result. With domain randomization
     the winner's slot column is its texture variant under the env's
     key (``variant_slots``). Over more than one chunk it ranks rows by
     the JAX scan's chunk rule, the last chunk clamped
     (``chunk_starts``), or scans each env's own schedule of chunks
     (``chunk_schedule``: packed PVS, ``chunk_vis``; seeded by the mesh
     rows where there are any);
  2. ``entity_pass``: analytic boxes and spheres;
  3. ``pixel_epilogue``: affine uv, Fourier texture (with
     ``has_gain``, the SDF glyph branch of Sign's atlas) or, in nearest
     mode, the exact texel of the u8 atlas (``eval_nearest``), lighting,
     sky, u8 pack and depth; in fourier mode the kernel reads the atlas's
     per-slot ``fourier_table``. With supersample=2 the hit passes run on a 2x2
     grid of samples per pixel and the epilogue averages each pixel's
     shaded samples.

Each wrapper takes the plain version ONLY for tensors on the CPU; for
CUDA tensors it launches its kernel (and adds one to its count in
``cuda_build.LAUNCHES``) or raises. ``render_rgbd(...,
use_kernels=False)`` runs the plain versions on any device, for
comparison on the card.

Arithmetic follows the JAX expressions operation by operation, so the
plain versions agree with the JAX package to float32 rounding, and the
kernels (built with ``-fmad=false``) agree with the plain versions.

Layouts are batch-major: per-env tensors lead with B; per-pixel ones
are (B, HW, ...) with pixel p = y * W + x, row 0 the top image row.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from typing import NamedTuple

import torch

from miniworld_tpu_torch.ops import geom, rng as rng_ops
from miniworld_tpu_torch.render.cuda_build import check, is_cuda, launch, load, stream
from miniworld_tpu_torch.render.textures import ATLAS_RES
from miniworld_tpu_torch.scene.entities import SHAPE_BOX, SHAPE_MESH_TRIS, SHAPE_SPHERE

NEAR = 0.04  # miniworld/miniworld.py:1287
FAR = 100.0
# OpenGL default global ambient (GL_LIGHT_MODEL_AMBIENT)
GL_GLOBAL_AMBIENT = 0.2

# Packed per-primitive attribute row (Layout.tri_attr):
#   [A(6) | b(2) | normal(3) | color(3) | tex_slot(1) | kind]
ATTR_DIM = 16
_NRM, _COL, _SLOT, _KIND = slice(8, 11), slice(11, 14), 14, 15

# Low mantissa bits of the z-key that carry the winning row index
# (ties at equal quantized depth go to the larger index).
_IDX_BITS = 10
_IDX_MASK = (1 << _IDX_BITS) - 1

class Camera(NamedTuple):
    """Separable ray decomposition for a batch of envs: the ray of pixel
    (y, x) is d = fwd + xv * right + yv * up (unit forward component),
    with xv = xbase[x] * tan_x and yv = ybase[y] * tan_y."""

    origin: torch.Tensor  # (B,3) eye position
    fwd: torch.Tensor  # (B,3)
    right: torch.Tensor  # (B,3)
    up: torch.Tensor  # (B,3)
    tan_x: torch.Tensor  # (B,)
    tan_y: torch.Tensor  # (B,)
    xbase: torch.Tensor  # (W,) 2*(x+0.5)/W - 1
    ybase: torch.Tensor  # (H,) 1 - 2*(y+0.5)/H

    @property
    def width(self) -> int:
        return self.xbase.shape[0]

    @property
    def height(self) -> int:
        return self.ybase.shape[0]

    def xv(self) -> torch.Tensor:
        """(B, HW) per-pixel right coefficient."""
        xs = self.xbase[None, :] * self.tan_x[:, None]  # (B, W)
        return xs[:, None, :].expand(-1, self.height, -1).reshape(xs.shape[0], -1)

    def yv(self) -> torch.Tensor:
        """(B, HW) per-pixel up coefficient."""
        ys = self.ybase[None, :] * self.tan_y[:, None]  # (B, H)
        return ys[:, :, None].expand(-1, -1, self.width).reshape(ys.shape[0], -1)


def camera_grid(state, width: int, height: int) -> Camera:
    """Camera of every env (gluPerspective + gluLookAt with the agent's
    basis; miniworld.py:1283-1301)."""
    origin = geom.cam_position(state.pos, state.dir, state.cam_height,
                               state.cam_fwd_disp)
    fwd, up, right = geom.cam_basis(state.dir, state.cam_pitch)
    tan_y = geom.tan(torch.deg2rad(state.cam_fov_y) * 0.5)
    tan_x = tan_y * (width / height)
    dev = origin.device
    # "/ width" as "* (1 / width)": the form XLA compiles the JAX
    # package's division by a constant to, so rays agree bit for bit
    xbase = 2.0 * (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) \
        * (1.0 / width) - 1.0
    ybase = 1.0 - 2.0 * (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) \
        * (1.0 / height)
    return Camera(origin, fwd, right, up, tan_x, tan_y, xbase, ybase)


def room_of_point(bank, layout_id, p_xz):
    """(B,) index of the room containing (or nearest to) each point:
    argmax over rooms of min-over-edges inward distance."""
    lid = layout_id.long()
    outline = bank.room_outline[lid]  # (B, R, V, 2)
    norms = bank.room_norms[lid]
    vmask = bank.room_vmask[lid]
    rmask = bank.room_mask[lid]
    dp = p_xz[:, None, None, :] - outline
    d = norms[..., 0] * dp[..., 0] + norms[..., 1] * dp[..., 1]  # (B, R, V)
    inf = torch.full_like(d, math.inf)
    score = torch.where(vmask, d, inf).amin(dim=2)
    score = torch.where(rmask, score, -torch.full_like(score, math.inf))
    return torch.argmax(score, dim=1)


# ---------------------------------------------------------------------------
# kernel plumbing


def _cam_args(cam: Camera, b: int):
    """Pointers to the camera tensors the kernels take, and the tensors
    themselves (the caller holds them until the launch is issued)."""
    w, h = cam.width, cam.height
    tensors = [
        ("origin", cam.origin.contiguous(), (b, 3)),
        ("fwd", cam.fwd.contiguous(), (b, 3)),
        ("right", cam.right.contiguous(), (b, 3)),
        ("up", cam.up.contiguous(), (b, 3)),
        ("tan_xy", torch.stack([cam.tan_x, cam.tan_y], dim=1).contiguous(), (b, 2)),
        ("xbase", cam.xbase.contiguous(), (w,)),
        ("ybase", cam.ybase.contiguous(), (h,)),
    ]
    ptrs = tuple(check(t, n, torch.float32, s) for n, t, s in tensors)
    return ptrs, tensors


# ---------------------------------------------------------------------------
# stage 1: static prims


# Fields of a staged row (``_stage``): the camera-basis dots (fwd,
# right, up) of g_det, g_u and g_v, then 1/t_num and the kind column.
ROW_FIELDS = 11
_R_DET, _R_U, _R_V, _R_INV, _R_KIND = 0, 3, 6, 9, 10


def _stage(v9, kind, cam: Camera):
    """Per-(env, row) coefficients of the separable hit test, v9 (B, 9,
    TC), kind (B, TC) -> (B, TC, ROW_FIELDS): g . d = g.fwd + xv *
    g.right + yv * g.up for g in (g_det, g_u, g_v), the reciprocal
    1/t_num (0 where t_num <= 0) and the kind. What the kernels keep in
    shared memory per row."""
    e1x, e1y, e1z = v9[:, 3] - v9[:, 0], v9[:, 4] - v9[:, 1], v9[:, 5] - v9[:, 2]
    e2x, e2y, e2z = v9[:, 6] - v9[:, 0], v9[:, 7] - v9[:, 1], v9[:, 8] - v9[:, 2]
    o = cam.origin
    sx = o[:, 0:1] - v9[:, 0]
    sy = o[:, 1:2] - v9[:, 1]
    sz = o[:, 2:3] - v9[:, 2]
    # g_det = e2 x e1 ; g_u = e2 x s ; g_v = s x e1
    gdx, gdy, gdz = (e2y * e1z - e2z * e1y, e2z * e1x - e2x * e1z,
                     e2x * e1y - e2y * e1x)
    gux, guy, guz = (e2y * sz - e2z * sy, e2z * sx - e2x * sz,
                     e2x * sy - e2y * sx)
    gvx, gvy, gvz = (sy * e1z - sz * e1y, sz * e1x - sx * e1z,
                     sx * e1y - sy * e1x)
    t_num = e2x * gvx + e2y * gvy + e2z * gvz  # (B, TC)
    # 1/t = det * (1/t_num): one reciprocal per prim; t_num <= 0 -> r = 0
    pos = t_num > 0.0
    inv_tnum = torch.where(pos, 1.0 / torch.where(pos, t_num, torch.ones_like(t_num)),
                           torch.zeros_like(t_num))

    def dot(gx, gy, gz, v):
        return gx * v[:, 0:1] + gy * v[:, 1:2] + gz * v[:, 2:3]  # (B, TC)

    return torch.stack([dot(*g, v) for g in ((gdx, gdy, gdz), (gux, guy, guz),
                                              (gvx, gvy, gvz))
                        for v in (cam.fwd, cam.right, cam.up)] + [inv_tnum, kind], dim=2)


def _row_keys(rows, xv, yv, all_quads: bool, all_tris: bool = False):
    """z-key of every (env, row, pixel), rows (B, TC, ROW_FIELDS) from
    ``_stage``, xv / yv (B, HW) -> (B, TC, HW) i32, 0 where the row
    misses the pixel. ``all_tris``: every row is a triangle (coverage
    u + v <= det, the mesh-entity pass)."""
    def lin(i):  # (a + b * xv) + c * yv: 2 multiply-adds per pixel
        return (rows[:, :, i, None] + rows[:, :, i + 1, None] * xv[:, None, :]
                + rows[:, :, i + 2, None] * yv[:, None, :])

    det, u_num, v_num = lin(_R_DET), lin(_R_U), lin(_R_V)  # (B, TC, HW)
    r = det * rows[:, :, _R_INV, None]
    if all_tris:
        cov = u_num + v_num
    elif all_quads:
        cov = torch.maximum(u_num, v_num)
    else:
        kind = rows[:, :, _R_KIND, None]
        cov = torch.maximum(u_num, v_num) + kind * torch.minimum(u_num, v_num)
    hit = (
        (det > 1e-12)
        & (u_num >= 0.0)
        & (v_num >= 0.0)
        & (cov <= det)
        & (r < 1.0 / NEAR)
        & (r > 1.0 / FAR)
    )
    rkey = r.view(torch.int32)
    idx = torch.arange(rows.shape[1], dtype=torch.int32, device=rows.device)[None, :, None]
    return torch.where(hit, (rkey & ~_IDX_MASK) | idx, torch.zeros_like(rkey))


def _chunk_compete(v9, attrs, cam: Camera, xv, yv, all_quads: bool,
                   all_tris: bool = False, act=None):
    """Keyed-z competition of one chunk of prims, v9 (B, 9, TC), attrs
    (B, TC, 16): returns (key_max (B, HW) i32, row (B, HW) i64). ``act``
    (B, TC) f32 0/1, the dense super bank's row liveness, multiplies into
    each row's 1/t_num as the JAX package's ``inv_tnum * act`` does
    (raycast.py:351): a killed row's r is 0 (or NaN) and never hits."""
    rows = _stage(v9, attrs[:, :, _KIND], cam)
    if act is not None:
        rows[:, :, _R_INV] = rows[:, :, _R_INV] * act
    key_max = _row_keys(rows, xv, yv, all_quads, all_tris).amax(dim=1)  # (B, HW)
    return key_max, (key_max & _IDX_MASK).long()


def _t_from_key(key: torch.Tensor) -> torch.Tensor:
    r_best = (key & ~_IDX_MASK).view(torch.float32)
    return torch.where(key > 0, 1.0 / torch.clamp(r_best, min=1e-30),
                       torch.full_like(r_best, math.inf))


def _gather_rows(attrs, row):
    """attrs (B, TC, 16), row (B, HW) -> (B, HW, 16)."""
    return torch.gather(attrs, 1, row[:, :, None].expand(-1, -1, ATTR_DIM))


def _seed_key(seed_t: torch.Tensor) -> torch.Tensor:
    """z-key of a seed given in t-space (raycast._tri_pass ``init``):
    1/t with the row bits all ones, so the seed wins quantized-depth
    ties; 0 (no hit) where 1/t is 0 (t = inf)."""
    seed_r = 1.0 / seed_t
    return torch.where(seed_r > 0.0, (seed_r.view(torch.int32) & ~_IDX_MASK) | _IDX_MASK,
                       torch.zeros_like(seed_r, dtype=torch.int32))


# Largest (env, row, pixel) count a plain hit pass handles at once: it
# runs over blocks of envs, as each of its (B, S, HW) float32
# intermediates at an 8x8 maze's S = 608, B = 1024, 80x60 would take
# 12 GB at once.
_PLAIN_BLOCK_ELEMS = 1 << 26


def _env_blocks(b: int, per_env: int):
    """Slices of at most ``_PLAIN_BLOCK_ELEMS // per_env`` envs (one at
    least) covering range(b)."""
    step = max(1, _PLAIN_BLOCK_ELEMS // max(per_env, 1))
    return [slice(lo, lo + step) for lo in range(0, b, step)]


def _cam_rows(cam: Camera, sl: slice) -> Camera:
    return Camera(cam.origin[sl], cam.fwd[sl], cam.right[sl], cam.up[sl],
                  cam.tan_x[sl], cam.tan_y[sl], cam.xbase, cam.ybase)


def _paired_rows(verts9, attr, lid, paired):
    """Each env's prim rows of a paired procgen bank: (v9 (B, 9, S),
    attrs (B, S, 16), keep (B, S) bool), row s from the primary variant
    (``keep``) where ``pg_wall[s] < 0`` or its wall is open in the env's
    ``wall_open``, from the alternative (the wall's closed quads)
    otherwise (raycast.py:259-295 with use_primary = base + wall_open @
    K). ``paired`` = (verts9_alt (L, 9, S), attr_alt (L, S, 16), pg_wall
    (L, S) i32, wall_open (B, W) f32)."""
    v9_alt, attr_alt, pg_wall, wall_open = paired
    codes = pg_wall[lid].long()  # (B, S)
    openv = torch.gather(wall_open, 1, torch.clamp(codes, min=0))
    keep = (codes < 0) | (openv > 0.5)
    v9 = torch.where(keep[:, None, :], verts9[lid], v9_alt[lid])
    attrs = torch.where(keep[:, :, None], attr[lid], attr_alt[lid])
    return v9, attrs, keep


def wall_codes(bank) -> torch.Tensor:
    """(L, S) i32 maze kill of each bank row: -1 for a row every env has,
    2w for one live iff wall w is open (a junction's content), 2w + 1 for
    one live iff wall w is closed (its closed quads), -2 for a row no env
    has. The dense ``tri_active = tri_active_base + wall_open @
    tri_wall_onehot`` (raycast.py:1220-1227, topview.py:77-84) is
    ``base + sign * wall_open[w]`` with (base, sign) = (0, 1) or (1, -1)
    (``row_live``). Raises unless every column of the one-hot holds at
    most one nonzero, of that form."""
    if bank.tri_wall_onehot is None:
        return torch.full(bank.tri_mask.shape, -1, dtype=torch.int32)
    onehot = bank.tri_wall_onehot.cpu().to(torch.float32)  # (L, NW, S)
    base = bank.tri_active_base.cpu().to(torch.float32)  # (L, S)
    nz = (onehot != 0).sum(dim=1)
    w = onehot.abs().argmax(dim=1)
    sign = torch.gather(onehot, 1, w[:, None, :])[:, 0]
    ok = ((nz == 0) & ((base == 0) | (base == 1))) | (
        (nz == 1) & (((base == 0) & (sign == 1)) | ((base == 1) & (sign == -1))))
    if not bool(ok.all()):
        raise ValueError("tri_wall_onehot / tri_active_base are not a one-wall-per-row kill")
    code = torch.where(nz == 0, torch.where(base == 1, -1, -2), 2 * w + (sign < 0).long())
    return code.to(torch.int32)


def row_live(code: torch.Tensor, wall_open) -> torch.Tensor:
    """(B, S) bool: row live in each env, code (B, S) from ``wall_codes``,
    wall_open (B, NW) f32 or None: ``base + sign * wall_open[w] > 0.5``."""
    if wall_open is None:
        return code == -1
    w = torch.clamp(code >> 1, min=0).long()
    closed_kind = (code & 1) == 1
    base = closed_kind.to(torch.float32)
    sign = 1.0 - 2.0 * base
    live = (base + sign * torch.gather(wall_open, 1, w)) > 0.5
    return torch.where(code >= 0, live, code == -1)


def live_row_bound(code: torch.Tensor) -> int:
    """The most rows one wall configuration leaves live in an env of the
    bank, ``code`` (L, S) from ``wall_codes``: per layout its rows no wall
    kills (code -1) and, for each wall, the larger of its rows live where
    it is open (2w) and where it is closed (2w + 1); the largest over
    layouts. The tri_pass kernel stages that many rows of a dense super
    bank at most (``tri_pass``'s ``active``)."""
    code = code.cpu().long()
    free = (code == -1).sum(1)
    walled = code >= 0
    if not bool(walled.any()):
        return int(free.max())
    n_w = int(code.max()) // 2 + 1
    counts = torch.zeros((code.shape[0], 2 * n_w), dtype=torch.long)
    counts.scatter_add_(1, torch.where(walled, code, 0), walled.long())
    return int((free + counts.view(-1, n_w, 2).amax(2).sum(1)).max())


_LIVE_BOUNDS: dict = {}  # id(row_code) -> (weak ref to it, its version, its bound)


def _live_bound(code: torch.Tensor) -> int:
    """``live_row_bound(code)``, taken once per codes tensor (and again
    after an in-place change): the one host copy of a bank's codes that the
    ACTIVE launches need."""
    hit = _LIVE_BOUNDS.get(id(code))
    if hit is not None and hit[0]() is code and hit[1] == code._version:
        return hit[2]
    key = id(code)
    ref = weakref.ref(code, lambda _, k=key: _LIVE_BOUNDS.pop(k, None))
    _LIVE_BOUNDS[key] = (ref, code._version, live_row_bound(code))
    return _LIVE_BOUNDS[key][2]


def _active_rows(active, lid):
    """The dense super bank's per-env row liveness, (B, S) f32 0/1: the
    JAX package's ``tri_active = tri_active_base + wall_open @
    tri_wall_onehot`` (raycast.py:1220-1227), exact 0/1 for a 0/1
    ``wall_open``, as ``row_live`` of each row's code. ``active`` =
    (row_code (L, S) i32 from ``wall_codes``, wall_open (B, NW) f32) of
    the envs ``lid`` (B,)."""
    code, wall_open = active
    return row_live(code[lid], wall_open).to(torch.float32)


def variant_slots(key, tex):
    """Atlas row of each prim's texture variant this episode
    (raycast.py:285-288, 301-310): key (B,) u32 values (EnvState.tri_slots),
    tex (B, S, 4) f32 rows of (slot id, atlas base, variant count, 0)
    (vector.install_statics) -> (B, S) f32, ``base + min(floor(hash01(key,
    id) * count), count - 1)``, -1 where the base is (no texture)."""
    ids, base, cnt = tex[..., 0], tex[..., 1], tex[..., 2]
    u = rng_ops.hash01(key[:, None], ids.to(torch.int64))
    offs = torch.minimum(torch.floor(u * cnt), cnt - 1.0)
    return torch.where(base >= 0.0, base + offs, torch.full_like(base, -1.0))


def _with_slots(attrs, slots):
    """attrs (B, S, 16) with the slot column replaced by ``slots`` (B, S)."""
    return torch.cat([attrs[..., :_SLOT], slots[..., None], attrs[..., _SLOT + 1:]], dim=-1)


def attr_carry_dtype(n_ids: int) -> torch.dtype:
    """The dtype the winner's attribute row is carried in
    (raycast.attr_carry_dtype): bf16 while every slot id the slot
    column can hold is an exact bf16 integer (``n_ids`` <= 256), float32
    above. ``n_ids`` is the atlas's rows in fourier mode (the column
    holds atlas rows) and ``state.tex_map.shape[1]`` in nearest mode (it
    holds layout-local slot ids, resolved per env through
    ``state.tex_map``; the 8x8 procgen maze has 528)."""
    return torch.bfloat16 if n_ids <= 256 else torch.float32


def _env_rows(verts9, attr, lid, paired=None, override=None):
    """Each env's rows: (v9 (B, 9, S), attrs (B, S, 16)) of its layout,
    of its live variants on a paired bank (``_paired_rows``), and with
    ``override`` = (key (B,), tex (L, S, 4), tex_alt (L, S, 4) or None)
    every row's slot column replaced by its texture variant
    (``variant_slots``; a paired row's from its variant's table), as the
    JAX package's chunk read does per row."""
    if paired is None:
        v9, attrs, keep = verts9[lid], attr[lid], None
    else:
        v9, attrs, keep = _paired_rows(verts9, attr, lid, paired)
    if override is not None:
        key, tex, tex_alt = override
        rows = tex[lid] if keep is None else torch.where(keep[:, :, None], tex[lid], tex_alt[lid])
        attrs = _with_slots(attrs, variant_slots(key, rows))
    return v9, attrs


def tri_pass_plain(verts9, attr, layout_id, cam: Camera, all_quads: bool = False,
                   seed=None, paired=None, override=None, attr_dtype=torch.bfloat16,
                   active=None):
    """Plain version of the tri_pass kernel (raycast._tri_pass,
    single-chunk form): every prim of each env's layout in one pass.

    verts9 (L, 9, S) f32, attr (L, S, 16) f32, layout_id (B,) ->
    (t (B, HW) f32, inf where nothing is hit; attr (B, HW, 16) in
    ``attr_dtype``, the carry dtype: bf16 rounds the winner's row, float32
    keeps it). Unseeded, a no-hit pixel carries row 0, which nothing
    downstream reads. ``seed`` = (t (B, HW) f32, attr (B, HW, 16) in
    ``attr_dtype``), the
    mesh-entity pass's result, starts the z-competition as the JAX
    package's ``init`` carry does: a prim replaces it only with a
    strictly greater key, and no-hit pixels keep the seed's attrs.
    ``paired`` = (verts9_alt, attr_alt, pg_wall, wall_open) renders a
    paired procgen bank (``_paired_rows``): the winner's attributes come
    from its row's live variant. ``override`` = (key (B,), tex, tex_alt)
    replaces every row's slot column by its texture variant
    (``_env_rows``) before the competition, which reads only the
    vertices and the kind column. ``active`` = (row_code (L, S) i32,
    wall_open (B, NW) f32) renders a procgen super bank without paired
    rows, the JAX package's dense ``tri_active`` kill (``_active_rows``).
    Runs over blocks of envs to bound its intermediates.
    """
    S = verts9.shape[2]
    if S > (1 << _IDX_BITS):
        raise ValueError(f"{S} prims exceed the z-key's "
                         f"{1 << _IDX_BITS}-row budget; use tri_pass_chunked")
    b = layout_id.shape[0]
    xv, yv = cam.xv(), cam.yv()
    ts, outs = [], []
    for sl in _env_blocks(b, S * xv.shape[1]):
        lid = layout_id[sl].long()
        v9, attrs = _env_rows(verts9, attr, lid,
                              None if paired is None else (*paired[:3], paired[3][sl]),
                              None if override is None else (override[0][sl], *override[1:]))
        act = None if active is None else _active_rows((active[0], active[1][sl]), lid)
        key, row = _chunk_compete(v9, attrs, _cam_rows(cam, sl), xv[sl], yv[sl], all_quads,
                                  act=act)
        sel = _gather_rows(attrs, row).to(attr_dtype)
        if seed is not None:
            seed_key = _seed_key(seed[0][sl])
            closer = key > seed_key
            key = torch.where(closer, key, seed_key)
            sel = torch.where(closer[:, :, None], sel, seed[1][sl])
        ts.append(_t_from_key(key))
        outs.append(sel)
    return torch.cat(ts), torch.cat(outs)


def chunk_starts(n_rows: int, tri_chunk: int) -> list:
    """First row of each chunk of the JAX package's scan over ``n_rows``
    rows in chunks of ``tri_chunk``: c * tri_chunk, the last one clamped
    to n_rows - tri_chunk as ``dynamic_slice`` clamps it (raycast.py:252-
    269), so a bank that is not a multiple of the chunk re-reads rows in
    its last chunk at other chunk-local indices."""
    return [min(c * tri_chunk, n_rows - tri_chunk) for c in range(-(-n_rows // tri_chunk))]


def _scan_chunks(read, n_chunks: int, b: int, k: int, cam: Camera, all_quads: bool, seed,
                 attr_dtype):
    """The JAX package's scan over chunks (raycast._tri_pass scan body),
    shared by ``tri_pass_chunked`` and ``tri_pass_scheduled``: for each
    block of envs ``sl`` and chunk j < ``n_chunks``, ``read(sl, j)`` gives
    the chunk's rows (v9 (n, 9, k), attrs (n, k, 16), and their liveness
    (n, k) f32 or None: ``_chunk_compete``'s act); each chunk's keyed-z
    winner is carried on a strictly greater key, from no hit (t = inf,
    zero attributes) or from ``seed`` = (t (B, HW), attr (B, HW, 16))
    through the seed key (``_seed_key``). Returns (t (B, HW) f32, attr
    (B, HW, 16) in ``attr_dtype``)."""
    xv, yv = cam.xv(), cam.yv()
    hw = xv.shape[1]
    ts, outs = [], []
    for sl in _env_blocks(b, k * hw):
        c = _cam_rows(cam, sl)
        if seed is None:
            n = c.origin.shape[0]
            key_best = torch.zeros((n, hw), dtype=torch.int32, device=xv.device)
            attr_best = torch.zeros((n, hw, ATTR_DIM), dtype=attr_dtype, device=xv.device)
        else:
            key_best, attr_best = _seed_key(seed[0][sl]), seed[1][sl].to(attr_dtype)
        for j in range(n_chunks):
            v9, attrs, act = read(sl, j)
            key, row = _chunk_compete(v9, attrs, c, xv[sl], yv[sl], all_quads, act=act)
            sel = _gather_rows(attrs, row).to(attr_dtype)
            closer = key > key_best
            key_best = torch.where(closer, key, key_best)
            attr_best = torch.where(closer[:, :, None], sel, attr_best)
        ts.append(_t_from_key(key_best))
        outs.append(attr_best)
    return torch.cat(ts), torch.cat(outs)


def tri_pass_chunked(verts9, attr, layout_id, cam: Camera, tri_chunk: int,
                     all_quads: bool = False, override=None, paired=None,
                     attr_dtype=torch.bfloat16, active=None):
    """Plain version of the tri_pass kernel's multi-chunk scan
    (raycast._tri_pass scan body, zero init, no seed): the prims in
    chunks of ``tri_chunk`` from ``chunk_starts``, each chunk's keyed-z
    winner by its rows' indices within the chunk, carried across chunks
    on a strictly greater key. So a tie at equal quantized depth goes to
    the larger chunk-local index, then to the earlier chunk; a pixel no
    chunk hits gets t = inf and all-zero attributes. A row that two
    chunks read competes in both, as in the JAX scan.

    verts9 (L, 9, S) f32 and attr (L, S, 16) f32 with tri_chunk <= S,
    1024 -> (t (B, HW) f32, attr (B, HW, 16) in ``attr_dtype``). ``paired`` =
    (verts9_alt, attr_alt, pg_wall, wall_open), a paired procgen bank:
    each chunk's rows are the env's live variants (``_paired_rows``).
    ``override`` = (key (B,), tex (L, S, 4), tex_alt (L, S, 4) with a
    paired bank, else None) gives each chunk's rows their texture
    variants, as ``tri_pass_plain`` does. ``active`` = (row_code,
    wall_open): the dense super bank's kill, each chunk's slice of it
    (``tri_pass_plain``). Runs over blocks of envs to bound its
    intermediates.
    """
    S = verts9.shape[2]
    if tri_chunk > min(S, 1 << _IDX_BITS):
        raise ValueError(f"tri_chunk={tri_chunk} must be at most {S} prims and "
                         f"{1 << _IDX_BITS}")
    starts = chunk_starts(S, tri_chunk)

    def read(sl, j):
        part = slice(starts[j], starts[j] + tri_chunk)
        pp = None if paired is None else (paired[0][:, :, part], paired[1][:, part],
                                          paired[2][:, part], paired[3][sl])
        ov = None if override is None else (
            override[0][sl], override[1][:, part],
            None if override[2] is None else override[2][:, part])
        lid = layout_id[sl].long()
        act = None if active is None else _active_rows((active[0][:, part], active[1][sl]), lid)
        return (*_env_rows(verts9[:, :, part], attr[:, part], lid, pp, ov), act)

    return _scan_chunks(read, len(starts), layout_id.shape[0], tri_chunk, cam, all_quads,
                        None, attr_dtype)


def tri_pass_scheduled(verts9, attr, sched, cam: Camera, all_quads: bool = False, seed=None,
                       override=None, attr_dtype=torch.bfloat16):
    """Plain version of the tri_pass kernel's scheduled scan
    (raycast._tri_pass with ``chunk_sched``, or ``chunk_rows``, and
    ``init``): each env scans the chunks of its schedule in order, each
    chunk's keyed-z winner by its rows' indices within the chunk, carried
    on a strictly greater key. So a tie at equal quantized depth goes to
    the larger chunk-local index, then to the earlier position, and a
    chunk the schedule repeats never replaces its first reading.

    verts9 (C, 9, k) f32 and attr (C, k, 16) f32, a bank of one-chunk
    rows (``static_rows``); sched (B, n) int, the chunk rows each env
    scans (``chunk_schedule``) -> (t (B, HW) f32, attr (B, HW, 16) in
    ``attr_dtype``). The carry starts at no hit (t = inf, zero
    attributes) or at ``seed`` = (t (B, HW), attr (B, HW, 16)), the mesh
    pass's result, through the JAX package's seed key (``_seed_key``:
    the seed wins every tie). ``override`` = (key (B,), tex (C, k, 4),
    None) gives each chunk's rows their texture variants, as
    ``tri_pass_plain`` does. Runs over blocks of envs."""
    k = verts9.shape[2]
    if k > (1 << _IDX_BITS):
        raise ValueError(f"chunks of {k} rows exceed the z-key's {1 << _IDX_BITS}-row budget")

    def read(sl, j):
        ov = None if override is None else (override[0][sl], override[1], None)
        return (*_env_rows(verts9, attr, sched[sl, j].long(), None, ov), None)

    return _scan_chunks(read, sched.shape[1], sched.shape[0], k, cam, all_quads, seed,
                        attr_dtype)


def stage_rows(verts9, attr, layout_id, cam: Camera, paired=None):
    """The rows the tri_pass kernel stages for each env: (B, S,
    ROW_FIELDS) coefficients (``_stage``) of the env's layout, of its
    live variants on a paired procgen bank (``_paired_rows``)."""
    v9, attrs = _env_rows(verts9, attr, layout_id.long(), paired)
    return _stage(v9, attrs[:, :, _KIND], cam)


def stage_mesh_rows(rows9, cam: Camera):
    """The rows the tri_pass kernel stages for each env's mesh rows
    (``entity_mesh_rows``' verts9 (B, 9, N)): (B, N, ROW_FIELDS), every
    row a triangle (kind 1.0; the mesh pass's coverage u + v <= det is
    max(u, v) + 1 * min(u, v) bit for bit)."""
    return _stage(rows9, torch.ones_like(rows9[:, 0]), cam)


def row_hits_plain(rows, cam: Camera, all_quads: bool = False):
    """(B, S, HW) bool: row s of env b passes the hit test at the pixel
    (its z-key is not 0), by tri_pass_plain's arithmetic; rows from
    ``stage_rows``."""
    return _row_keys(rows, cam.xv(), cam.yv(), all_quads) > 0


# Cull margin of the tri_pass kernel, per unit of |a| + |b| X + |c| Y
# (csrc/tri_pass.cu derives it), and its floor for subnormal rows.
_CULL_REL = 2.0 ** -20
_CULL_ABS = 1e-30


def _may_hit(rows, box, all_quads: bool):
    """(B, T, S) bool: False only where row s provably misses every
    pixel whose (xv, yv) lies in box t; rows (B, S, ROW_FIELDS), box
    (B, T, 4) = (xlo, xhi, ylo, yhi). The kernel's test, operation for
    operation (tri_pass.cu ``row_culled``)."""
    xlo, xhi, ylo, yhi = (box[..., i, None] for i in range(4))  # (B, T, 1)
    xm = torch.maximum(xlo.abs(), xhi.abs())
    ym = torch.maximum(ylo.abs(), yhi.abs())

    def field(i):  # the value at the 4 corners, and its margin
        a, b, c = (rows[:, None, :, i + j] for j in range(3))  # (B, 1, S)
        corners = [(a + b * x) + c * y for x in (xlo, xhi) for y in (ylo, yhi)]
        return corners, ((a.abs() + b.abs() * xm) + c.abs() * ym) * _CULL_REL + _CULL_ABS

    def every(conds):
        return conds[0] & conds[1] & conds[2] & conds[3]

    (d, md), (u, mu), (v, mv) = field(_R_DET), field(_R_U), field(_R_V)
    inv = rows[:, None, :, _R_INV]
    cull = (every([c < -mu for c in u]) | every([c < -mv for c in v])
            | every([c < -md for c in d]) | ~(inv > 0.0))
    # coverage >= max(u, v) needs kind >= 0 (0 quad, 1 triangle)
    cov_ok = (torch.ones_like(inv, dtype=torch.bool) if all_quads
              else rows[:, None, :, _R_KIND] >= 0.0)
    mdu, mdv = md + mu, md + mv
    cull |= cov_ok & (every([dc - uc < -mdu for dc, uc in zip(d, u)])
                      | every([dc - vc < -mdv for dc, vc in zip(d, v)]))
    finite = every([torch.isfinite(c) for c in d])
    d_hi = torch.maximum(torch.maximum(d[0], d[1]), torch.maximum(d[2], d[3])) + md
    d_lo = torch.minimum(torch.minimum(d[0], d[1]), torch.minimum(d[2], d[3])) - md
    cull |= finite & ((d_hi * inv <= 1.0 / FAR) | (d_lo * inv >= 1.0 / NEAR))
    return ~cull


def tile_cull_plain(rows, cam: Camera, tile_w: int, tile_h: int, all_quads: bool = False):
    """Plain version of the tri_pass kernel's row culling: (B, T, S)
    bool, True where row s may hit a pixel of tile t. Tiles of tile_w x
    tile_h pixels run in row-major order, the last ones cut at the
    image's edge; rows from ``stage_rows``. A row is kept where it
    survives both the kernel's test against the whole image and its test
    against the tile. A culled (tile, row) has z-key 0 on every pixel of
    the tile, so the per-pixel max over the survivors is the max over
    all rows. Runs over blocks of envs."""
    xv = cam.xbase[None, :] * cam.tan_x[:, None]  # (B, W), as the kernel rounds it
    yv = cam.ybase[None, :] * cam.tan_y[:, None]  # (B, H)

    def spans(vals, step):  # per tile column / row: (B, n) lo, hi
        parts = [vals[:, i:i + step] for i in range(0, vals.shape[1], step)]
        return (torch.stack([p.amin(1) for p in parts], 1),
                torch.stack([p.amax(1) for p in parts], 1))

    (xlo, xhi), (ylo, yhi) = spans(xv, tile_w), spans(yv, tile_h)
    b, n_tx, n_ty = xv.shape[0], xlo.shape[1], ylo.shape[1]
    shape = (b, n_ty, n_tx)
    box = torch.stack([xlo[:, None, :].expand(shape), xhi[:, None, :].expand(shape),
                       ylo[:, :, None].expand(shape), yhi[:, :, None].expand(shape)],
                      dim=-1).reshape(b, n_ty * n_tx, 4)
    image = torch.stack([xv.amin(1), xv.amax(1), yv.amin(1), yv.amax(1)], dim=-1)[:, None, :]
    out = []
    for sl in _env_blocks(b, n_ty * n_tx * rows.shape[1] * 16):
        out.append(_may_hit(rows[sl], image[sl], all_quads)
                   & _may_hit(rows[sl], box[sl], all_quads))
    return torch.cat(out)


def _tri_pass_config():
    out = (ctypes.c_int * 6)()
    load().mw_tri_pass_config(out)
    return tuple(out)


def tri_pass_tile():
    """(TILE_W, TILE_H, PIX_PER_THREAD) of the built tri_pass kernel (its
    compile-time constants; builds the library if needed)."""
    return _tri_pass_config()[:3]


def tri_pass_window():
    """(GROUP_X, GROUP_Y, WINDOW_ROWS) of the built multi-chunk tri_pass
    kernel: the tiles a block has in flight and the rows it stages at
    once (builds the library if needed)."""
    return _tri_pass_config()[3:]


# The most rows the tri_pass kernel takes over more than one chunk (its
# row index in 12 bits of the staged rank), and in one schedule (52 bytes
# a row in shared memory: 213 KB of the 227 KB a block can opt into on an
# H100).
MAX_KERNEL_ROWS = 4096


def tri_pass(verts9, attr, layout_id, cam: Camera, all_quads: bool = False, mesh=None,
             paired=None, tri_chunk: int | None = None, override=None,
             attr_dtype=torch.bfloat16, active=None):
    """Stage 1 wrapper: the tri_pass kernel for CUDA tensors, the plain
    version for CPU tensors. With S <= ``tri_chunk`` (None: S), one
    chunk: the contract of ``tri_pass_plain`` seeded by
    ``entity_mesh_pass_plain`` on ``mesh`` = (rows9 (B, 9, N), row_attrs
    (B, N, 16)), N <= 1024: the kernel hit-tests the mesh rows in the
    same launch and seeds the static rows' competition with their winner
    (a launch with mesh rows also counts in
    ``LAUNCHES["entity_mesh_pass"]``). With S > ``tri_chunk``, the
    multi-chunk scan of ``tri_pass_chunked`` in one launch, S <=
    MAX_KERNEL_ROWS, without mesh rows (raises), through the multi-chunk
    kernel (counted in ``LAUNCHES["tri_pass_multi"]``; over a paired bank
    also in ``LAUNCHES["tri_pass_paired_chunks"]``).
    ``layout_id`` (B, n), a schedule (``chunk_schedule``): verts9 (C, 9,
    k) and attr (C, k, 16) are a bank of one-chunk rows and each env scans
    its n chunk rows in order, the contract of ``tri_pass_scheduled``
    (seeded by the mesh pass on ``mesh``), in one launch of the kernel's
    SCHED instances (also counted in ``LAUNCHES["tri_pass_sched"]``), n
    <= 255, n * k <= MAX_KERNEL_ROWS, no paired bank.
    ``override`` = (key (B,) int64 u32 values, tex (L, S, 4), tex_alt
    (L, S, 4) with a paired bank, else None): domain randomization's
    texture variants (``variant_slots``). The plain versions override
    every row before the competition; the kernel only the winner's slot
    column, at its store (the override is a function of the row alone,
    and a mesh winner keeps its own slot), so both give the same
    attributes. The key is converted to the kernel's u32 once here.
    ``attr_dtype``: the carry dtype of the attribute rows
    (``attr_carry_dtype``); float32 launches the kernel's F32 instances
    (also counted in ``LAUNCHES["tri_pass_f32"]``): every launch above has
    one, with mesh rows and with the override too (a Fourier atlas of more
    than 256 rows, or more than 256 layout-local slots in nearest mode).
    ``active`` = (row_code (L, S) i32 from ``wall_codes``, wall_open (B,
    NW) f32): a procgen super bank without paired rows, each env's rows
    killed by its maze (``tri_pass_plain``), in one chunk or over several,
    without mesh rows or a schedule (the ACTIVE instances, also counted in
    ``LAUNCHES["tri_pass_active"]``); the one-chunk kernel stages at most
    the codes' ``live_row_bound`` rows, taken on the host at the first
    launch with these codes."""
    S = verts9.shape[2]
    if attr_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"attr_dtype {attr_dtype}: the carry is bf16 or float32")
    f32 = attr_dtype == torch.float32
    sched = layout_id.dim() == 2
    n_sched = layout_id.shape[1] if sched else 1
    tri_chunk = S if tri_chunk is None or sched else int(tri_chunk)
    multi = S > tri_chunk
    n_mesh = 0 if mesh is None else mesh[0].shape[2]
    if n_mesh > (1 << _IDX_BITS):
        raise ValueError(f"{n_mesh} mesh rows exceed the z-key's "
                         f"{1 << _IDX_BITS}-row budget")
    if multi and mesh is not None:
        raise ValueError("mesh rows over more than one chunk take a schedule "
                         "(static_rows, chunk_schedule)")
    if sched and paired is not None:
        raise ValueError("a schedule scans one-chunk rows, not a paired bank")
    if active is not None and (sched or mesh is not None or paired is not None):
        raise ValueError("the dense tri_active kill scans a super bank's own rows: no "
                         "schedule, mesh rows or paired rows (raycast.py:483-485)")
    ov_tensors = () if override is None else tuple(t for t in override if t is not None)
    if override is not None and (override[2] is None) != (paired is None):
        raise ValueError("override needs tex_alt exactly when the bank is paired")
    if not is_cuda(verts9, attr, layout_id, cam.origin, *(mesh or ()), *(paired or ()),
                   *ov_tensors, *(active or ())):
        if multi:
            return tri_pass_chunked(verts9, attr, layout_id, cam, tri_chunk, all_quads,
                                    override, paired, attr_dtype, active)
        seed = None if mesh is None else entity_mesh_pass_plain(*mesh, cam, attr_dtype)
        if sched:
            return tri_pass_scheduled(verts9, attr, layout_id, cam, all_quads, seed, override,
                                      attr_dtype)
        return tri_pass_plain(verts9, attr, layout_id, cam, all_quads, seed, paired, override,
                              attr_dtype, active)
    L = verts9.shape[0]
    b = layout_id.shape[0]
    hw = cam.width * cam.height
    if multi:
        if tri_chunk < 16 or tri_chunk > (1 << _IDX_BITS) or S > MAX_KERNEL_ROWS:
            raise ValueError(f"tri_pass kernel scans chunks of 16 to {1 << _IDX_BITS} rows, S <= "
                             f"{MAX_KERNEL_ROWS}; got S={S}, tri_chunk={tri_chunk}")
    elif S > (1 << _IDX_BITS):
        raise ValueError(f"tri_pass kernel takes at most {1 << _IDX_BITS} prims in one chunk, "
                         f"got {S}")
    elif sched and (n_sched > 255 or n_sched * S > MAX_KERNEL_ROWS):
        raise ValueError(f"tri_pass kernel scans at most 255 chunks of a schedule and "
                         f"{MAX_KERNEL_ROWS} rows; got {n_sched} of {S}")
    t = torch.empty((b, hw), dtype=torch.float32, device=verts9.device)
    out = torch.empty((b, hw, ATTR_DIM), dtype=attr_dtype, device=verts9.device)
    if mesh is None:
        mesh_ptrs = (ctypes.c_void_p(0),) * 2
    else:
        if n_mesh == 0:
            raise ValueError("tri_pass kernel takes mesh rows with N >= 1")
        mesh_ptrs = (check(mesh[0], "mesh rows9", torch.float32, (b, 9, n_mesh)),
                     check(mesh[1], "mesh row_attrs", torch.float32, (b, n_mesh, ATTR_DIM)))
    n_walls = 0
    paired_ptrs = (ctypes.c_void_p(0),) * 4
    code_ptr = ctypes.c_void_p(0)
    n_live = S
    if paired is not None:
        v9_alt, attr_alt, pg_wall, wall_open = paired
        n_walls = wall_open.shape[1]
        paired_ptrs = (check(v9_alt, "verts9_alt", torch.float32, (L, 9, S)),
                       check(attr_alt, "attr_alt", torch.float32, (L, S, ATTR_DIM)),
                       check(pg_wall, "pg_wall", torch.int32, (L, S)),
                       check(wall_open, "wall_open", torch.float32, (b, n_walls)))
    elif active is not None:  # the kill reads the env's maze in the wall_open slot
        row_code, wall_open = active
        n_walls = wall_open.shape[1]
        code_ptr = check(row_code, "row_code", torch.int32, (L, S))
        if not multi:  # the multi-chunk kernel stages by window
            n_live = _live_bound(row_code)
        paired_ptrs = paired_ptrs[:3] + (check(wall_open, "wall_open", torch.float32,
                                               (b, n_walls)),)
    if override is None:
        ov_ptrs = (ctypes.c_void_p(0),) * 3
    else:
        key32 = override[0].to(torch.int32)  # u32 bits, wrapped
        ov_ptrs = (check(key32, "slot key", torch.int32, (b,)),
                   check(override[1], "slot tex", torch.float32, (L, S, 4)),
                   ctypes.c_void_p(0) if paired is None
                   else check(override[2], "slot tex_alt", torch.float32, (L, S, 4)))
    cam_ptrs, _cam_tensors = _cam_args(cam, b)
    counters = (("tri_pass",) + (() if mesh is None else ("entity_mesh_pass",))
                + (() if override is None else ("tri_pass_override",))
                + (("tri_pass_multi",) if multi else ())
                + (("tri_pass_paired_chunks",) if multi and paired is not None else ())
                + (("tri_pass_sched",) if sched else ())
                + (("tri_pass_f32",) if f32 else ())
                + (() if active is None else ("tri_pass_active",)))
    launch(
        "mw_tri_pass", counters,
        check(verts9, "verts9", torch.float32, (L, 9, S)),
        check(attr, "attr", torch.float32, (L, S, ATTR_DIM)),
        check(layout_id, "layout_id", torch.int32, (b, n_sched) if sched else (b,)),
        *cam_ptrs,
        *mesh_ptrs,
        *paired_ptrs,
        *ov_ptrs,
        code_ptr,
        ctypes.c_int(b), ctypes.c_int(S), ctypes.c_int(n_mesh), ctypes.c_int(cam.width),
        ctypes.c_int(cam.height), ctypes.c_int(n_walls), ctypes.c_int(int(all_quads)),
        ctypes.c_int(tri_chunk), ctypes.c_int(n_sched if sched else 0), ctypes.c_int(int(f32)),
        check(t, "t", torch.float32, (b, hw)),
        check(out, "attr_out", attr_dtype, (b, hw, ATTR_DIM)),
        stream(),
        ctypes.c_int(n_live),
    )
    return t, out


# ---------------------------------------------------------------------------
# dynamic mesh entities: their rows, and the plain version of their pass


def entity_mesh_rows_plain(bank, state, fourier: bool = True):
    """Plain version of the mesh_rows kernel: the world-space triangle
    rows of every dynamic mesh entity (raycast.entity_mesh_rows), for the
    whole batch at once.

    Each SHAPE_MESH_TRIS prototype carries its decimated local-space
    rows (``bank.proto_mesh``, (L, P, M, 25)); per frame every entity's
    rows are rotated by its yaw, scaled by ``su`` = height / proto
    height and moved to its position, and the local affine-uv rows
    compose as A_w = R a / su, b_w = b - A_w . pos. Rows of inactive
    entities (dead, static, not a mesh) and padding rows get all-zero
    vertices, which never hit. With ``fourier`` the slot column becomes
    the atlas base of the row's texture slot (mesh textures have one
    variant), which the Fourier epilogue reads; without it (nearest
    mode) it keeps the layout-local slot, which ``eval_nearest``
    resolves through ``state.tex_map``.

    Returns (verts9 (B, 9, E*M) f32 component-major, attrs (B, E*M, 16)
    f32, valid (B, E*M) bool). The arithmetic is the JAX expression's,
    operation by operation (rot() sums its three column products in
    order; the K=3 dots run left to right).
    """
    lid = state.layout_id.long()[:, None]  # (B, 1)
    p = state.ent_proto.long()  # (B, E)
    rows = bank.proto_mesh[lid, p]  # (B, E, M, 25)
    rmask = bank.proto_mesh_mask[lid, p]  # (B, E, M)
    active = (state.ent_alive & ~bank.proto_static[lid, p]
              & (bank.proto_shape[lid, p] == SHAPE_MESH_TRIS))
    su = state.ent_height / torch.clamp(bank.proto_height[lid, p], min=1e-9)  # (B, E)
    cd = geom.cos(state.ent_dir)[:, :, None]  # (B, E, 1)
    sd = geom.sin(state.ent_dir)[:, :, None]
    zero = torch.zeros_like(cd)
    one = torch.ones_like(cd)
    # rot(a) = a0 * col_x + a1 * col_y + a2 * col_z with col_x = (cd, 0,
    # -sd), col_y = (0, 1, 0), col_z = (sd, 0, cd), summed in that order
    cols = ((cd, zero, -sd), (zero, one, zero), (sd, zero, cd))

    def rot(a):  # (B, E, M, 3) local row vectors -> R a
        return torch.stack([
            a[..., 0] * cols[0][i] + a[..., 1] * cols[1][i] + a[..., 2] * cols[2][i]
            for i in range(3)
        ], dim=-1)

    pos = state.ent_pos[:, :, None, :]  # (B, E, 1, 3)
    su_m = su[:, :, None, None]
    verts = torch.stack([rot(rows[..., 3 * v:3 * v + 3]) * su_m + pos for v in range(3)],
                        dim=-2)  # (B, E, M, 3, 3)
    inv_su = (1.0 / torch.clamp(su, min=1e-9))[:, :, None, None]
    a1 = rot(rows[..., 9:12]) * inv_su
    a2 = rot(rows[..., 12:15]) * inv_su

    def dot_pos(a):  # a @ pos, left to right
        return a[..., 0] * pos[..., 0] + a[..., 1] * pos[..., 1] + a[..., 2] * pos[..., 2]

    b1 = rows[..., 15] - dot_pos(a1)
    b2 = rows[..., 16] - dot_pos(a2)
    nrm = rot(rows[..., 17:20])
    slot = rows[..., 23]
    if fourier:
        tex_base = bank.tex_slot_base[lid[:, 0]].to(torch.float32)  # (B, T)
        slot_i = torch.clamp(torch.round(slot).long(), min=0)
        base = torch.gather(tex_base, 1, slot_i.reshape(slot.shape[0], -1)).reshape(slot.shape)
        slot = torch.where(slot >= 0.0, base, torch.full_like(slot, -1.0))
    colorable = bank.proto_colorable[lid, p][:, :, None, None]  # (B, E, 1, 1)
    tint = torch.where(colorable, state.ent_color[:, :, None, :],
                       torch.ones_like(state.ent_color[:, :, None, :]))
    color = rows[..., 20:23] * tint
    attrs = torch.cat([a1, a2, b1[..., None], b2[..., None], nrm, color,
                       slot[..., None], rows[..., 24:25]], dim=-1)
    valid = rmask & active[:, :, None]
    verts = torch.where(valid[..., None, None], verts, torch.zeros_like(verts))
    b, e, m = valid.shape
    verts9 = verts.reshape(b, e * m, 9).transpose(1, 2).contiguous()
    return verts9, attrs.reshape(b, e * m, ATTR_DIM).contiguous(), valid.reshape(b, e * m)


def entity_mesh_rows(bank, state, fourier: bool = True, use_kernels: bool = True):
    """The mesh_rows kernel (``csrc/mesh_rows.cu``, one launch for the
    batch) for CUDA tensors, ``entity_mesh_rows_plain`` for CPU tensors or
    with ``use_kernels=False``. Same contract and outputs as the plain
    version, bit for bit; counts under ``LAUNCHES["entity_mesh_rows"]``.
    ``state.layout_id`` may be int32 or int64; the bank's tensors are
    taken in the dtypes ``layout_from_numpy`` gives them."""
    if not use_kernels or not is_cuda(state.ent_pos, bank.proto_mesh):
        return entity_mesh_rows_plain(bank, state, fourier)
    L, P, M = bank.proto_mesh.shape[:3]
    T = bank.tex_slot_base.shape[1]
    b, E = state.ent_proto.shape
    n = E * M
    lid = state.layout_id
    if lid.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"layout_id: dtype {lid.dtype}, expected int32 or int64")
    dev = state.ent_pos.device
    verts9 = torch.empty((b, 9, n), dtype=torch.float32, device=dev)
    attrs = torch.empty((b, n, ATTR_DIM), dtype=torch.float32, device=dev)
    valid = torch.empty((b, n), dtype=torch.bool, device=dev)
    launch(
        "mw_entity_mesh_rows", "entity_mesh_rows",
        check(bank.proto_mesh, "proto_mesh", torch.float32, (L, P, M, 25)),
        check(bank.proto_mesh_mask, "proto_mesh_mask", torch.bool, (L, P, M)),
        check(bank.proto_shape, "proto_shape", torch.int32, (L, P)),
        check(bank.proto_static, "proto_static", torch.bool, (L, P)),
        check(bank.proto_height, "proto_height", torch.float32, (L, P)),
        check(bank.proto_colorable, "proto_colorable", torch.bool, (L, P)),
        check(bank.tex_slot_base, "tex_slot_base", torch.int32, (L, T)),
        check(lid, "layout_id", lid.dtype, (b,)),
        check(state.ent_proto, "ent_proto", torch.int32, (b, E)),
        check(state.ent_alive, "ent_alive", torch.bool, (b, E)),
        check(state.ent_height, "ent_height", torch.float32, (b, E)),
        check(state.ent_dir, "ent_dir", torch.float32, (b, E)),
        check(state.ent_pos, "ent_pos", torch.float32, (b, E, 3)),
        check(state.ent_color, "ent_color", torch.float32, (b, E, 3)),
        ctypes.c_int(b), ctypes.c_int(E), ctypes.c_int(L), ctypes.c_int(P), ctypes.c_int(M),
        ctypes.c_int(T), ctypes.c_int(int(lid.dtype == torch.int64)),
        ctypes.c_int(int(fourier)),
        check(verts9, "verts9", torch.float32, (b, 9, n)),
        check(attrs, "attrs", torch.float32, (b, n, ATTR_DIM)),
        check(valid, "valid", torch.bool, (b, n)),
        stream(),
    )
    return verts9, attrs, valid


def entity_mesh_pass_plain(verts9, attrs, cam: Camera, attr_dtype=torch.bfloat16):
    """Plain version of the mesh-entity pass that the tri_pass kernel
    runs first when it is given mesh rows (raycast._entity_mesh_pass):
    keyed-z competition of each env's own world rows
    (``entity_mesh_rows``), triangle coverage u + v <= det.

    verts9 (B, 9, N) f32, attrs (B, N, 16) f32 ->
    (t (B, HW) f32, inf on a miss; attr (B, HW, 16) in ``attr_dtype``,
    zeros on a miss). Runs over blocks of envs to bound its
    intermediates.
    """
    n = verts9.shape[2]
    if n > (1 << _IDX_BITS):
        raise ValueError(f"{n} mesh rows exceed the z-key's {1 << _IDX_BITS}-row budget")
    xv, yv = cam.xv(), cam.yv()
    b, hw = xv.shape
    ts, outs = [], []
    for sl in _env_blocks(b, n * hw):
        key, row = _chunk_compete(verts9[sl], attrs[sl], _cam_rows(cam, sl), xv[sl], yv[sl],
                                  all_quads=False, all_tris=True)
        sel = _gather_rows(attrs[sl], row).to(attr_dtype)
        ts.append(_t_from_key(key))
        outs.append(torch.where((key > 0)[:, :, None], sel, torch.zeros_like(sel)))
    return torch.cat(ts), torch.cat(outs)


# ---------------------------------------------------------------------------
# stage 2: analytic entities

ENT_ACTIVE, ENT_SPHERE, ENT_BOX = 1, 2, 4
# the entity_pass kernel's screen tile (csrc/entity_pass.cu TILE_W, TILE_H)
# and the slots it stages (MAX_ENTS)
ENT_TILE_W, ENT_TILE_H, ENT_MAX_SLOTS = 16, 8, 256


def entity_flags(bank, state) -> torch.Tensor:
    """(B, E) uint8 flags per entity slot: active (alive, not static),
    sphere shape, box shape."""
    lid = state.layout_id.long()[:, None]
    proto = state.ent_proto.long()
    shape = bank.proto_shape[lid, proto]
    static = bank.proto_static[lid, proto]
    active = state.ent_alive & ~static
    flags = (active.to(torch.uint8) * ENT_ACTIVE
             + (shape == SHAPE_SPHERE).to(torch.uint8) * ENT_SPHERE
             + (shape == SHAPE_BOX).to(torch.uint8) * ENT_BOX)
    return flags.to(torch.uint8).contiguous()


def _ray_dot(v, cam: Camera, xv, yv):
    """v . d for per-entity vectors v (B, E, 3) -> (B, E, HW)."""
    def dot(w):
        return v[..., 0] * w[:, 0:1] + v[..., 1] * w[:, 1:2] + v[..., 2] * w[:, 2:3]

    a, b, c = dot(cam.fwd), dot(cam.right), dot(cam.up)
    return a[:, :, None] + b[:, :, None] * xv[:, None, :] + c[:, :, None] * yv[:, None, :]


def entity_pass_plain(ent_pos, ent_size, ent_dir, ent_height, ent_color, flags,
                      cam: Camera, has_sphere: bool = True, has_box: bool = True):
    """Plain version of the entity_pass kernel (raycast._entity_pass).

    Per-entity (B, E[, 3]) inputs; flags (B, E) uint8 (entity_flags).
    Returns (t (B, HW) f32, inf on a miss; color (B, HW, 3); normal
    (B, HW, 3)). Colour and normal are defined only where t is finite:
    the kernel leaves the rest of its buffers unwritten, and the pixel
    epilogue reads them only where the entity is strictly closer than
    the static hit. This version fills the rest with zeros, one instance
    of "undefined".
    """
    xv, yv = cam.xv(), cam.yv()
    b, hw = xv.shape
    E = ent_pos.shape[1]
    dev = ent_pos.device
    origin = cam.origin[:, None, :]
    active = (flags & ENT_ACTIVE) != 0
    is_sphere = (flags & ENT_SPHERE) != 0
    is_box = (flags & ENT_BOX) != 0
    a_px = (1.0 + xv * xv + yv * yv)[:, None, :]  # |d|^2, (B, 1, HW)

    def comp(i):  # ray direction component i, (B, 1, HW)
        return (cam.fwd[:, i:i + 1] + xv * cam.right[:, i:i + 1]
                + yv * cam.up[:, i:i + 1])[:, None, :]

    inf_e = torch.full((b, E, hw), math.inf, device=dev)
    no_e = torch.zeros((b, E, hw), dtype=torch.bool, device=dev)
    if has_sphere:
        zeros_e = torch.zeros_like(ent_height)
        center = ent_pos + torch.stack([zeros_e, 0.5 * ent_height, zeros_e], dim=-1)
        r_vis = 0.5 * ent_height
        oc = origin - center  # (B, E, 3)
        bq = 2.0 * _ray_dot(oc, cam, xv, yv)
        cc = oc[..., 0] * oc[..., 0] + oc[..., 1] * oc[..., 1] + oc[..., 2] * oc[..., 2]
        cc = cc - r_vis * r_vis
        disc = bq * bq - (4.0 * cc)[:, :, None] * a_px
        sq = geom.sqrt(torch.clamp(disc, min=0.0))
        t_sph = (-bq - sq) / (2.0 * a_px)
        sph_hit = (disc > 0.0) & (t_sph > NEAR) & (t_sph < FAR)
    else:
        t_sph, sph_hit = inf_e, no_e

    cd, sd = geom.cos(ent_dir), geom.sin(ent_dir)
    zero = torch.zeros_like(cd)
    ax_x = torch.stack([cd, zero, -sd], dim=-1)  # (B, E, 3)
    ax_z = torch.stack([sd, zero, cd], dim=-1)
    o_rel = origin - ent_pos
    o_l = torch.stack([
        o_rel[..., 0] * ax_x[..., 0] + o_rel[..., 1] * ax_x[..., 1]
        + o_rel[..., 2] * ax_x[..., 2],
        o_rel[..., 1],
        o_rel[..., 0] * ax_z[..., 0] + o_rel[..., 1] * ax_z[..., 1]
        + o_rel[..., 2] * ax_z[..., 2],
    ], dim=-1)
    lo = torch.stack([-ent_size[..., 0] * 0.5, zero, -ent_size[..., 2] * 0.5], dim=-1)
    hi = torch.stack([ent_size[..., 0] * 0.5, ent_size[..., 1], ent_size[..., 2] * 0.5],
                     dim=-1)
    if has_box:
        d_l = (_ray_dot(ax_x, cam, xv, yv), comp(1).expand(b, E, hw),
               _ray_dot(ax_z, cam, xv, yv))
        t_lo, t_hi = [], []
        for k in range(3):
            dk = d_l[k]
            inv = 1.0 / torch.where(dk.abs() < 1e-9, torch.full_like(dk, 1e-9), dk)
            t1 = (lo[..., k] - o_l[..., k])[:, :, None] * inv
            t2 = (hi[..., k] - o_l[..., k])[:, :, None] * inv
            t_lo.append(torch.minimum(t1, t2))
            t_hi.append(torch.maximum(t1, t2))
        t_in = torch.maximum(torch.maximum(t_lo[0], t_lo[1]), t_lo[2])
        t_out = torch.minimum(torch.minimum(t_hi[0], t_hi[1]), t_hi[2])
        box_hit = (t_in <= t_out) & (t_in > NEAR) & (t_in < FAR)
    else:
        t_in, box_hit = inf_e, no_e

    sph_e = is_sphere[:, :, None]
    t_e = torch.where(sph_e, t_sph, t_in)
    hit_e = active[:, :, None] & torch.where(sph_e, sph_hit, box_hit & is_box[:, :, None])
    r_e = torch.where(hit_e, 1.0 / torch.clamp(t_e, min=1e-30), torch.zeros_like(t_e))
    rkey = r_e.view(torch.int32)
    idx = torch.arange(E, dtype=torch.int32, device=dev)[None, :, None]
    key = torch.where(hit_e & (r_e > 0.0), (rkey & ~_IDX_MASK) | idx,
                      torch.zeros_like(rkey))
    key_max = key.amax(dim=1)  # (B, HW)
    any_hit = key_max > 0
    win = (key_max & _IDX_MASK).long()  # (B, HW)
    t_best = _t_from_key(key_max)

    col = torch.gather(ent_color, 1, win[:, :, None].expand(-1, -1, 3))
    col = torch.where(any_hit[:, :, None], col, torch.zeros_like(col))

    normals = []
    if has_sphere:
        inv_rv = 1.0 / torch.clamp(r_vis, min=1e-9)
        t_s = torch.where(sph_hit, t_sph, torch.zeros_like(t_sph))
        ns = [(oc[..., i, None] + t_s * comp(i)) * inv_rv[:, :, None] for i in range(3)]
    if has_box:
        slab = [(t_lo[k] == t_in).to(torch.float32) for k in range(3)]
        norm = 1.0 / torch.clamp(slab[0] + slab[1] + slab[2], min=1.0)
        slab = [s * norm for s in slab]
        sign = -torch.sign(slab[0] * d_l[0] + slab[1] * d_l[1] + slab[2] * d_l[2])
        nb = [
            sign * (slab[0] * ax_x[..., 0, None] + slab[2] * ax_z[..., 0, None]),
            sign * slab[1],
            sign * (slab[0] * ax_x[..., 2, None] + slab[2] * ax_z[..., 2, None]),
        ]
    for i in range(3):
        if has_sphere and has_box:
            n_i = torch.where(sph_e, ns[i], nb[i])
        else:
            n_i = ns[i] if has_sphere else nb[i]
        n_w = torch.gather(n_i, 1, win[:, None, :]).squeeze(1)
        normals.append(torch.where(any_hit, n_w, torch.zeros_like(n_w)))
    return t_best, col, torch.stack(normals, dim=-1)


def entity_pass(ent_pos, ent_size, ent_dir, ent_height, ent_color, flags,
                cam: Camera, has_sphere: bool = True, has_box: bool = True):
    """Stage 2 wrapper: the entity_pass kernel for CUDA tensors, the
    plain version for CPU tensors. Same contract as ``entity_pass_plain``:
    the kernel writes t at every sample and colour and normal only where
    t is finite (its buffers come from ``torch.empty``). E <= 256 slots."""
    args = (ent_pos, ent_size, ent_dir, ent_height, ent_color, flags)
    if not is_cuda(*args, cam.origin):
        return entity_pass_plain(*args, cam, has_sphere, has_box)
    b, E = flags.shape
    if E > ENT_MAX_SLOTS:
        raise ValueError(f"entity_pass kernel takes at most {ENT_MAX_SLOTS} slots, got {E}")
    hw = cam.width * cam.height
    dev = ent_pos.device
    t = torch.empty((b, hw), dtype=torch.float32, device=dev)
    col = torch.empty((b, hw, 3), dtype=torch.float32, device=dev)
    nrm = torch.empty((b, hw, 3), dtype=torch.float32, device=dev)
    cam_ptrs, _cam_tensors = _cam_args(cam, b)
    launch(
        "mw_entity_pass", "entity_pass",
        check(ent_pos, "ent_pos", torch.float32, (b, E, 3)),
        check(ent_size, "ent_size", torch.float32, (b, E, 3)),
        check(ent_dir, "ent_dir", torch.float32, (b, E)),
        check(ent_height, "ent_height", torch.float32, (b, E)),
        check(ent_color, "ent_color", torch.float32, (b, E, 3)),
        check(flags, "flags", torch.uint8, (b, E)),
        *cam_ptrs,
        ctypes.c_int(b), ctypes.c_int(E), ctypes.c_int(cam.width),
        ctypes.c_int(cam.height), ctypes.c_int(int(has_sphere)),
        ctypes.c_int(int(has_box)),
        check(t, "t", torch.float32, (b, hw)),
        check(col, "col", torch.float32, (b, hw, 3)),
        check(nrm, "nrm", torch.float32, (b, hw, 3)),
        stream(),
    )
    return t, col, nrm


# ---------------------------------------------------------------------------
# stage 3: per-pixel epilogue


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest-even) and back: the JAX package's bf16
    streams, value for value."""
    return x.to(torch.bfloat16).to(torch.float32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add (the
    kernels' ``fmaf``): the product is exact in float64, the sum is
    rounded to odd in float64 (its error from a two-sum), and rounding
    to odd at 29 extra bits and then to float32 rounds the exact value
    once."""
    p, c64 = a.double() * b.double(), c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).to(torch.float32)


def _cos_sin_turns(phi: torch.Tensor):
    """(cos, sin) of 2*pi*phi via turn-wrapped degree-4 polynomials in
    t^2 (raycast._cos_sin_turns; max abs error 1.2e-4)."""
    t = phi - torch.round(phi)
    x = t * t
    c = (((46.31062891 * x - 82.70142833) * x + 64.7143991) * x
         - 19.73279735) * x + 0.99997109
    s = t * ((((33.16881029 * x - 74.67622289) * x + 81.40014212) * x
              - 41.33325045) * x + 6.2830885)
    return c, s


def eval_fourier(coeffs, slot, uv, k_terms: int, footprint=None,
                 has_gain: bool = False):
    """Fourier texture model per pixel (raycast.eval_fourier).

    coeffs (A, 4+8K) atlas; slot (N,) atlas row per pixel (-1 = flat
    white, >= A = black); uv (N, 2); footprint (N,) uv-space pixel size
    for the frequency-space anti-aliasing. Returns (N, 3) texels.

    The JAX package feeds frequencies, cos/sin and amplitudes to its dots
    in bf16 and gets bf16 sums back; the same roundings happen here, and
    the K-term sums run in order k = 0..K-1 as the kernel runs them.

    ``has_gain``: the atlas holds glyph rows (any gain, its last
    column, other than 1; raycast.py:656-724). A row's bf16 gain < 0
    marks a Fourier-SDF glyph (textures.fit_sdf_texture): the channels
    are [sdf | ink | bg], and the texel is ink + (bg - ink) * s with s
    the signed distance thresholded at the edge half-width -1 / (2
    gain), grown to 0.55 of the footprint in texels; gain > 1 expands
    the contrast away from the DC term. Operation for operation as the
    JAX expression, whose two multiply-adds ``a + (b - a) * s`` XLA:CPU
    fuses into one rounding each (``_fma``).
    """
    n_rows = coeffs.shape[0]
    k = k_terms
    slot_i = torch.round(slot.to(torch.float32)).long()
    in_range = (slot_i >= 0) & (slot_i < n_rows)
    row = coeffs[slot_i.clamp(0, n_rows - 1)]  # (N, 4+8K)
    fu = _bf16(row[:, 3:3 + k])
    fv = _bf16(row[:, 3 + k:3 + 2 * k])
    phi = fu * uv[:, 0:1] + fv * uv[:, 1:2]
    c, s = _cos_sin_turns(phi)
    if footprint is not None:
        f2 = fu * fu + fv * fv
        att = 1.0 / (1.0 + (math.pi ** 2) * f2 * (footprint[:, None] * footprint[:, None]))
        c, s = c * att, s * att
    ca, sa = _bf16(c), _bf16(s)
    a0 = 3 + 2 * k
    w_a = _bf16(row[:, a0:a0 + 3 * k]).reshape(-1, 3, k)
    w_b = _bf16(row[:, a0 + 3 * k:a0 + 6 * k]).reshape(-1, 3, k)
    acc_a = ca[:, None, 0] * w_a[:, :, 0]
    acc_b = sa[:, None, 0] * w_b[:, :, 0]
    for j in range(1, k):
        acc_a = acc_a + ca[:, None, j] * w_a[:, :, j]
        acc_b = acc_b + sa[:, None, j] * w_b[:, :, j]
    sums = _bf16(_bf16(acc_a) + _bf16(acc_b))
    dc = torch.where(in_range[:, None], _bf16(row[:, 0:3]), torch.zeros_like(sums))
    texel = dc + torch.where(in_range[:, None], sums, torch.zeros_like(sums))
    if has_gain:
        gain = torch.where(in_range, _bf16(row[:, -1]), torch.zeros_like(sums[:, 0]))[:, None]
        w0 = -1.0 / (2.0 * torch.clamp(gain, max=-1e-9))
        w_eff = w0 if footprint is None else torch.maximum(
            w0, (0.55 * footprint[:, None]) * float(ATLAS_RES))
        sdf = torch.clamp(0.5 + texel[:, 0:1] / (2.0 * w_eff), 0.0, 1.0)
        sdf_texel = _fma(texel[:, 2:3] - texel[:, 1:2], sdf, texel[:, 1:2])
        texel = torch.where(gain < 0.0, sdf_texel, texel)
        texel = torch.where(gain > 1.0, _fma(texel - dc, gain, dc), texel)
    return torch.where((slot_i >= 0)[:, None], torch.clamp(texel, 0.0, 1.0),
                       torch.ones_like(texel))


def fourier_row_floats(k_terms: int) -> int:
    """Floats in a ``fourier_table`` row: 4 + 9K, padded to a multiple of
    4 so that every row starts on a 16-byte boundary (K not a multiple of
    4 leaves 2 or 3 zeros at the row's end, which no term reads)."""
    return (4 + 9 * k_terms + 3) // 4 * 4


def fourier_table(atlas, k_terms: int):
    """Per-slot table the pixel_epilogue kernel reads in place of the
    atlas (A, 4+8K): the atlas values that ``eval_fourier`` rounds to
    bf16, rounded once, and pi^2 (fu^2 + fv^2) of each term, in the
    kernel's operation order. Row layout, (A, ``fourier_row_floats(K)``)
    f32: dc(3), the bf16 gain (``eval_fourier``'s glyph marker, 1 for the
    plain rows), then (fu, fv, pi^2 f2, A_0) per term, (A_1, A_2, B_0,
    B_1) per term, B_2 per term, zeros to the row's end. Made once per
    atlas (MiniWorldVec makes it on the CPU when it installs its atlas)."""
    k = k_terms
    n = atlas.shape[0]
    fu = _bf16(atlas[:, 3:3 + k])
    fv = _bf16(atlas[:, 3 + k:3 + 2 * k])
    pf2 = (math.pi ** 2) * (fu * fu + fv * fv)
    a0 = 3 + 2 * k
    w_a = _bf16(atlas[:, a0:a0 + 3 * k]).reshape(n, 3, k)
    w_b = _bf16(atlas[:, a0 + 3 * k:a0 + 6 * k]).reshape(n, 3, k)
    p = torch.stack([fu, fv, pf2, w_a[:, 0]], dim=2).reshape(n, 4 * k)
    q = torch.stack([w_a[:, 1], w_a[:, 2], w_b[:, 0], w_b[:, 1]], dim=2).reshape(n, 4 * k)
    pad = torch.zeros((n, fourier_row_floats(k) - (4 + 9 * k)), dtype=torch.float32,
                      device=atlas.device)
    return torch.cat([_bf16(atlas[:, 0:3]), _bf16(atlas[:, -1:]), p, q, w_b[:, 2], pad],
                     dim=1).contiguous()


def _texel_index(frac, res: int):
    """The texel column of ``frac`` in [0, 1] as (frac * res).astype(int32)
    clipped to [0, res - 1]: XLA converts a NaN to 0 and saturates
    (clamping first gives the same index for every float)."""
    v = frac * float(res)
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    return torch.clamp(v, 0.0, float(res - 1)).long()


def eval_nearest(atlas, tex_map, slot, uv):
    """Exact nearest-neighbour GL_REPEAT texel per pixel
    (raycast.eval_nearest), operation for operation: the slot rounded
    half to even, its atlas row ``tex_map[b, max(slot, 0)]`` per env, the
    fractional uv, the texel's column and (flipped: atlas rows run top
    down, v = 0 is the bottom) row, the u8 value times 1/255; 1.0 where
    the slot is < 0 (flat white).

    atlas (N, R, R, 3) u8; tex_map (B, T) int, each env's atlas row of
    every layout-local slot; slot (B, P) the winner's slot column; uv
    (B, P, 2) -> (B, P, 3) f32. A slot id above T - 1 takes row T - 1, as
    the JAX gather clamps it."""
    res = atlas.shape[1]
    slot_i = torch.round(slot.to(torch.float32)).long()
    rows = torch.gather(tex_map.long(), 1, slot_i.clamp(0, tex_map.shape[1] - 1))
    frac = uv - torch.floor(uv)
    tx = _texel_index(frac[..., 0], res)
    ty = (res - 1) - _texel_index(frac[..., 1], res)
    texel = atlas[rows.clamp(0, atlas.shape[0] - 1), ty, tx].to(torch.float32) * (1.0 / 255.0)
    return torch.where((slot_i >= 0)[..., None], texel, torch.ones_like(texel))


def shade(color, normal, hit_p, light_pos, light_color, light_ambient):
    """GL fixed-function lighting, one positional light + ambient
    (glLightfv setup at miniworld.py:1114-1133; GL_MODULATE). Per-pixel
    (N, 3) color/normal/hit point, per-pixel (N, 3) light terms."""
    l_vec = light_pos - hit_p
    norm = geom.sqrt(l_vec[:, 0] * l_vec[:, 0] + l_vec[:, 1] * l_vec[:, 1]
                      + l_vec[:, 2] * l_vec[:, 2])
    l_dir = l_vec / torch.clamp(norm, min=1e-9)[:, None]
    ndotl = torch.clamp(normal[:, 0] * l_dir[:, 0] + normal[:, 1] * l_dir[:, 1]
                        + normal[:, 2] * l_dir[:, 2], min=0.0)
    lit = GL_GLOBAL_AMBIENT + light_ambient + light_color * ndotl[:, None]
    return color * torch.clamp(lit, 0.0, 1.0)


def pixel_epilogue_plain(t_tri, attr, t_ent, col_ent, n_ent, atlas, cam: Camera,
                         light_pos, light_color, light_ambient, sky, k_terms: int,
                         has_gain: bool = False, ss: int = 1, tex_map=None):
    """Plain version of the pixel_epilogue kernel (render_rgbd after the
    hit passes): uv from the winner's affine map, Fourier texel with
    footprint AA, the entity merge (t_ent may be None: no analytic
    entities), lighting, sky, truncating u8 pack.

    t_tri (B, HW) f32, attr (B, HW, 16) bf16 or f32 (the carry dtype);
    t_ent (B, HW), col_ent / n_ent (B, HW, 3); atlas (A, 4+8K); lights
    and sky (B, 3); HW the camera's W x H samples. With ``tex_map`` (B,
    T) int, nearest mode (raycast.py:1274-1275): atlas is the (N, R, R,
    3) u8 atlas and the texel is ``eval_nearest``'s, with no footprint;
    k_terms and has_gain are not read. ``ss`` = 2 (supersample=2,
    raycast.py:1294-1301): each output pixel is the mean of its 2x2
    samples' shaded colours, summed in row-major order, ((s00 + s01) +
    s10) + s11, as XLA reduces the JAX package's mean and the kernel
    sums, times 0.25, before the pack; its depth the top-left sample's.
    Returns (rgb (B, H/ss, W/ss, 3) u8, depth (B, H/ss, W/ss, 1) f32).
    Runs over blocks of envs: in fourier mode each pixel gathers its
    atlas row of 4+8K floats.
    """
    b, hw = t_tri.shape
    h, w = cam.height, cam.width
    if ss not in (1, 2) or h % ss or w % ss:
        raise ValueError(f"ss={ss} must be 1 or 2 and divide the {w}x{h} samples")
    outs = []
    for sl in _env_blocks(b, hw * (atlas.shape[1] if tex_map is None else ATTR_DIM)):
        def rows(x):
            return None if x is None else x[sl]

        rgb, depth = _pixel_epilogue_block(
            t_tri[sl], attr[sl], rows(t_ent), rows(col_ent), rows(n_ent), atlas,
            _cam_rows(cam, sl), light_pos[sl], light_color[sl], light_ambient[sl], sky[sl],
            k_terms, has_gain, rows(tex_map))
        n = rgb.shape[0]
        if ss == 2:
            q = rgb.reshape(n, h // 2, 2, w // 2, 2, 3)
            rgb = (((q[:, :, 0, :, 0] + q[:, :, 0, :, 1]) + q[:, :, 1, :, 0])
                   + q[:, :, 1, :, 1]) * 0.25
            depth = depth[:, ::2, ::2]
        rgb_u8 = torch.clamp(rgb * 255.0, 0.0, 255.0).to(torch.uint8)
        outs.append((rgb_u8, depth.contiguous()))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _pixel_epilogue_block(t_tri, attr, t_ent, col_ent, n_ent, atlas, cam: Camera,
                          light_pos, light_color, light_ambient, sky, k_terms: int,
                          has_gain: bool, tex_map=None):
    b, hw = t_tri.shape
    h, w = cam.height, cam.width
    xv, yv = cam.xv().reshape(-1), cam.yv().reshape(-1)

    def per_px(v):  # (B, 3) -> (B*HW, 3)
        return v[:, None, :].expand(b, hw, 3).reshape(-1, 3)

    fwd, right, up, origin = (per_px(cam.fwd), per_px(cam.right), per_px(cam.up),
                              per_px(cam.origin))
    dirs = fwd + xv[:, None] * right + yv[:, None] * up
    at = attr.reshape(-1, ATTR_DIM).to(torch.float32)
    tt = t_tri.reshape(-1)
    t_uv = torch.where(torch.isfinite(tt), tt, torch.zeros_like(tt))
    p = origin + t_uv[:, None] * dirs
    uv = torch.stack([
        at[:, 0] * p[:, 0] + at[:, 1] * p[:, 1] + at[:, 2] * p[:, 2] + at[:, 6],
        at[:, 3] * p[:, 0] + at[:, 4] * p[:, 1] + at[:, 5] * p[:, 2] + at[:, 7],
    ], dim=1)
    if tex_map is None:
        pix_angle = (cam.tan_y * (2.0 / h))[:, None].expand(b, hw).reshape(-1)
        sq = at[:, 0] * at[:, 0]
        for i in range(1, 6):
            sq = sq + at[:, i] * at[:, i]
        footprint = t_uv * pix_angle * geom.sqrt(sq * 0.5)
        texel = eval_fourier(atlas, at[:, _SLOT], uv, k_terms, footprint, has_gain)
    else:
        texel = eval_nearest(atlas, tex_map, at[:, _SLOT].reshape(b, hw),
                             uv.reshape(b, hw, 2)).reshape(-1, 3)
    color = at[:, _COL] * texel
    normal = at[:, _NRM]
    t_hit = tt
    if t_ent is not None:
        te = t_ent.reshape(-1)
        ent_wins = te < tt
        t_hit = torch.where(ent_wins, te, tt)
        color = torch.where(ent_wins[:, None], col_ent.reshape(-1, 3), color)
        normal = torch.where(ent_wins[:, None], n_ent.reshape(-1, 3), normal)
    hit = torch.isfinite(t_hit)
    t_safe = torch.where(hit, t_hit, torch.full_like(t_hit, FAR))
    hit_p = origin + t_safe[:, None] * dirs
    shaded = shade(color, normal, hit_p, per_px(light_pos), per_px(light_color),
                   per_px(light_ambient))
    rgb = torch.where(hit[:, None], shaded, per_px(sky))
    return rgb.reshape(b, h, w, 3), t_safe.reshape(b, h, w, 1)


def pixel_epilogue(t_tri, attr, t_ent, col_ent, n_ent, atlas, cam: Camera,
                   light_pos, light_color, light_ambient, sky, k_terms: int,
                   has_gain: bool = False, table=None, ss: int = 1, tex_map=None):
    """Stage 3 wrapper: the pixel_epilogue kernel for CUDA tensors, the
    plain version for CPU tensors. Same contract as
    ``pixel_epilogue_plain`` (``ss`` = 2: the kernel's SS = 2 instance;
    ``has_gain``: its GAIN instances, the glyph branch of
    ``eval_fourier``, counted in ``LAUNCHES["pixel_epilogue_gain"]``
    too; ``tex_map``: nearest mode, its NEAREST instances, counted in
    ``LAUNCHES["pixel_epilogue_nearest"]``, which read the u8 atlas and
    ``tex_map``; a float32 attribute carry, in either mode, launches the
    F32 instances, counted in ``LAUNCHES["pixel_epilogue_f32"]`` too).
    In fourier mode the kernel reads ``table``, the atlas's
    ``fourier_table`` (made here when not given: a caller that renders
    often makes it once)."""
    args = (t_tri, attr, t_ent, col_ent, n_ent, atlas, cam, light_pos,
            light_color, light_ambient, sky, k_terms, has_gain, ss, tex_map)
    nearest = tex_map is not None
    if not is_cuda(t_tri, attr, atlas, cam.origin, light_pos, *((tex_map,) if nearest else ())):
        return pixel_epilogue_plain(*args)
    b, hw = t_tri.shape
    h, w = cam.height, cam.width
    if ss not in (1, 2) or h % ss or w % ss:
        raise ValueError(f"ss={ss} must be 1 or 2 and divide the {w}x{h} samples")
    f32 = attr.dtype == torch.float32
    if nearest:
        if has_gain:
            raise ValueError("the glyph branch is fourier-only (raycast.py:1257-1273)")
        n_rows, res = atlas.shape[0], atlas.shape[1]
        n_ids = tex_map.shape[1]
        atlas_ptr = check(atlas, "atlas", torch.uint8, (n_rows, res, res, 3))
        tex_ptr = check(tex_map, "tex_map", torch.int32, (b, n_ids))
        table_ptr = ctypes.c_void_p(0)
    else:
        n_rows, width = atlas.shape
        if width != 4 + 8 * k_terms:
            raise ValueError(f"atlas rows hold {width} floats, expected 4+8K with K={k_terms}")
        if table is None:
            table = fourier_table(atlas, k_terms)
        table_ptr = check(table, "table", torch.float32, (n_rows, fourier_row_floats(k_terms)))
        atlas_ptr = tex_ptr = ctypes.c_void_p(0)
        res = n_ids = 0
    dev = t_tri.device
    ho, wo = h // ss, w // ss
    rgb = torch.empty((b, ho, wo, 3), dtype=torch.uint8, device=dev)
    depth = torch.empty((b, ho, wo, 1), dtype=torch.float32, device=dev)
    has_ent = t_ent is not None
    if has_ent:
        ent_ptrs = (
            check(t_ent, "t_ent", torch.float32, (b, hw)),
            check(col_ent, "col_ent", torch.float32, (b, hw, 3)),
            check(n_ent, "n_ent", torch.float32, (b, hw, 3)),
        )
    else:
        ent_ptrs = (ctypes.c_void_p(0),) * 3
    lights = torch.stack([light_pos, light_color, light_ambient, sky], dim=1).contiguous()
    cam_ptrs, _cam_tensors = _cam_args(cam, b)
    launch(
        "mw_pixel_epilogue",
        ("pixel_epilogue",) + (("pixel_epilogue_ss2",) if ss == 2 else ())
        + (("pixel_epilogue_gain",) if has_gain else ())
        + (("pixel_epilogue_nearest",) if nearest else ())
        + (("pixel_epilogue_f32",) if f32 else ()),
        check(t_tri, "t_tri", torch.float32, (b, hw)),
        check(attr, "attr", attr.dtype if f32 else torch.bfloat16, (b, hw, ATTR_DIM)),
        *ent_ptrs,
        table_ptr, atlas_ptr, tex_ptr,
        check(lights, "lights", torch.float32, (b, 4, 3)),
        *cam_ptrs,
        ctypes.c_int(b), ctypes.c_int(w), ctypes.c_int(h),
        ctypes.c_int(n_rows), ctypes.c_int(k_terms), ctypes.c_int(int(has_ent)),
        ctypes.c_int(ss), ctypes.c_int(int(has_gain)), ctypes.c_int(int(nearest)),
        ctypes.c_int(int(f32)), ctypes.c_int(n_ids), ctypes.c_int(res),
        check(rgb, "rgb", torch.uint8, (b, ho, wo, 3)),
        check(depth, "depth", torch.float32, (b, ho, wo, 1)),
        stream(),
    )
    return rgb, depth


# ---------------------------------------------------------------------------
# the render


def chunk_schedule(bank, layout_id, origin, plan):
    """(B, n) i32: the chunk rows each env scans, in order, as rows
    ``layout * NC + c`` of the chunk-row view (``static_rows``), chunk c
    starting at row c * k of the layout's bank (raycast.py:133-145,
    1166-1172). ``plan`` (vector.plan_chunks) picks them:

    - "packed_pvs": chunks ``min(base + j, NC - 1)`` for j < sched_len,
      ``base = pvs_room_base[layout, room]`` of the camera's room. The
      clamp keeps the read inside the layout, as the JAX package's
      ``dynamic_slice`` read does; its one-hot read (raycast.py:234-250,
      without domain randomization) runs on into the next layout's first
      chunk where base + j >= NC, a fault of the reference (ROADMAP).
    - "chunk_vis": the sorted chunks visible from the camera's room,
      ``sort(where(vis, arange(NC), NC))[:sched_len]``, the sentinel NC a
      repeat of chunk NC - 1 (the clamped ``dynamic_slice``).
    - "dense": every chunk in order (a dense scan seeded by mesh rows).

    A repeated chunk never replaces its first reading (equal keys, a
    later position)."""
    kind, nc = plan["kind"], plan["nc"]
    lid = layout_id.long()
    b, dev = lid.shape[0], lid.device
    if kind == "dense":
        chunk = torch.arange(nc, device=dev).expand(b, nc)
    else:
        room = room_of_point(bank, layout_id, origin[:, [0, 2]])
        n = plan["sched_len"]
        if kind == "packed_pvs":
            chunk = bank.pvs_room_base[lid, room].long()[:, None] + torch.arange(n, device=dev)
        else:
            vis = plan["chunk_vis"][lid, :, room]  # (B, NC)
            keys = torch.where(vis, torch.arange(nc, device=dev), torch.full_like(lid[:, None], nc))
            chunk = torch.sort(keys, dim=1).values[:, :n]
    return (lid[:, None] * nc + torch.clamp(chunk, max=nc - 1)).to(torch.int32)


def static_rows(bank, state, cam: Camera, pg_wall=None, plan=None):
    """What stage 1 scans for each env: ((verts9, attr, layout_id),
    paired), the arguments of ``tri_pass``. The layout bank's rows; a
    procgen maze's paired rows with ``paired`` = (verts9_alt, attr_alt,
    pg_wall, wall_open); or, where ``plan`` (vector.plan_chunks) gives a
    schedule, the bank's chunk rows ``bank.pvs_v9_rows`` /
    ``pvs_attr_rows`` (vector.install_statics: the packed visible sets
    for "packed_pvs", raycast.py:1166-1176, 1207-1214; the layout bank's
    chunks for "chunk_vis" and for a dense plan of several chunks with
    mesh entities) as (C, 9, k) and (C, k, 16), with the (B, n)
    ``chunk_schedule`` in place of layout_id. A schedule of one chunk
    (the 8x8 Maze's layout bank at 80x60) is passed as its (B,) column:
    one chunk, scanned by the single-chunk launch."""
    if plan is not None and bank.pvs_v9_rows is not None:
        n_rows = bank.pvs_v9_rows.shape[0]
        v9r = bank.pvs_v9_rows.view(n_rows, 9, -1)
        atr = bank.pvs_attr_rows.view(n_rows, -1, ATTR_DIM)
        sched = chunk_schedule(bank, state.layout_id, cam.origin, plan)
        return (v9r, atr, sched if sched.shape[1] > 1 else sched[:, 0].contiguous()), None
    if pg_wall is None:
        return (bank.tri_verts9, bank.tri_attr, state.layout_id), None
    return ((bank.pg_verts9, bank.pg_attr, state.layout_id),
            (bank.pg_verts9_alt, bank.pg_attr_alt, pg_wall, state.wall_open))


def render_rgbd(bank, state, atlas, *, width: int, height: int, k_terms: int,
                shapes_present=(True, True, False), all_quads: bool = False,
                has_gain: bool = False, use_kernels: bool = True, pg_wall=None,
                table=None, plan=None, slot_tex=None, supersample: int = 1,
                tex_mode: str = "fourier", row_code=None):
    """Render every env's observation: (rgb (B, H, W, 3) u8, depth
    (B, H, W, 1) f32, FAR for sky). Counterpart of raycast.render_rgbd:
    the static prims in the chunk plan ``plan`` (vector.plan_chunks; None:
    one chunk of all of them): a dense plan in chunks of its
    ``tri_chunk``, the last clamped (``chunk_starts``), and a schedule of
    chunks per env (``static_rows``, ``chunk_schedule``) for packed PVS,
    ``chunk_vis`` and a dense plan of several chunks with mesh entities.
    ``tex_mode``: "fourier" (``atlas`` the Fourier table, the slot
    columns atlas rows) or "nearest" (``atlas`` the (N, R, R, 3) u8
    atlas, the slot columns layout-local slot ids that the epilogue
    resolves through ``state.tex_map``: ``eval_nearest``). The hit
    passes carry the winner's attributes in ``attr_carry_dtype`` of the
    atlas's rows (fourier) or of the slot ids (nearest).
    ``table``: the atlas's ``fourier_table``, which the epilogue kernel
    reads.
    ``slot_tex`` = (tex, tex_alt) (vector.install_statics with
    domain_rand in fourier mode): each scanned row's texture variant under
    ``state.tri_slots`` goes into its slot column (``tri_pass``'s
    ``override``; raycast.py:1190-1232); None: the slot columns hold
    their atlas bases already.
    ``supersample`` = 2: the hit passes run on a 2W x 2H grid of samples
    and the epilogue box-filters each pixel's 2x2 shaded samples, depth
    from the top-left one (raycast.py:1143-1160, 1294-1301).

    With mesh entities (``shapes_present[2]``) their pass runs first and
    seeds the static prims' z-competition (raycast.py:1174-1182), in
    the tri_pass launch.
    ``pg_wall`` ((L, Sp) i32, vector.install_statics) marks a procgen
    maze (raycast.py:1206-1219): the static prims are the paired super
    bank's rows (``bank.pg_*``), each env seeing its own maze through
    ``state.wall_open``. ``row_code`` ((L, S) i32, ``wall_codes``) marks
    a procgen super bank without paired rows: its dense rows, each env's
    killed by its maze (tri_pass's ``active``; raycast.py:1220-1227).
    ``use_kernels=False`` runs the plain PyTorch versions of the stages
    on whatever device the tensors are on (for comparisons on the card);
    otherwise each stage goes through its wrapper.
    """
    if tex_mode not in ("fourier", "nearest"):
        raise ValueError(f"tex_mode {tex_mode!r}")
    nearest = tex_mode == "nearest"
    if nearest and (slot_tex is not None or has_gain):
        raise ValueError("nearest mode has no texture-variant override and no glyph branch")
    ss = int(supersample)
    cam = camera_grid(state, width * ss, height * ss)
    f_ent = entity_pass if use_kernels else entity_pass_plain
    carry = attr_carry_dtype(state.tex_map.shape[1] if nearest else atlas.shape[0])
    mesh = (entity_mesh_rows(bank, state, not nearest, use_kernels)[:2] if shapes_present[2]
            else None)
    rows, paired = static_rows(bank, state, cam, pg_wall, plan)
    override = None if slot_tex is None else (state.tri_slots, *slot_tex)
    tri_chunk = None if plan is None else plan["tri_chunk"]
    active = None if row_code is None else (row_code, state.wall_open)
    if use_kernels:
        t_tri, attr = tri_pass(*rows, cam, all_quads, mesh, paired, tri_chunk, override, carry,
                               active)
    elif rows[2].dim() == 1 and tri_chunk is not None and rows[0].shape[2] > tri_chunk:
        t_tri, attr = tri_pass_chunked(*rows, cam, tri_chunk, all_quads, override, paired,
                                       carry, active)
    else:
        seed = None if mesh is None else entity_mesh_pass_plain(*mesh, cam, carry)
        if rows[2].dim() == 2:
            t_tri, attr = tri_pass_scheduled(*rows, cam, all_quads, seed, override, carry)
        else:
            t_tri, attr = tri_pass_plain(*rows, cam, all_quads, seed, paired, override, carry,
                                         active)
    t_ent = col_ent = n_ent = None
    if shapes_present[0] or shapes_present[1]:
        t_ent, col_ent, n_ent = f_ent(
            state.ent_pos, state.ent_size, state.ent_dir, state.ent_height,
            state.ent_color, entity_flags(bank, state), cam,
            shapes_present[0], shapes_present[1],
        )
    epi_args = (t_tri, attr, t_ent, col_ent, n_ent, atlas, cam, state.light_pos,
                state.light_color, state.light_ambient, state.sky_color, k_terms, has_gain)
    tex_map = state.tex_map if nearest else None
    if use_kernels:
        return pixel_epilogue(*epi_args, table=table, ss=ss, tex_map=tex_map)
    return pixel_epilogue_plain(*epi_args, ss=ss, tex_map=tex_map)

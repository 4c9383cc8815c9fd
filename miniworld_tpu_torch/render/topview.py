"""Orthographic top view of the PyTorch port (``view="top"``).

Counterpart of ``miniworld_tpu/render/topview.py`` (the reference's
``render_top_view``, miniworld/miniworld.py:1171-1258): an aspect-fit
orthographic camera at height 10 looks straight down at the floorplan,
with parallel rays d = (0, -1, 0) from per-pixel origins, and the agent
is drawn as a red triangle. Two stages, each a hand-written CUDA kernel
for Hopper (``miniworld_tpu_torch/csrc``) with its plain PyTorch version
beside it in this module:

  1. ``tri_pass_ortho``: the static prims' hit test under the ortho
     rays, nearest t, ties to the first row (``_tri_pass_ortho``); on a
     procgen super bank each env's rows killed by its maze (the dense
     ``tri_active``). It writes t and the winner's bank row; the
     epilogue reads the float32 row from the bank, which is what the JAX
     package's one-hot product selects.
  2. ``topview_epilogue``: the entities' footprints (``_entity_pass_ortho``,
     fused into the kernel), uv, the texel (the Fourier table with no
     footprint, or the nearest texel through ``tex_map``), lighting, sky,
     the agent marker, the u8 pack and the depth.

The ortho camera is the same for every env of a layout, and vertical
prims have det = 0 exactly under d = (0, -1, 0), so ``top_statics``
stages once per layout, on the host, what the scan reads: the pixel
grid, each upward-facing row's coefficients, and for each 8x8 pixel
tile the rows that may cover it (``tile_rows``: a conservative bounding
box test, ascending row order). The kernel scans a tile's list; the
plain version scans every staged row.

Each wrapper takes the plain version ONLY for tensors on the CPU; for
CUDA tensors it launches its kernel (and adds one to its count in
``cuda_build.LAUNCHES``) or raises. Arithmetic follows the JAX
expressions operation by operation (the kernels are built with
``-fmad=false``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from miniworld_tpu_torch.ops import geom
from miniworld_tpu_torch.render.cuda_build import check, is_cuda, launch, stream
from miniworld_tpu_torch.render.raycast import (
    _COL, _NRM, _SLOT, ATTR_DIM, FAR, _env_blocks, eval_fourier, eval_nearest, fourier_table,
    fourier_row_floats, row_live, shade, wall_codes,
)
from miniworld_tpu_torch.scene.entities import SHAPE_SPHERE

TOP_CAM_HEIGHT = 10.0  # above any wall; ortho, so the value only offsets t
# A staged row (``ortho_rows``): d x e2 and its offset v0 . (d x e2), e1 x
# d and its offset, n = e1 x e2 and its offset, 1/det, 1/(n . d), kind, 0
ORTHO_FIELDS = 16
# The kernel's pixel tile (csrc/tri_pass_ortho.cu TILE_W, TILE_H)
TILE_W, TILE_H = 8, 8
# Margin of the tile lists' bounding boxes, per unit of the layout's
# largest coordinate: far above float32 rounding of the hit test
# (2^-24 relative), far below a pixel of any ported floorplan.
_TILE_MARGIN_REL = 1e-3
# ortho entity flags: alive, not static and shape != 0; a sphere
ORTHO_ACTIVE, ORTHO_SPHERE = 1, 2
# entity slots the epilogue kernel stages (csrc/topview_epilogue.cu MAX_ENTS)
MAX_ENTS = 64


class TopStatics(NamedTuple):
    """What the top view's stages read, per layout (``top_statics``)."""

    xs: torch.Tensor  # (L, W) f32 world x of each pixel column's centre
    zs: torch.Tensor  # (L, H) f32 world z of each pixel row's centre
    rows: torch.Tensor  # (L, Sc, ORTHO_FIELDS) f32 staged rows, ascending bank order
    row_id: torch.Tensor  # (L, Sc) i32 bank row of each staged row, -1 padding
    row_code: torch.Tensor  # (L, Sc) i32 maze kill: -1 none, 2w live iff wall w open, 2w+1 iff closed
    tile_off: torch.Tensor  # (L, T + 1) i32 offsets of each tile's list in tile_rows
    tile_rows: torch.Tensor  # (N,) i32 staged rows of each (layout, tile), ascending

    @property
    def width(self) -> int:
        return self.xs.shape[1]

    @property
    def height(self) -> int:
        return self.zs.shape[1]


def ortho_grid(extents: torch.Tensor, width: int, height: int):
    """Pixel centres of every layout's ortho view (topview.py:45-70),
    extents (L, 4) f32 (min_x, max_x, min_z, max_z) -> (xs (L, W), zs (L,
    H)): a 1-unit margin, the extents fitted to the image aspect, image
    +x = world +x and image rows down = world +z. The JAX package's
    divisions by constants run as XLA compiles them, as products with
    the float32 reciprocal (``/ width``, ``/ aspect``)."""
    e = extents.to(torch.float32)
    min_x, max_x = e[:, 0] - 1.0, e[:, 1] + 1.0
    min_z, max_z = e[:, 2] - 1.0, e[:, 3] + 1.0
    width_x, width_z = max_x - min_x, max_z - min_z
    aspect = np.float32(width / height)
    fit_x = torch.maximum(width_x, width_z * float(aspect))
    fit_z = fit_x * float(np.float32(1.0) / aspect)
    cx, cz = (min_x + max_x) * 0.5, (min_z + max_z) * 0.5
    ax = (torch.arange(width, dtype=torch.float32, device=e.device) + 0.5) * (1.0 / width)
    az = (torch.arange(height, dtype=torch.float32, device=e.device) + 0.5) * (1.0 / height)
    xs = cx[:, None] + ax[None, :] * fit_x[:, None] - fit_x[:, None] * 0.5
    zs = cz[:, None] + az[None, :] * fit_z[:, None] - fit_z[:, None] * 0.5
    return xs.contiguous(), zs.contiguous()


def ortho_grid_single(extents: torch.Tensor, width: int, height: int):
    """``ortho_grid`` as XLA compiles the JAX package's single-env top
    view (its gymnasium adapter's jitted ``render_top_view``), where the
    image's divisions fold into the scalar factors first: xs = cx + (i +
    0.5) * (fit_x * f32(1 / width)) - fit_x * 0.5, and with r =
    f32(1 / aspect), zs = cz + (j + 0.5) * (fit_x * f32(r * f32(1 /
    height))) - fit_x * f32(r * 0.5). Same arguments and results as
    ``ortho_grid``; a pixel centre on a prim's edge can round to the
    other side of it in the other grid."""
    e = extents.to(torch.float32)
    min_x, max_x = e[:, 0] - 1.0, e[:, 1] + 1.0
    min_z, max_z = e[:, 2] - 1.0, e[:, 3] + 1.0
    width_x, width_z = max_x - min_x, max_z - min_z
    aspect = np.float32(width / height)
    r = np.float32(np.float32(1.0) / aspect)
    fit_x = torch.maximum(width_x, width_z * float(aspect))[:, None]
    cx, cz = (min_x + max_x) * 0.5, (min_z + max_z) * 0.5
    ax = torch.arange(width, dtype=torch.float32, device=e.device) + 0.5
    az = torch.arange(height, dtype=torch.float32, device=e.device) + 0.5
    xs = cx[:, None] + ax[None, :] * (fit_x * float(np.float32(1.0 / width))) - fit_x * 0.5
    zs = (cz[:, None] + az[None, :] * (fit_x * float(np.float32(r * np.float32(1.0 / height))))
          - fit_x * float(np.float32(r * np.float32(0.5))))
    return xs.contiguous(), zs.contiguous()


def ortho_rows(tri_verts: torch.Tensor, kind: torch.Tensor):
    """The per-row constants of ``_tri_pass_ortho`` (topview.py:188-204)
    under d = (0, -1, 0): tri_verts (..., 3, 3) f32, kind (...) ->
    (rows (..., ORTHO_FIELDS), det (...)). Cross products in jnp.cross's
    order, the K=3 dots with d and v0 left to right."""
    v0 = tri_verts[..., 0, :]
    e1 = tri_verts[..., 1, :] - v0
    e2 = tri_verts[..., 2, :] - v0
    d = torch.tensor([0.0, -1.0, 0.0], dtype=torch.float32, device=tri_verts.device)
    d = d.expand(e2.shape)

    def dot(a, b):
        return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]

    det = dot(geom.cross(e2, e1), d)
    dxe2 = geom.cross(d, e2)
    e1xd = geom.cross(e1, d)
    n_tri = geom.cross(e1, e2)
    denom = dot(n_tri, d)
    one = torch.ones_like(det)
    inv_det = 1.0 / torch.where(det.abs() > 1e-12, det, one)
    inv_den = 1.0 / torch.where(denom.abs() > 1e-12, denom, one)
    rows = torch.cat([dxe2, dot(v0, dxe2)[..., None], e1xd, dot(v0, e1xd)[..., None],
                      n_tri, dot(v0, n_tri)[..., None], inv_det[..., None], inv_den[..., None],
                      kind[..., None], torch.zeros_like(kind)[..., None]], dim=-1)
    return rows, det


def top_statics(bank, width: int, height: int, device=None,
                tile: tuple = (TILE_W, TILE_H), grid=None) -> TopStatics:
    """The top view's per-layout statics of ``bank`` (the port's Layout)
    at width x height, on ``device`` (the bank's by default). Built on
    the CPU: the staged rows of every masked row with det > 1e-12 (the
    others never hit), and per pixel tile (the kernel's TILE_W x TILE_H,
    or ``tile`` for a build with other ones) the staged rows whose
    bounding box in x-z, grown by ``_TILE_MARGIN_REL`` of the layout's
    largest coordinate, meets the tile's pixel centres. ``grid`` = (xs
    (L, W), zs (L, H)) f32: the pixel centres, ``ortho_grid`` of the
    bank's extents when None."""
    device = bank.tri_mask.device if device is None else device
    tile_w, tile_h = tile
    verts = bank.tri_verts.cpu().to(torch.float32)  # (L, S, 3, 3)
    kind = bank.tri_attr[..., 15].cpu().to(torch.float32)
    rows, det = ortho_rows(verts, kind)
    code = wall_codes(bank)
    keep = bank.tri_mask.cpu() & (det > 1e-12) & (code != -2)
    xs, zs = (ortho_grid(bank.extents.cpu(), width, height) if grid is None
              else (grid[0].cpu().to(torch.float32), grid[1].cpu().to(torch.float32)))
    L = verts.shape[0]
    sc = max(int(keep.sum(dim=1).max()), 1)
    st_rows = torch.zeros((L, sc, ORTHO_FIELDS), dtype=torch.float32)
    st_id = torch.full((L, sc), -1, dtype=torch.int32)
    st_code = torch.full((L, sc), -2, dtype=torch.int32)
    n_tx, n_ty = -(-width // tile_w), -(-height // tile_h)
    tile_off = torch.zeros((L, n_tx * n_ty + 1), dtype=torch.int32)
    lists = []
    pos = 0
    for li in range(L):
        tile_off[li, 0] = pos
        ids = torch.nonzero(keep[li])[:, 0]
        n = ids.shape[0]
        st_rows[li, :n], st_id[li, :n], st_code[li, :n] = rows[li, ids], ids.int(), code[li, ids]
        v = verts[li, ids].double()  # (n, 3, 3)
        corners = [v[:, 0], v[:, 1], v[:, 2]]
        quad = kind[li, ids] == 0.0  # parallelograms: v0 + e1 + e2 too
        corners.append(torch.where(quad[:, None], v[:, 1] + v[:, 2] - v[:, 0], v[:, 0]))
        cx = torch.stack([c[:, 0] for c in corners], 1)
        cz = torch.stack([c[:, 2] for c in corners], 1)
        scale = max(float(bank.extents[li].abs().max()), float(v.abs().max()) if n else 0.0)
        m = _TILE_MARGIN_REL * (1.0 + scale)
        lo_x, hi_x = cx.amin(1) - m, cx.amax(1) + m
        lo_z, hi_z = cz.amin(1) - m, cz.amax(1) + m
        gx, gz = xs[li].double(), zs[li].double()
        for ty in range(n_ty):
            z0, z1 = gz[ty * tile_h], gz[min(height, (ty + 1) * tile_h) - 1]
            for tx in range(n_tx):
                x0, x1 = gx[tx * tile_w], gx[min(width, (tx + 1) * tile_w) - 1]
                sel = torch.nonzero((lo_x <= x1) & (hi_x >= x0) & (lo_z <= z1)
                                    & (hi_z >= z0))[:, 0]
                lists.append(sel.int())
                pos += sel.shape[0]
                tile_off[li, ty * n_tx + tx + 1] = pos
    # a trailing pad keeps the kernel's pointer valid when every list is empty
    tile_rows = torch.cat(lists + [torch.zeros(1, dtype=torch.int32)])
    return TopStatics(*(t.to(device).contiguous() for t in (
        xs, zs, st_rows, st_id, st_code, tile_off, tile_rows)))


def _pixel_coords(st: TopStatics, lid: torch.Tensor):
    """(px, pz), each (B, HW): the ortho origins' x and z of every pixel
    of the envs of layouts ``lid`` (pixel p = y * W + x)."""
    w, h = st.width, st.height
    px = st.xs[lid][:, None, :].expand(-1, h, w).reshape(lid.shape[0], h * w)
    pz = st.zs[lid][:, :, None].expand(-1, h, w).reshape(lid.shape[0], h * w)
    return px, pz


# ---------------------------------------------------------------------------
# stage 1: the ortho scan


def ortho_row_t(st: TopStatics, layout_id, wall_open=None):
    """(B, HW, Sc) f32: t of every staged row at every pixel of each env,
    inf where the row misses the pixel (topview.py:205-221): u = u_num /
    det, v likewise, coverage max(u, v) + kind min(u, v) <= 1, 0 < t <
    FAR, the row live in the env's maze (``row_live``). layout_id (B,),
    wall_open (B, NW) f32 or None."""
    lid = layout_id.long()
    px, pz = (c[:, :, None] for c in _pixel_coords(st, lid))  # (B, HW, 1)
    r = st.rows[lid][:, None, :, :]  # (B, 1, Sc, F)

    def dot(i):  # origins . (r_i, r_i+1, r_i+2), left to right
        return (px * r[..., i] + TOP_CAM_HEIGHT * r[..., i + 1]) + pz * r[..., i + 2]

    u_num = dot(0) - r[..., 3]
    v_num = dot(4) - r[..., 7]
    t_num = r[..., 11] - dot(8)
    t = t_num * r[..., 13]
    u, v = u_num * r[..., 12], v_num * r[..., 12]
    cov = torch.maximum(u, v) + r[..., 14] * torch.minimum(u, v)
    live = row_live(st.row_code[lid], wall_open)
    hit = (u >= 0.0) & (v >= 0.0) & (cov <= 1.0) & (t > 0.0) & (t < FAR) & live[:, None, :]
    return torch.where(hit, t, torch.full_like(t, math.inf))


def tri_pass_ortho_plain(st: TopStatics, layout_id, wall_open=None):
    """Plain version of the tri_pass_ortho kernel (topview._tri_pass_ortho):
    every staged row of each env's layout at every pixel (``ortho_row_t``),
    the smallest t, ties to the first row in bank order. JAX's scan picks
    the same row: chunks of min(128, S) take their first index at the
    minimum (argmin) and a later chunk replaces the carry only where
    strictly nearer, and its clamped last chunk re-reads only rows of the
    chunk before it.

    layout_id (B,) int32, wall_open (B, NW) f32 or None -> (t (B, HW) f32,
    inf where nothing is hit; row (B, HW) i32, the winner's bank row, -1
    where nothing is hit). Runs over blocks of envs."""
    b, sc = layout_id.shape[0], st.rows.shape[1]
    ts, rows_out = [], []
    for sl in _env_blocks(b, sc * st.width * st.height):
        t = ortho_row_t(st, layout_id[sl], None if wall_open is None else wall_open[sl])
        t_min, win = torch.min(t, dim=2)  # the first index at the minimum
        row = torch.gather(st.row_id[layout_id[sl].long()], 1, win)
        ts.append(t_min)
        rows_out.append(torch.where(torch.isfinite(t_min), row, torch.full_like(row, -1)))
    return torch.cat(ts), torch.cat(rows_out)


def tri_pass_ortho(st: TopStatics, layout_id, wall_open=None):
    """Stage 1 wrapper: the tri_pass_ortho kernel for CUDA tensors, the
    plain version for CPU tensors. Same contract as
    ``tri_pass_ortho_plain``; the kernel scans each 8x8 tile's list
    (``st.tile_rows``), which holds every row that can hit the tile."""
    if not is_cuda(layout_id, st.rows, *(() if wall_open is None else (wall_open,))):
        return tri_pass_ortho_plain(st, layout_id, wall_open)
    L, sc = st.row_id.shape
    b, w, h = layout_id.shape[0], st.width, st.height
    n_tiles = st.tile_off.shape[1] - 1
    nw = 0 if wall_open is None else wall_open.shape[1]
    t = torch.empty((b, h * w), dtype=torch.float32, device=layout_id.device)
    row = torch.empty((b, h * w), dtype=torch.int32, device=layout_id.device)
    launch(
        "mw_tri_pass_ortho", "tri_pass_ortho",
        check(st.rows, "rows", torch.float32, (L, sc, ORTHO_FIELDS)),
        check(st.row_id, "row_id", torch.int32, (L, sc)),
        check(st.row_code, "row_code", torch.int32, (L, sc)),
        check(st.tile_off, "tile_off", torch.int32, (L, n_tiles + 1)),
        check(st.tile_rows, "tile_rows", torch.int32, tuple(st.tile_rows.shape)),
        check(st.xs, "xs", torch.float32, (L, w)),
        check(st.zs, "zs", torch.float32, (L, h)),
        check(layout_id, "layout_id", torch.int32, (b,)),
        ctypes.c_void_p(0) if wall_open is None
        else check(wall_open, "wall_open", torch.float32, (b, nw)),
        ctypes.c_int(b), ctypes.c_int(sc), ctypes.c_int(w), ctypes.c_int(h), ctypes.c_int(nw),
        check(t, "t", torch.float32, (b, h * w)),
        check(row, "row", torch.int32, (b, h * w)),
        stream(),
    )
    return t, row


# ---------------------------------------------------------------------------
# stage 2: entity footprints and the epilogue


def ortho_entity_flags(bank, state) -> torch.Tensor:
    """(B, E) uint8: ORTHO_ACTIVE for an alive, non-static entity whose
    shape is not 0 (topview.py:268; a mesh entity shows its box
    footprint), ORTHO_SPHERE for a sphere."""
    lid = state.layout_id.long()[:, None]
    proto = state.ent_proto.long()
    shape = bank.proto_shape[lid, proto]
    active = state.ent_alive & ~bank.proto_static[lid, proto] & (shape != 0)
    return (active.to(torch.uint8) * ORTHO_ACTIVE
            + (shape == SHAPE_SPHERE).to(torch.uint8) * ORTHO_SPHERE).contiguous()


def entity_pass_ortho_plain(px, pz, ent_pos, ent_size, ent_height, ent_color, ent_cs, flags):
    """Plain version of the entity loop the topview_epilogue kernel runs
    (topview._entity_pass_ortho): each active entity's x-z footprint, a
    disc of radius height / 2 for a sphere, its yaw-rotated size[0] x
    size[2] rectangle otherwise, at t = 10 - height; the strictly nearest
    in slot order wins. px, pz (B, HW); per-entity (B, E[, k]) inputs,
    ent_cs (B, E, 2) the cos and sin of ent_dir. Returns (t (B, HW), inf
    on a miss; colour (B, HW, 3); normal (B, HW, 3) = (0, 1, 0)), zeros
    where no entity is hit."""
    b, hw = px.shape
    t_best = torch.full((b, hw), math.inf, dtype=torch.float32, device=px.device)
    col = torch.zeros((b, hw, 3), dtype=torch.float32, device=px.device)
    for e in range(ent_pos.shape[1]):
        active = (flags[:, e:e + 1] & ORTHO_ACTIVE) != 0
        sphere = (flags[:, e:e + 1] & ORTHO_SPHERE) != 0
        dx = px - ent_pos[:, e, 0:1]
        dz = pz - ent_pos[:, e, 2:3]
        height = ent_height[:, e:e + 1]
        r_vis = torch.where(sphere, 0.5 * height, torch.zeros_like(height))
        sph_hit = dx * dx + dz * dz <= r_vis * r_vis
        cd, sd = ent_cs[:, e, 0:1], ent_cs[:, e, 1:2]
        lx = dx * cd - dz * sd
        lz = dx * sd + dz * cd
        box_hit = ((lx.abs() <= ent_size[:, e, 0:1] * 0.5)
                   & (lz.abs() <= ent_size[:, e, 2:3] * 0.5))
        t_e = TOP_CAM_HEIGHT - height
        closer = active & torch.where(sphere, sph_hit, box_hit) & (t_e < t_best)
        t_best = torch.where(closer, t_e.expand(b, hw), t_best)
        col = torch.where(closer[:, :, None], ent_color[:, e, None, :], col)
    hit = torch.isfinite(t_best)[:, :, None]
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=px.device)
    return t_best, col, torch.where(hit, up, torch.zeros_like(col))


def agent_marker(state, agent_radius: float) -> torch.Tensor:
    """(B, 6) f32 x-z vertices of each env's red agent triangle (nose,
    back right, back left; topview.py:127-136), with libm cos / sin on the
    CPU (``geom``): the kernel and the plain version read the same ones."""
    r = float(agent_radius)
    ca, sa = geom.cos(state.dir), geom.sin(state.dir)
    fwd = torch.stack([ca, -sa], dim=1)
    right = torch.stack([sa, ca], dim=1)
    a = torch.stack([state.pos[:, 0], state.pos[:, 2]], dim=1)
    p0 = a + fwd * r
    p1 = a - fwd * r + right * (0.75 * r)
    p2 = a - fwd * r - right * (0.75 * r)
    return torch.cat([p0, p1, p2], dim=1).contiguous()


def _inside_marker(px, pz, marker):
    """(B, HW) bool: pixel inside the env's agent triangle, either
    winding, edges included (topview.py:139-144)."""
    m = marker[:, :, None]

    def edge(a, b):  # (B, HW)
        return ((px - m[:, 2 * a]) * (m[:, 2 * b + 1] - m[:, 2 * a + 1])
                - (pz - m[:, 2 * a + 1]) * (m[:, 2 * b] - m[:, 2 * a]))

    e0, e1, e2 = edge(0, 1), edge(1, 2), edge(2, 0)
    return ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))


def topview_epilogue_plain(t_tri, row, ents, bank_attr, layout_id, st: TopStatics, atlas,
                           lights, marker=None, k_terms: int = 16, has_gain: bool = False,
                           tex_map=None):
    """Plain version of the topview_epilogue kernel (render_top_view after
    the scan, topview.py:88-151): the entity pass
    (``entity_pass_ortho_plain`` on ``ents`` = (ent_pos, ent_size,
    ent_height, ent_color, ent_cs, flags)), the winner's float32 row of
    ``bank_attr`` (L, S, 16), uv at the hit point, the texel (Fourier
    with no footprint from ``atlas``, the (A, 4 + 8K) coefficients; or
    with ``tex_map`` (B, T) the nearest texel of the u8 atlas), an entity
    where strictly nearer, lighting, sky, the marker ((B, 6) or None:
    none drawn), truncating u8 pack. t_tri (B, HW), row (B, HW) i32;
    lights (B, 4, 3) = (pos, colour, ambient, sky). Returns (rgb (B, H,
    W, 3) u8, depth (B, H, W, 1) f32, FAR for sky). Runs over blocks of
    envs."""
    b, hw = t_tri.shape
    w, h = st.width, st.height
    outs = []
    for sl in _env_blocks(b, hw * (atlas.shape[1] if tex_map is None else ATTR_DIM)):
        lid = layout_id[sl].long()
        n = lid.shape[0]
        px, pz = _pixel_coords(st, lid)
        t_ent, col_ent, n_ent = entity_pass_ortho_plain(px, pz, *(x[sl] for x in ents))
        rr = row[sl].long()
        at = bank_attr[lid[:, None], rr.clamp(min=0)]  # (n, HW, 16)
        at = torch.where((rr >= 0)[:, :, None], at, torch.zeros_like(at)).reshape(-1, ATTR_DIM)
        tt = t_tri[sl].reshape(-1)
        pxf, pzf = px.reshape(-1), pz.reshape(-1)
        t_uv = torch.where(torch.isfinite(tt), tt, torch.zeros_like(tt))
        p = torch.stack([pxf + t_uv * 0.0, TOP_CAM_HEIGHT + t_uv * -1.0, pzf + t_uv * 0.0], 1)
        uv = torch.stack([
            at[:, 0] * p[:, 0] + at[:, 1] * p[:, 1] + at[:, 2] * p[:, 2] + at[:, 6],
            at[:, 3] * p[:, 0] + at[:, 4] * p[:, 1] + at[:, 5] * p[:, 2] + at[:, 7],
        ], dim=1)
        if tex_map is None:
            texel = eval_fourier(atlas, at[:, _SLOT], uv, k_terms, None, has_gain)
        else:
            texel = eval_nearest(atlas, tex_map[sl], at[:, _SLOT].reshape(n, hw),
                                 uv.reshape(n, hw, 2)).reshape(-1, 3)
        te = t_ent.reshape(-1)
        ent_wins = te < tt
        t_hit = torch.where(ent_wins, te, tt)
        color = torch.where(ent_wins[:, None], col_ent.reshape(-1, 3), at[:, _COL] * texel)
        normal = torch.where(ent_wins[:, None], n_ent.reshape(-1, 3), at[:, _NRM])
        hit = torch.isfinite(t_hit)
        t_safe = torch.where(hit, t_hit, torch.full_like(t_hit, FAR))
        hit_p = torch.stack([pxf + t_safe * 0.0, TOP_CAM_HEIGHT + t_safe * -1.0,
                             pzf + t_safe * 0.0], 1)
        lt = lights[sl]

        def per_px(i):
            return lt[:, i, None, :].expand(n, hw, 3).reshape(-1, 3)

        shaded = shade(color, normal, hit_p, per_px(0), per_px(1), per_px(2))
        rgb = torch.where(hit[:, None], shaded, per_px(3)).reshape(n, hw, 3)
        if marker is not None:
            red = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=rgb.device)
            rgb = torch.where(_inside_marker(px, pz, marker[sl])[:, :, None], red, rgb)
        rgb_u8 = torch.clamp(rgb * 255.0, 0.0, 255.0).to(torch.uint8).reshape(n, h, w, 3)
        outs.append((rgb_u8, t_safe.reshape(n, h, w, 1)))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def topview_epilogue(t_tri, row, ents, bank_attr, layout_id, st: TopStatics, atlas, lights,
                     marker=None, k_terms: int = 16, has_gain: bool = False, tex_map=None,
                     table=None):
    """Stage 2 wrapper: the topview_epilogue kernel (the entity footprints
    fused in) for CUDA tensors, the plain version for CPU tensors. Same
    contract as ``topview_epilogue_plain``; in fourier mode the kernel
    reads ``table``, the atlas's ``fourier_table`` (made here when not
    given), with a footprint of 0."""
    nearest = tex_map is not None
    if not is_cuda(t_tri, row, bank_attr, atlas, lights, *ents,
                   *((tex_map,) if nearest else ())):
        return topview_epilogue_plain(t_tri, row, ents, bank_attr, layout_id, st, atlas,
                                      lights, marker, k_terms, has_gain, tex_map)
    ent_pos, ent_size, ent_height, ent_color, ent_cs, flags = ents
    b, hw = t_tri.shape
    w, h = st.width, st.height
    L, S = bank_attr.shape[:2]
    E = flags.shape[1]
    if E > MAX_ENTS:
        raise ValueError(f"{E} entity slots: the kernel stages at most {MAX_ENTS}")
    if nearest:
        if has_gain:
            raise ValueError("the glyph branch is fourier-only")
        n_rows, res, n_ids = atlas.shape[0], atlas.shape[1], tex_map.shape[1]
        tex_ptrs = (ctypes.c_void_p(0),
                    check(atlas, "atlas", torch.uint8, (n_rows, res, res, 3)),
                    check(tex_map, "tex_map", torch.int32, (b, n_ids)))
    else:
        n_rows, width = atlas.shape
        if width != 4 + 8 * k_terms:
            raise ValueError(f"atlas rows hold {width} floats, expected 4+8K with K={k_terms}")
        if table is None:
            table = fourier_table(atlas, k_terms)
        tex_ptrs = (check(table, "table", torch.float32, (n_rows, fourier_row_floats(k_terms))),
                    ctypes.c_void_p(0), ctypes.c_void_p(0))
        res = n_ids = 0
    rgb = torch.empty((b, h, w, 3), dtype=torch.uint8, device=t_tri.device)
    depth = torch.empty((b, h, w, 1), dtype=torch.float32, device=t_tri.device)
    launch(
        "mw_topview_epilogue",
        ("topview_epilogue",) + (("topview_epilogue_nearest",) if nearest else ()),
        check(t_tri, "t_tri", torch.float32, (b, hw)),
        check(row, "row", torch.int32, (b, hw)),
        check(bank_attr, "bank_attr", torch.float32, (L, S, ATTR_DIM)),
        check(layout_id, "layout_id", torch.int32, (b,)),
        check(st.xs, "xs", torch.float32, (st.xs.shape[0], w)),
        check(st.zs, "zs", torch.float32, (st.zs.shape[0], h)),
        check(ent_pos, "ent_pos", torch.float32, (b, E, 3)),
        check(ent_size, "ent_size", torch.float32, (b, E, 3)),
        check(ent_height, "ent_height", torch.float32, (b, E)),
        check(ent_color, "ent_color", torch.float32, (b, E, 3)),
        check(ent_cs, "ent_cs", torch.float32, (b, E, 2)),
        check(flags, "flags", torch.uint8, (b, E)),
        *tex_ptrs,
        check(lights, "lights", torch.float32, (b, 4, 3)),
        ctypes.c_void_p(0) if marker is None else check(marker, "marker", torch.float32, (b, 6)),
        ctypes.c_int(b), ctypes.c_int(w), ctypes.c_int(h), ctypes.c_int(S), ctypes.c_int(E),
        ctypes.c_int(n_rows), ctypes.c_int(k_terms), ctypes.c_int(int(has_gain)),
        ctypes.c_int(int(nearest)), ctypes.c_int(n_ids), ctypes.c_int(res),
        check(rgb, "rgb", torch.uint8, (b, h, w, 3)),
        check(depth, "depth", torch.float32, (b, h, w, 1)),
        stream(),
    )
    return rgb, depth


# ---------------------------------------------------------------------------
# the render


def epilogue_inputs(bank, state, agent_radius: float = 0.4, render_agent: bool = True):
    """(ents, lights, marker) of ``topview_epilogue`` for ``state``: the
    entities' (pos, size, height, colour, (cos, sin) of their yaw, ortho
    flags), the (B, 4, 3) light rows and sky, and the agent triangle
    (None without ``render_agent``)."""
    ents = (state.ent_pos, state.ent_size, state.ent_height, state.ent_color,
            torch.stack([geom.cos(state.ent_dir), geom.sin(state.ent_dir)], dim=-1).contiguous(),
            ortho_entity_flags(bank, state))
    lights = torch.stack([state.light_pos, state.light_color, state.light_ambient,
                          state.sky_color], dim=1).contiguous()
    return ents, lights, agent_marker(state, agent_radius) if render_agent else None


def render_top_view(bank, state, atlas, *, width: int, height: int, agent_radius: float = 0.4,
                    render_agent: bool = True, with_depth: bool = True, statics=None,
                    tex_mode: str = "fourier", k_terms: int = 16, table=None,
                    has_gain: bool = False, use_kernels: bool = True):
    """Every env's top view (render_top_view, topview.py:22-151): rgb (B,
    H, W, 3) u8, and with ``with_depth`` (rgb, depth (B, H, W, 1) f32:
    the vertical distance from the camera plane at height 10, FAR for
    sky). ``bank`` is the port's Layout as ``MiniWorldVec`` installs it
    (in fourier mode without domain randomisation the slot columns hold
    atlas rows); ``atlas``: the Fourier coefficients (A, 4+8K), or in
    ``tex_mode="nearest"`` the (N, R, R, 3) u8 atlas, whose slot ids
    resolve through ``state.tex_map``. ``render_agent`` draws the red
    agent triangle of half-length ``agent_radius``. ``statics``: the
    bank's ``top_statics`` at this size (made here when not given);
    ``table``: the atlas's ``fourier_table``, which the epilogue kernel
    reads. On a procgen super bank (``bank.tri_wall_onehot``) each env's
    rows follow ``state.wall_open``. ``use_kernels=False`` runs the
    plain versions on any device."""
    if tex_mode not in ("fourier", "nearest"):
        raise ValueError(f"tex_mode {tex_mode!r}")
    st = top_statics(bank, width, height) if statics is None else statics
    if (st.width, st.height) != (width, height):
        raise ValueError(f"statics are {st.width}x{st.height}, asked for {width}x{height}")
    wall_open = state.wall_open if bank.tri_wall_onehot is not None else None
    f_tri = tri_pass_ortho if use_kernels else tri_pass_ortho_plain
    t_tri, row = f_tri(st, state.layout_id, wall_open)
    ents, lights, marker = epilogue_inputs(bank, state, agent_radius, render_agent)
    tex_map = state.tex_map if tex_mode == "nearest" else None
    args = (t_tri, row, ents, bank.tri_attr, state.layout_id, st, atlas, lights, marker,
            k_terms, has_gain, tex_map)
    if use_kernels:
        rgb, depth = topview_epilogue(*args, table=table)
    else:
        rgb, depth = topview_epilogue_plain(*args)
    return (rgb, depth) if with_depth else rgb

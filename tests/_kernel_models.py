"""Torch models of the redesigned kernels.

``window_select`` copies the multi-chunk tri_pass kernel
(csrc/tri_pass.cu, tri_pass_multi_kernel) step for step: the rows staged
in row order and culled against the image's box, streamed through a
window of ``window`` rows in batches of ``block`` (a batch whose
survivors would overflow the window closes it first), each window's rows
culled against each group of tiles' box and then each tile's, and each
pixel's scan of its tile's rows in row order with a strict > on the
32-bit z-key, carried from one window to the next. ``lane_quad_mean``
copies the SS=2 pixel_epilogue's lanes: 16 samples of two sample rows a
warp, the mean formed at the lane of s00 from three shuffles.
``texel_read_mask`` is where the epilogue reads a sample's attributes and
texel. ``ortho_scan`` copies the top view's tri_pass_ortho kernel
(csrc/tri_pass_ortho.cu): each env's TILE_W x TILE_H tile lists staged in
batches of 32, the live rows compacted in list order, the scan with the
rows' y terms premultiplied and a strict <. ``texel_nofp`` is the
topview_epilogue kernel's Fourier texel without a footprint
(csrc/texel.cuh fourier_texel_nofp). ``entity_tile_keep`` copies the
entity_pass kernel's per-tile cull (csrc/entity_pass.cu): each slot's
bounding sphere, grown by its margin, against the four side planes of a
tile's rays and the plane NEAR / 2 in front of the eye. ``mazegen_walk``
copies the mazegen kernel's step (csrc/mazegen.cu): packed neighbour
entries, a visited bitmask, a 4-bit candidate mask whose pick-th set bit
is found by clearing the lowest set bit pick times, the top cell kept
apart from the stack. ``vis_tile_keep`` and ``vis_occluded`` copy the
visible_ents kernel's cull (csrc/visible_ents.cu: the query box's sphere
taken from its slab numerators, against the same planes) and its
occlusion scan with early exit; ``vis_visible`` puts them together.
``active_compact_select`` copies the one-chunk tri_pass kernel's ACTIVE
staging (csrc/tri_pass.cu): each env's live rows only (their codes read
first), staged, culled against the image's box and compacted into slots
in any order, each slot carrying its row index; per tile the slots
culled against the tile's box; each pixel's z-key the max over its
tile's slots with the row index in its low bits.
"""

import math

import numpy as np
import torch

from miniworld_tpu_torch.ops import geom, mazegen
from miniworld_tpu_torch.render import raycast as trc
from miniworld_tpu_torch.render import topview as ttop
from miniworld_tpu_torch.render import visibility as tvis


def first_chunk_rank(n_rows, tri_chunk):
    """(chunk, local index) of each row as the multi-chunk kernel stages
    it: the row's first chunk and its index there, the last chunk
    starting at n_rows - tri_chunk."""
    s = torch.arange(n_rows)
    chunk = torch.clamp(s // tri_chunk, max=(n_rows - 1) // tri_chunk)
    return chunk, s - torch.clamp(chunk * tri_chunk, max=n_rows - tri_chunk)


def _spans(vals, step):
    """(lo, hi) of each run of ``step`` values along dim 1: (B, n) each."""
    parts = [vals[:, i:i + step] for i in range(0, vals.shape[1], step)]
    return (torch.stack([p.amin(1) for p in parts], 1),
            torch.stack([p.amax(1) for p in parts], 1))


def group_boxes(cam, tile, group):
    """(B, G, 4) boxes (xlo, xhi, ylo, yhi) of the groups of group[0] x
    group[1] tiles in row-major order, each the union of its in-image
    tiles' boxes, as the kernel forms them; and the pixel size of a group."""
    xv = cam.xbase[None, :] * cam.tan_x[:, None]
    yv = cam.ybase[None, :] * cam.tan_y[:, None]
    gw, gh = tile[0] * group[0], tile[1] * group[1]
    (xlo, xhi), (ylo, yhi) = _spans(xv, gw), _spans(yv, gh)
    b, n_gx, n_gy = xv.shape[0], xlo.shape[1], ylo.shape[1]
    shape = (b, n_gy, n_gx)
    box = torch.stack([xlo[:, None, :].expand(shape), xhi[:, None, :].expand(shape),
                       ylo[:, :, None].expand(shape), yhi[:, :, None].expand(shape)], dim=-1)
    return box.reshape(b, n_gy * n_gx, 4), (gw, gh)


def window_select(verts9, attr, layout_id, cam, tri_chunk, all_quads=False, paired=None,
                  window=1024, block=384, group=(2, 2), tile=(16, 12)):
    """The multi-chunk tri_pass kernel's result, (t (B, HW), attr (B, HW,
    16) bf16), computed as the kernel computes it (module docstring)."""
    S = verts9.shape[2]
    rows = trc.stage_rows(verts9, attr, layout_id, cam, paired)
    _, attrs = trc._env_rows(verts9, attr, layout_id.long(), paired)
    _, local = first_chunk_rank(S, tri_chunk)
    b_n, w, h = rows.shape[0], cam.width, cam.height
    tw, th = tile
    xv = cam.xbase[None, :] * cam.tan_x[:, None]  # (B, W), as the kernel rounds it
    yv = cam.ybase[None, :] * cam.tan_y[:, None]
    (cxlo, cxhi), (cylo, cyhi) = _spans(xv, tw), _spans(yv, th)  # per tile column / row
    n_tx, n_ty = cxlo.shape[1], cylo.shape[1]
    key_best = torch.zeros((b_n, h, w), dtype=torch.int32)
    row_best = torch.zeros((b_n, h, w), dtype=torch.long)

    def may_hit(b, idx, box):
        return trc._may_hit(rows[b:b + 1, idx], box.view(1, 1, 4), all_quads)[0, 0]

    for b in range(b_n):
        image = torch.stack([xv[b].amin(), xv[b].amax(), yv[b].amin(), yv[b].amax()])
        keep = may_hit(b, torch.arange(S), image)
        windows, cur = [], torch.zeros(0, dtype=torch.long)
        for s0 in range(0, S, block):
            batch = torch.arange(s0, min(s0 + block, S))[keep[s0:s0 + block]]
            if cur.numel() + batch.numel() > window:
                windows.append(cur)
                cur = torch.zeros(0, dtype=torch.long)
            cur = torch.cat([cur, batch])
        windows.append(cur)
        for win in windows:
            for gy0 in range(0, n_ty, group[1]):
                for gx0 in range(0, n_tx, group[0]):
                    tiles = [(tx, ty) for ty in range(gy0, min(gy0 + group[1], n_ty))
                             for tx in range(gx0, min(gx0 + group[0], n_tx))]
                    txs = slice(gx0, min(gx0 + group[0], n_tx))
                    tys = slice(gy0, min(gy0 + group[1], n_ty))
                    gbox = torch.stack([cxlo[b, txs].amin(), cxhi[b, txs].amax(),
                                        cylo[b, tys].amin(), cyhi[b, tys].amax()])
                    glist = win[may_hit(b, win, gbox)]
                    for tx, ty in tiles:
                        tbox = torch.stack([cxlo[b, tx], cxhi[b, tx], cylo[b, ty], cyhi[b, ty]])
                        tl = glist[may_hit(b, glist, tbox)]
                        xs = slice(tx * tw, min(tx * tw + tw, w))
                        ys = slice(ty * th, min(ty * th + th, h))
                        pxv = xv[b, xs][None, :].expand(ys.stop - ys.start, -1).reshape(1, -1)
                        pyv = yv[b, ys][:, None].expand(-1, xs.stop - xs.start).reshape(1, -1)
                        k = trc._row_keys(rows[b:b + 1, tl], pxv, pyv, all_quads)[0]  # (n, P)
                        key = torch.where(k > 0, (k & ~trc._IDX_MASK) | local[tl][:, None].int(),
                                          torch.zeros_like(k))
                        best = key_best[b, ys, xs].reshape(-1).clone()
                        rb = row_best[b, ys, xs].reshape(-1).clone()
                        for j in range(tl.numel()):  # in row order, strictly greater
                            won = key[j] > best
                            best = torch.where(won, key[j], best)
                            rb = torch.where(won, tl[j], rb)
                        key_best[b, ys, xs] = best.view(ys.stop - ys.start, -1)
                        row_best[b, ys, xs] = rb.view(ys.stop - ys.start, -1)
    key = key_best.reshape(b_n, -1)
    sel = trc._gather_rows(attrs, row_best.reshape(b_n, -1)).to(torch.bfloat16)
    return trc._t_from_key(key), torch.where((key > 0)[:, :, None], sel, torch.zeros_like(sel))


def lane_quad_mean(rgb):
    """The SS=2 epilogue's box filter as its lanes form it: rgb (B, 2H,
    2W, 3) the samples' shaded float colours -> (B, H, W, 3) means. A
    warp holds 16 consecutive samples of a sample row in lanes 0-15 and
    the 16 below them in lanes 16-31; lane l adds lane l + 1's, then l +
    16's, then l + 17's value (``__shfl_sync``, the lane index mod 32)
    and scales by 0.25, and the even lanes below 16 (each pixel's s00)
    keep their result."""
    b, h2, w2, _ = rgb.shape
    runs = math.ceil(w2 / 16)
    padded = torch.zeros((b, h2, runs * 16, 3), dtype=rgb.dtype)
    padded[:, :, :w2] = rgb
    lanes = (padded.reshape(b, h2 // 2, 2, runs, 16, 3).permute(0, 1, 3, 2, 4, 5)
             .reshape(b, h2 // 2, runs, 32, 3))

    def shfl(d):  # every lane reads lane (l + d) & 31
        return lanes.roll(-d, dims=3)

    v = ((lanes + shfl(1)) + shfl(16)) + shfl(17)
    v = v * 0.25
    return v[:, :, :, 0:16:2].reshape(b, h2 // 2, runs * 8, 3)[:, :, :w2 // 2]


def texel_read_mask(t_tri, t_ent):
    """(B, HW) bool: the samples whose attributes and texel the epilogue
    reads: a finite t_tri that no strictly closer entity beats."""
    mask = torch.isfinite(t_tri)
    if t_ent is not None:
        mask &= ~(t_ent < t_tri)
    return mask


def epilogue_inputs(env, state, width, height):
    """pixel_epilogue_plain's positional arguments (up to k_terms) for the
    env's render of ``state`` on a width x height grid of samples: the
    plain hit passes' results, the atlas, the camera and the lights."""
    cam = trc.camera_grid(state, width, height)
    rows, paired = trc.static_rows(env._bank, state, cam, env._pg_wall, env.plan)
    mesh = trc.entity_mesh_rows(env._bank, state)[:2] if env._shapes_present[2] else None
    t_tri, attr = trc.tri_pass(*rows, cam, env._all_quads, mesh, paired, env.tri_chunk)
    ent = (None,) * 3
    if env._shapes_present[0] or env._shapes_present[1]:
        ent = trc.entity_pass(state.ent_pos, state.ent_size, state.ent_dir, state.ent_height,
                              state.ent_color, trc.entity_flags(env._bank, state), cam,
                              *env._shapes_present[:2])
    return (t_tri, attr, *ent, env._atlas, cam, state.light_pos, state.light_color,
            state.light_ambient, state.sky_color, env.fourier_k)


def group_cull_misses(rows, cam, all_quads, tile, group):
    """(the (row, pixel) hits that a group's box would drop, keep (B, G,
    S)): the kernel's cull (``trc._may_hit``) against each group of
    tiles' box, held against row_hits_plain on every pixel of the group."""
    hits = trc.row_hits_plain(rows, cam, all_quads)  # (B, S, HW)
    box, (gw, gh) = group_boxes(cam, tile, group)
    keep = trc._may_hit(rows, box, all_quads)  # (B, G, S)
    n_gx = -(-cam.width // gw)
    group_of = ((torch.arange(cam.height)[:, None] // gh) * n_gx
                + torch.arange(cam.width)[None, :] // gw).reshape(-1)
    keep_px = keep[:, group_of, :].transpose(1, 2)
    return int((hits & ~keep_px).sum()), keep


def ss2_by_lanes(args, has_gain=False):
    """The SS=2 epilogue's output formed as its lanes form it: each
    sample shaded as pixel_epilogue_plain shades it, the means by
    ``lane_quad_mean``, the truncating pack, the top-left sample's depth.
    ``args``: pixel_epilogue_plain's positional arguments up to k_terms."""
    rgb, depth = trc._pixel_epilogue_block(*args, has_gain)
    mean = lane_quad_mean(rgb)
    return (torch.clamp(mean * 255.0, 0.0, 255.0).to(torch.uint8),
            depth[:, ::2, ::2].contiguous())


def ortho_scan(st, layout_id, wall_open=None, batch=32):
    """The tri_pass_ortho kernel's (t (B, HW), row (B, HW)), computed as
    it computes them: per env and tile, the tile's list (``st.tile_off``,
    ``st.tile_rows``) in batches of ``batch`` rows, each batch's live rows
    (``row_live`` in the env) in list order, each row's y terms as the
    staging premultiplies them (TOP_CAM_HEIGHT * y, the plain version's
    product), and per pixel a strict < on t, so the first listed row at
    the smallest t wins."""
    w, h = st.width, st.height
    tw, th = ttop.TILE_W, ttop.TILE_H
    n_tx, n_t = -(-w // tw), st.tile_off.shape[1] - 1
    b = layout_id.shape[0]
    live = ttop.row_live(st.row_code[layout_id.long()], wall_open)  # (B, Sc)
    t_out = torch.full((b, h, w), math.inf)
    row_out = torch.full((b, h, w), -1, dtype=torch.int32)
    for e in range(b):
        lay = int(layout_id[e])
        for tile in range(n_t):
            y0, x0 = tile // n_tx * th, tile % n_tx * tw
            px = st.xs[lay, x0:x0 + tw][None, :]
            pz = st.zs[lay, y0:y0 + th][:, None]
            best = torch.full((pz.shape[0], px.shape[1]), math.inf)
            win = torch.full(best.shape, -1, dtype=torch.int32)
            k0, k1 = int(st.tile_off[lay, tile]), int(st.tile_off[lay, tile + 1])
            for c0 in range(k0, k1, batch):
                entries = st.tile_rows[c0:min(c0 + batch, k1)].long()
                for q in entries[live[e, entries]].tolist():  # the ballot's order
                    r = st.rows[lay, q]
                    au = px * r[0] + ttop.TOP_CAM_HEIGHT * r[1]
                    av = px * r[4] + ttop.TOP_CAM_HEIGHT * r[5]
                    at = px * r[8] + ttop.TOP_CAM_HEIGHT * r[9]
                    u = ((au + pz * r[2]) - r[3]) * r[12]
                    v = ((av + pz * r[6]) - r[7]) * r[12]
                    t = (r[11] - (at + pz * r[10])) * r[13]
                    cov = torch.maximum(u, v) + r[14] * torch.minimum(u, v)
                    better = ((u >= 0.0) & (v >= 0.0) & (cov <= 1.0) & (t > 0.0)
                              & (t < trc.FAR) & (t < best))
                    best = torch.where(better, t, best)
                    win = torch.where(better, st.row_id[lay, q], win)
            t_out[e, y0:y0 + th, x0:x0 + tw] = best
            row_out[e, y0:y0 + th, x0:x0 + tw] = win
    return t_out.reshape(b, h * w), row_out.reshape(b, h * w)


def texel_nofp(table, slot, uv, k_terms, has_gain=False):
    """(N, 3) texels as the topview_epilogue kernel computes them from the
    per-slot ``fourier_table``: per term the phase, the turn-wrapped cos
    and sin, both to bf16 as they are (no attenuation), the six amplitude
    products, sums in order k = 0..K-1; the end of fourier_finish at a
    footprint of 0 (the glyph width max(w0, 0)); white for slot < 0, black
    for a slot past the table."""
    bf = trc._bf16
    k = k_terms
    n_rows = table.shape[0]
    slot_i = torch.round(slot).long()
    row = table[slot_i.clamp(0, n_rows - 1)]
    p = row[:, 4:4 + 4 * k].reshape(-1, k, 4)
    q = row[:, 4 + 4 * k:4 + 8 * k].reshape(-1, k, 4)
    r = row[:, 4 + 8 * k:]
    acc_a = acc_b = None
    for j in range(k):
        c, s = trc._cos_sin_turns(p[:, j, 0] * uv[:, 0] + p[:, j, 1] * uv[:, 1])
        c, s = bf(c), bf(s)
        pa = torch.stack([c * p[:, j, 3], c * q[:, j, 0], c * q[:, j, 1]], 1)
        pb = torch.stack([s * q[:, j, 2], s * q[:, j, 3], s * r[:, j]], 1)
        acc_a = pa if j == 0 else acc_a + pa
        acc_b = pb if j == 0 else acc_b + pb
    dc = row[:, :3]
    v = dc + bf(bf(acc_a) + bf(acc_b))
    if has_gain:
        gain = row[:, 3:4]
        w0 = -1.0 / (2.0 * torch.clamp(gain, max=-1e-9))
        w_eff = torch.maximum(w0, torch.zeros_like(w0))
        sd = torch.clamp(0.5 + v[:, 0:1] / (2.0 * w_eff), 0.0, 1.0)
        glyph = trc._fma(v[:, 2:3] - v[:, 1:2], sd, v[:, 1:2]).expand(-1, 3)
        v = torch.where(gain < 0.0, glyph,
                        torch.where(gain > 1.0, trc._fma(v - dc, gain, dc), v))
    tex = torch.clamp(v, 0.0, 1.0)
    tex = torch.where((slot_i < n_rows)[:, None], tex, torch.zeros_like(tex))
    return torch.where((slot_i >= 0)[:, None], tex, torch.ones_like(tex))


ENT_CULL_MARGIN = 2.0 ** -6  # csrc/entity_pass.cu CULL_MARGIN


def entity_tile_of_pixel(width, height, tile=(trc.ENT_TILE_W, trc.ENT_TILE_H)):
    """(HW,) the entity_pass kernel's tile (row-major) of each sample."""
    n_tx = -(-width // tile[0])
    return ((torch.arange(height)[:, None] // tile[1]) * n_tx
            + torch.arange(width)[None, :] // tile[0]).reshape(-1)


def entity_tile_keep(ent_pos, ent_size, ent_height, flags, cam, has_sphere=True,
                     has_box=True, tile=(trc.ENT_TILE_W, trc.ENT_TILE_H)):
    """(B, n_tiles, E) bool: the slots the entity_pass kernel keeps for
    each of its tiles, computed as it computes them: a live slot's
    bounding sphere (the sphere, or the box's half-diagonal around pos +
    (0, sy / 2, 0)) grown to rho = R + 2^-6 (|C - o| + R) is dropped when
    it lies beyond one of the tile's four side planes or nearer the eye than
    the plane NEAR / 2 in front of it."""
    o = cam.origin[:, None, :]
    px, py, pz = ent_pos.unbind(-1)
    sx, sy, sz = ent_size.unbind(-1)
    sphere = (flags & trc.ENT_SPHERE) != 0
    box = ((flags & trc.ENT_BOX) != 0) & has_box
    live = ((flags & trc.ENT_ACTIVE) != 0) & torch.where(sphere, has_sphere, box)
    r_vis = 0.5 * ent_height
    cy = torch.where(sphere, 0.5 * ent_height, 0.5 * sy)
    rad = torch.where(sphere, r_vis.abs(), 0.5 * geom.sqrt(sx * sx + sy * sy + sz * sz))
    c0, c1, c2 = px - o[..., 0], (py + cy) - o[..., 1], pz - o[..., 2]

    def dot(v):  # (B, E)
        return c0 * v[:, 0:1] + c1 * v[:, 1:2] + c2 * v[:, 2:3]

    cf, cr, cu = dot(cam.fwd), dot(cam.right), dot(cam.up)
    dist = geom.sqrt(c0 * c0 + c1 * c1 + c2 * c2)
    rho = torch.where(live, rad + ENT_CULL_MARGIN * (dist + rad), torch.full_like(rad, -1.0))
    return _tile_keep(cf, cr, cu, rho, cam, tile)


def _tile_keep(cf, cr, cu, rho, cam, tile):
    """(B, n_tiles, E) bool: the spheres (camera coordinates cf, cr, cu of
    their centres about the eye, grown radius rho; rho < 0 marks a slot
    never kept) that the tiles' four side planes and the plane NEAR / 2
    keep, tiles row-major, as entity_pass.cu and visible_ents.cu test
    them."""
    xv = cam.xbase[None, :] * cam.tan_x[:, None]  # (B, W), as the kernel rounds it
    yv = cam.ybase[None, :] * cam.tan_y[:, None]
    (xlo, xhi), (ylo, yhi) = _spans(xv, tile[0]), _spans(yv, tile[1])
    b, n_tx, n_ty = xv.shape[0], xlo.shape[1], ylo.shape[1]

    def per_tile(v, along_x):  # (B, n) -> (B, n_tiles, 1), tiles row-major
        v = v[:, None, :].expand(b, n_ty, n_tx) if along_x else \
            v[:, :, None].expand(b, n_ty, n_tx)
        return v.reshape(b, -1, 1)

    xlo, xhi = per_tile(xlo, True), per_tile(xhi, True)
    ylo, yhi = per_tile(ylo, False), per_tile(yhi, False)

    def norm(v):
        return geom.sqrt(1.0 + v * v)

    cf, cr, cu, rho = cf[:, None], cr[:, None], cu[:, None], rho[:, None]
    out = ((cr - xhi * cf > rho * norm(xhi)) | (xlo * cf - cr > rho * norm(xlo))
           | (cu - yhi * cf > rho * norm(yhi)) | (ylo * cf - cu > rho * norm(ylo))
           | (cf + rho < 0.5 * trc.NEAR))
    return ~(rho < 0.0) & ~out


VIS_CULL_MARGIN = 2.0 ** -6  # csrc/visible_ents.cu CULL_MARGIN


def vis_tile_keep(cam, ent_pos, ent_alive, tile=tvis.VIS_TILE):
    """(B, n_tiles, E) bool: the entities the visible_ents kernel keeps for
    each of its tiles, computed as it computes them: the sphere of each
    alive entity's query box taken from the slab numerators n_lo = (pos +
    lo) - o and n_hi = (pos + hi) - o (centre (n_lo + n_hi) / 2, radius
    |n_hi - n_lo| / 2, both about the eye), grown to rho = R + 2^-6 (|c| +
    R), against the tile's four side planes and the plane NEAR / 2."""
    lo_off = torch.tensor([-tvis.BOX_R, 0.0, -tvis.BOX_R], dtype=torch.float32)
    hi_off = torch.tensor([tvis.BOX_R, tvis.BOX_H, tvis.BOX_R], dtype=torch.float32)
    o = cam.origin[:, None, :]
    n_lo, n_hi = (ent_pos + lo_off) - o, (ent_pos + hi_off) - o  # (B, E, 3)
    c0, c1, c2 = (0.5 * (n_lo + n_hi)).unbind(-1)
    h0, h1, h2 = (0.5 * (n_hi - n_lo)).unbind(-1)
    rad = geom.sqrt(h0 * h0 + h1 * h1 + h2 * h2)
    dist = geom.sqrt(c0 * c0 + c1 * c1 + c2 * c2)

    def dot(v):  # (B, E)
        return c0 * v[:, 0:1] + c1 * v[:, 1:2] + c2 * v[:, 2:3]

    rho = torch.where(ent_alive, rad + VIS_CULL_MARGIN * (dist + rad),
                      torch.full_like(rad, -1.0))
    return _tile_keep(dot(cam.fwd), dot(cam.right), dot(cam.up), rho, cam, tile)


def vis_occluded(st, layout_id, wall_open, cam, t_in):
    """(B, HW, E) bool: the visible_ents kernel's occlusion scan at each
    pixel and entity, computed as it computes it: each live room row's
    det, u, v, cov and t = t_num * (1 / det) by the plain version's
    operations and its gates (det > 1e-12, u >= 0, v >= 0, cov <= det,
    NEAR < t < FAR); the scan stops at a gated row with t <= t_in, and the
    pixel is occluded where such a row exists, in whatever order the rows
    are scanned."""
    lid = layout_id.long()
    r = st.rows[lid]  # (B, Sr, 12)
    v0, e1, e2 = r[..., 0:3], r[..., 3:6], r[..., 6:9]
    s = cam.origin[:, None, :] - v0
    g_det, g_u, g_v = geom.cross(e2, e1), geom.cross(e2, s), geom.cross(s, e1)
    t_num = (e2[..., 0] * g_v[..., 0] + e2[..., 1] * g_v[..., 1]) + e2[..., 2] * g_v[..., 2]
    d = tvis._rays(cam)[:, :, None, :]  # (B, HW, 1, 3)

    def dot(g):  # (B, HW, Sr)
        g = g[:, None, :, :]
        return (d[..., 0] * g[..., 0] + d[..., 1] * g[..., 1]) + d[..., 2] * g[..., 2]

    det, u, v = dot(g_det), dot(g_u), dot(g_v)
    cov = torch.maximum(u, v) + r[:, None, :, 9] * torch.minimum(u, v)
    gate = (det > 1e-12) & (u >= 0.0) & (v >= 0.0) & (cov <= det)
    t = t_num[:, None, :] * (1.0 / torch.where(gate, det, torch.ones_like(det)))
    live = ttop.row_live(st.row_code[lid], wall_open)  # (B, Sr)
    hit = gate & (t > trc.NEAR) & (t < trc.FAR) & live[:, None, :]
    return (hit[..., None] & (t[..., None] <= t_in[:, :, None, :])).any(dim=2)


def vis_visible(st, layout_id, wall_open, cam, ent_pos, ent_alive):
    """(B, E) bool: the visible_ents kernel's result, computed as it
    computes it: the tile cull (``vis_tile_keep``), the slab test at the
    pixels of the tiles that keep the entity, and the occlusion scan
    (``vis_occluded``) where it hits."""
    keep = vis_tile_keep(cam, ent_pos, ent_alive)  # (B, T, E)
    keep_px = keep[:, entity_tile_of_pixel(cam.width, cam.height, tvis.VIS_TILE), :]
    t_in, hit = tvis.box_entry(cam, ent_pos)
    occluded = vis_occluded(st, layout_id, wall_open, cam, t_in)
    return (keep_px & hit & ~occluded).any(dim=1)


def mazegen_walk(us, rows, cols):
    """(B, W) f32 walls (1 = open) as the mazegen kernel makes them from
    each env's 2N - 1 uniforms ``us`` (B, 2N - 1): per step the top
    cell's packed entries (cell | wall << 16, -1 off the grid), the
    candidates as bits [+x, -x, +z, -z] of the unvisited ones, pick =
    min(floor(u * k), k - 1) in float32, the pick-th set bit by clearing
    the lowest one pick times; a pop reads the stack below the top."""
    nbr_cell, nbr_wall = mazegen.neighbor_tables(rows, cols)
    packed = np.where(nbr_cell >= 0, nbr_cell | (nbr_wall << 16), -1)
    n, n_walls = rows * cols, mazegen.num_walls(rows, cols)
    us = us.numpy().astype(np.float32)
    walls = np.zeros((us.shape[0], n_walls), np.float32)
    for b in range(us.shape[0]):
        visited, opened, stack, cur, sp = 1, 0, [0] * n, 0, 1
        for i in range(2 * n - 1):
            if sp == 0:
                break
            nb = packed[cur]
            cand = sum(1 << d for d in range(4)
                       if nb[d] >= 0 and not (visited >> int(nb[d] & 0xFFFF)) & 1)
            k = bin(cand).count("1")
            if k:
                pick = min(int(np.floor(us[b, i] * np.float32(k))), k - 1)
                for _ in range(pick):
                    cand &= cand - 1
                v = int(nb[(cand & -cand).bit_length() - 1])
                cur = v & 0xFFFF
                visited |= 1 << cur
                opened |= 1 << (v >> 16)
                stack[sp] = cur
                sp += 1
            else:
                sp -= 1
                cur = stack[sp - 1] if sp else cur
        walls[b] = [(opened >> w) & 1 for w in range(n_walls)]
    return torch.from_numpy(walls)


def active_compact_select(verts9, attr, layout_id, cam, row_code, wall_open, all_quads=False,
                          override=None, tile=(16, 12), seed=0):
    """The one-chunk ACTIVE tri_pass kernel's result, (t (B, HW), attr (B,
    HW, 16) bf16), computed as the kernel computes it (module docstring):
    no killed row is staged, the live rows' slots come in a random order
    (``seed``; the atomic compaction's order is not fixed), and the
    winner's attributes are its row's (with ``override``, its texture
    variant), row 0's where nothing hits."""
    S = verts9.shape[2]
    b_n, w, h = layout_id.shape[0], cam.width, cam.height
    lid = layout_id.long()
    live = trc.row_live(row_code[lid], wall_open)  # (B, S), from the codes alone
    _, attrs = trc._env_rows(verts9, attr, lid, None, override)
    xv = cam.xv().view(b_n, h, w)[:, 0]  # (B, W)
    yv = cam.yv().view(b_n, h, w)[:, :, 0]  # (B, H)
    (cxlo, cxhi), (cylo, cyhi) = _spans(xv, tile[0]), _spans(yv, tile[1])
    gen = torch.Generator().manual_seed(seed)
    key_best = torch.zeros((b_n, h, w), dtype=torch.int32)
    for b in range(b_n):
        s_live = torch.nonzero(live[b]).flatten()
        s_live = s_live[torch.randperm(s_live.numel(), generator=gen)]
        c = trc._cam_rows(cam, slice(b, b + 1))
        rows = trc._stage(verts9[lid[b:b + 1]][:, :, s_live],
                          attr[lid[b], s_live, trc._KIND][None], c)
        image = torch.stack([xv[b].amin(), xv[b].amax(), yv[b].amin(), yv[b].amax()])
        keep = trc._may_hit(rows, image.view(1, 1, 4), all_quads)[0, 0]
        rows, slots = rows[:, keep], s_live[keep].int()
        for ty in range(cylo.shape[1]):
            for tx in range(cxlo.shape[1]):
                tbox = torch.stack([cxlo[b, tx], cxhi[b, tx], cylo[b, ty], cyhi[b, ty]])
                tk = trc._may_hit(rows, tbox.view(1, 1, 4), all_quads)[0, 0]
                xs = slice(tx * tile[0], min(tx * tile[0] + tile[0], w))
                ys = slice(ty * tile[1], min(ty * tile[1] + tile[1], h))
                pxv = xv[b, xs][None, :].expand(ys.stop - ys.start, -1).reshape(1, -1)
                pyv = yv[b, ys][:, None].expand(-1, xs.stop - xs.start).reshape(1, -1)
                k = trc._row_keys(rows[:, tk], pxv, pyv, all_quads)[0]  # (n, P)
                key = torch.where(k > 0, (k & ~trc._IDX_MASK) | slots[tk][:, None],
                                  torch.zeros_like(k))
                best = key.amax(0) if key.shape[0] else torch.zeros(pxv.shape[1],
                                                                    dtype=torch.int32)
                key_best[b, ys, xs] = best.view(ys.stop - ys.start, -1)
    key = key_best.reshape(b_n, -1)
    sel = trc._gather_rows(attrs, (key & trc._IDX_MASK).long())
    return trc._t_from_key(key), sel.to(torch.bfloat16)

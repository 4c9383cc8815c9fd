"""Super-bank compiler for device-side per-reset maze generation.

Jax-free copy of ``miniworld_tpu/scene/supermaze.py`` for the PyTorch
port; both packages compile the same arrays.

The reference regenerates the maze world every reset
(miniworld/envs/maze.py:73-153 under MiniWorldEnv.reset,
miniworld/miniworld.py:558-618). The vectorized engine does not rebuild
geometry per env on the device, so this module compiles ONE "super"
layout containing every wall variant of the ``rows x cols`` grid:

  * all cell rooms, with portals punched through EVERY interior edge
    and a junction room spanning every gap (the all-open maze);
  * additionally, for every interior wall, the two full-edge wall quads
    (one per facing cell) and their collision segments that the
    all-CLOSED maze would have.

Per-env episode geometry is then a (W,) wall-open bitmask generated on
device at reset (ops/mazegen.gen_walls):

  * a closed-wall quad/segment is active iff its wall is closed
    (Layout.tri_wall / room_seg_wall codes);
  * junction content (floor/ceiling/side walls) is active iff its wall
    is open (Layout.tri_jwall): a closed wall's junction is sealed by
    the closed quads on both ends — invisible and unreachable in the
    perspective render either way, but it must also vanish from
    ``render_top_view`` like the reference's never-built junction
    room. Its collision segments stay always-solid (when the wall is
    open they are the corridor's real side walls; when closed they are
    unreachable behind the quads);
  * junction ROOMS exist for placement iff their wall is open
    (Layout.room_wall), matching the reference's area-weighted room
    choice over cells + existing junctions
    (miniworld/miniworld.py:957-963).

The port renders the paired bank (``Layout.pg_*``, built below): each
wall's junction rows carry its closed quads as an alternative variant,
and the tri_pass picks the live one per env (render/raycast.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from miniworld_tpu_torch.ops import mazegen
from miniworld_tpu_torch.render.textures import TEX_DENSITY, texture_pixel_size
from miniworld_tpu_torch.scene.compile import (
    Layout, _room_local_segs, compile_world, pack_tri_attrs, tex_base_count,
)
from miniworld_tpu_torch.scene.room import Room
from miniworld_tpu_torch.scene.world import World
from miniworld_tpu_torch.utils.assets import texture_variant_paths


def _uv_mul(name):
    w, h = texture_pixel_size(texture_variant_paths(name)[0])
    return TEX_DENSITY / w, TEX_DENSITY / h


def populate_eager_maze(world: World, spec, open_w) -> None:
    """Oracle: build the spec's maze grid eagerly with exactly the
    given walls open (the world the reference's _gen_world would build
    for this spanning tree, miniworld/envs/maze.py:73-149) — the
    pixel-parity ground truth for the super bank (tests/test_procgen.py).
    Entities are the caller's business."""
    rows, cols = spec.num_rows, spec.num_cols
    size, gap = spec.room_size, spec.gap_size
    cells = []
    for i in range(rows):
        row = []
        for j in range(cols):
            min_x = j * (size + gap)
            min_z = i * (size + gap)
            row.append(world.add_rect_room(
                min_x=min_x, max_x=min_x + size,
                min_z=min_z, max_z=min_z + size,
                wall_tex="brick_wall",
            ))
        cells.append(row)
    for i in range(rows):
        for j in range(cols - 1):
            if open_w[mazegen.hwall_id(i, j, cols)]:
                a, b = cells[i][j], cells[i][j + 1]
                world.connect_rooms(a, b, min_z=a.min_z, max_z=a.max_z)
    for i in range(rows - 1):
        for j in range(cols):
            if open_w[mazegen.vwall_id(i, j, rows, cols)]:
                a, b = cells[i][j], cells[i + 1][j]
                world.connect_rooms(a, b, min_x=a.min_x, max_x=a.max_x)


def compile_super_maze(spec, catalog) -> Layout:
    """Compile the spec's maze grid into one super layout (unstacked).

    ``spec`` needs num_rows/num_cols/room_size/gap_size/agent_radius
    (the Maze family, envs/nav.py). Returns a Layout whose procgen
    fields (tri_wall, tri_wall_onehot, room_seg_wall, room_wall) are
    set; everything else matches a normal compiled world.
    """
    rows, cols = spec.num_rows, spec.num_cols
    size, gap = spec.room_size, spec.gap_size
    n_cells = rows * cols
    n_walls = mazegen.num_walls(rows, cols)

    world = World(catalog)
    world.agent_radius = spec.agent_radius

    cells = []
    for i in range(rows):
        row = []
        for j in range(cols):
            min_x = j * (size + gap)
            min_z = i * (size + gap)
            row.append(world.add_rect_room(
                min_x=min_x, max_x=min_x + size,
                min_z=min_z, max_z=min_z + size,
                wall_tex="brick_wall",
            ))
        cells.append(row)

    # Connect every interior wall in wall-id order, so the junction of
    # wall w is room ``n_cells + w`` (connect_rooms appends one room per
    # gap; gap_size > 0 guarantees a junction every time).
    for i in range(rows):
        for j in range(cols - 1):
            a, b = cells[i][j], cells[i][j + 1]
            world.connect_rooms(a, b, min_z=a.min_z, max_z=a.max_z)
    for i in range(rows - 1):
        for j in range(cols):
            a, b = cells[i][j], cells[i + 1][j]
            world.connect_rooms(a, b, min_x=a.min_x, max_x=a.max_x)
    assert len(world.rooms) == n_cells + n_walls

    # Same entity set as Maze.build (envs/nav.py): one red box + agent,
    # any room, area-weighted.
    world.place(world.proto_id("box", "red"))
    world.place_agent()

    lay = compile_world(world, with_pvs=False)
    s_open = lay.tri_mask.shape[0]

    # --- closed-wall quads: a throwaway portal-free Room per cell,
    # keeping only interior-edge wall triangles. Texture slots resolve
    # through world's per-(room, role) cache, so a cell's closed walls
    # share its wall-texture variant draw like the reference's
    # unportaled walls would.
    verts, uvs, normals, texs, walls_of, kinds = [], [], [], [], [], []
    segs_new, seg_codes_new = [], []
    eps = 1e-6
    for i in range(rows):
        for j in range(cols):
            room = cells[i][j]
            ri = i * cols + j
            solid = Room(
                np.stack([room.outline[:, 0], room.outline[:, 2]], axis=1),
                wall_height=room.wall_height,
                wall_tex=room.wall_tex_name,
                floor_tex=room.floor_tex_name,
                ceil_tex=room.ceil_tex_name,
            )
            slot_of = {
                room.wall_tex_name: world.tex_slot(room.wall_tex_name, tag=("room", ri, 0)),
                room.floor_tex_name: world.tex_slot(room.floor_tex_name, tag=("room", ri, 1)),
                room.ceil_tex_name: world.tex_slot(room.ceil_tex_name, tag=("room", ri, 2)),
            }
            tris, segs = solid.gen_static(lambda n: slot_of[n], _uv_mul)

            def edge_wall(x_const, z_const):
                """Wall id of the interior edge at the given constant
                coordinate, or -1 for boundary edges."""
                if x_const is not None:
                    if abs(x_const - room.min_x) < eps:
                        return mazegen.hwall_id(i, j - 1, cols) if j > 0 else -1
                    return mazegen.hwall_id(i, j, cols) if j + 1 < cols else -1
                if abs(z_const - room.min_z) < eps:
                    return mazegen.vwall_id(i - 1, j, rows, cols) if i > 0 else -1
                return mazegen.vwall_id(i, j, rows, cols) if i + 1 < rows else -1

            for t in range(len(tris)):
                nrm = tris.normals[t]
                if abs(nrm[1]) > 0.5:
                    continue  # floor/ceiling: the open world has them
                v = tris.verts[t]
                if abs(nrm[0]) > 0.5:
                    w = edge_wall(float(v[0, 0]), None)
                else:
                    w = edge_wall(None, float(v[0, 2]))
                if w < 0:
                    continue  # boundary wall: already in the open world
                verts.append(v)
                uvs.append(tris.uvs[t])
                normals.append(nrm)
                texs.append(tris.tex_slots[t])
                walls_of.append(w)
                kinds.append(tris.kinds[t])
            for s in range(segs.shape[0]):
                a, b = segs[s, 0], segs[s, 1]
                if abs(a[0] - b[0]) < eps:
                    w = edge_wall(float(a[0]), None)
                else:
                    w = edge_wall(None, float(a[1]))
                if w < 0:
                    continue
                segs_new.append(segs[s])
                seg_codes_new.append(w)

    n_closed = len(verts)
    tri_verts_c = np.asarray(verts, np.float32).reshape(n_closed, 3, 3)
    tri_uv_c = np.asarray(uvs, np.float32).reshape(n_closed, 3, 2)
    tri_normal_c = np.asarray(normals, np.float32).reshape(n_closed, 3)
    tri_tex_c = np.asarray(texs, np.int32)
    tri_color_c = np.ones((n_closed, 3), np.float32)
    tri_attr_c = pack_tri_attrs(
        tri_verts_c, tri_uv_c, tri_normal_c, tri_color_c, tri_tex_c,
        np.asarray(kinds, np.float32),
    )
    base_c, count_c = tex_base_count(tri_tex_c, world.tex_slots)
    # The facing cell owns its closed quad (room attribution feeds
    # rooms-only passes like get_visible_ents): the quad's inward
    # normal points INTO its owning cell.
    centers = tri_verts_c.mean(axis=1)  # (n, 3)
    inward = centers + tri_normal_c * (gap * 0.5 + 1e-3)
    cx = np.clip((inward[:, 0] // (size + gap)).astype(np.int64), 0, cols - 1)
    cz = np.clip((inward[:, 2] // (size + gap)).astype(np.int64), 0, rows - 1)
    tri_room_c = (cz * cols + cx).astype(np.int32)

    all_segs = np.concatenate(
        [lay.segs.astype(np.float64)]
        + ([np.stack(segs_new)] if segs_new else []),
        axis=0,
    )
    seg_codes = np.concatenate([
        np.full(lay.segs.shape[0], -1, np.int32),
        np.asarray(seg_codes_new, np.int32),
    ])
    room_segs, room_seg_wall = _room_local_segs(world, all_segs, seg_codes)

    tri_wall = np.concatenate([
        np.full(s_open, -1, np.int32),
        np.asarray(walls_of, np.int32),
    ])
    # Junction-content codes: compile_world orders rooms cells-first,
    # junction of wall w = room n_cells + w (asserted above), so the
    # open compile's tri_room column already carries the wall id.
    tri_jwall = np.concatenate([
        np.where(lay.tri_room >= n_cells, lay.tri_room - n_cells, -1
                 ).astype(np.int32),
        np.full(n_closed, -1, np.int32),
    ])
    room_wall = np.concatenate([
        np.full(n_cells, -1, np.int32),
        np.arange(n_walls, dtype=np.int32),
    ])

    # --- paired render bank (Layout.pg_*): the render scan's hot path.
    # Per wall w, EXACTLY ONE of {its junction content (4 prims), its
    # closed-wall quads (2 prims)} exists in any episode — store the
    # closed quads as the ALT variant of 2 of the wall's 4 junction
    # rows (other 2 alt rows degenerate) and select per env in-chunk.
    # Sp = cells + 4*walls rows vs the dense bank's cells + 4*walls +
    # 2*walls: 27% fewer hit-test rows and zero inactive ones. The
    # dense arrays below remain for top view / get_visible_ents.
    sp = s_open
    sel_wall = np.where(lay.tri_room >= n_cells,
                        lay.tri_room - n_cells, -1).astype(np.int32)
    pg_v9_alt = np.zeros((9, sp), np.float32)
    pg_attr_alt = np.zeros((sp, lay.tri_attr.shape[1]), np.float32)
    # [variant 0=primary, 1=alt] x [tex ids | atlas base | variant cnt]
    pg_tex = np.zeros((2, 3, sp), np.float32)
    pg_tex[0, 0] = lay.tri_tex.astype(np.float32)
    pg_tex[0, 1] = lay.tri_tex_base
    pg_tex[0, 2] = lay.tri_tex_count
    pg_tex[1, 1] = -1.0  # degenerate alt rows: flat
    pg_tex[1, 2] = 1.0
    closed9 = np.ascontiguousarray(tri_verts_c.reshape(n_closed, 9).T)
    walls_arr = np.asarray(walls_of, np.int32)
    for w in range(n_walls):
        slots = np.where(sel_wall == w)[0]
        rows = np.where(walls_arr == w)[0]
        assert len(slots) == 4 and len(rows) == 2, (w, len(slots), len(rows))
        for k, row in enumerate(rows):
            s = slots[k]
            pg_v9_alt[:, s] = closed9[:, row]
            pg_attr_alt[s] = tri_attr_c[row]
            pg_tex[1, 0, s] = float(tri_tex_c[row])
            pg_tex[1, 1, s] = base_c[row]
            pg_tex[1, 2, s] = count_c[row]
    pg_sel_base = (sel_wall < 0).astype(np.float32)
    pg_sel_onehot = (
        sel_wall[None, :] == np.arange(n_walls, dtype=np.int32)[:, None]
    ).astype(np.float32)

    lay = dataclasses.replace(
        lay,
        pg_verts9=lay.tri_verts9.copy(),
        pg_attr=lay.tri_attr.copy(),
        pg_verts9_alt=pg_v9_alt,
        pg_attr_alt=pg_attr_alt,
        pg_sel_base=pg_sel_base,
        pg_sel_onehot=pg_sel_onehot,
        pg_tex=pg_tex,
        tri_verts=np.concatenate([lay.tri_verts, tri_verts_c]),
        tri_verts9=np.concatenate(
            [lay.tri_verts9,
             np.ascontiguousarray(tri_verts_c.reshape(n_closed, 9).T)],
            axis=1,
        ),
        tri_attr=np.concatenate([lay.tri_attr, tri_attr_c]),
        tri_uv=np.concatenate([lay.tri_uv, tri_uv_c]),
        tri_normal=np.concatenate([lay.tri_normal, tri_normal_c]),
        tri_tex=np.concatenate([lay.tri_tex, tri_tex_c]),
        tri_tex_base=np.concatenate([lay.tri_tex_base, base_c]),
        tri_tex_count=np.concatenate([lay.tri_tex_count, count_c]),
        tri_color=np.concatenate([lay.tri_color, tri_color_c]),
        tri_mask=np.concatenate([lay.tri_mask, np.ones(n_closed, bool)]),
        tri_room=np.concatenate([lay.tri_room, tri_room_c]),
        tri_is_room=np.concatenate([lay.tri_is_room, np.ones(n_closed, bool)]),
        segs=all_segs.astype(np.float32),
        seg_mask=np.ones(all_segs.shape[0], bool),
        room_segs=room_segs,
        tri_wall=tri_wall,
        tri_jwall=tri_jwall,
        room_seg_wall=room_seg_wall,
        room_wall=room_wall,
    )
    return lay


def finalize_super_bank(bank: Layout, lay: Layout, n_walls: int) -> Layout:
    """Re-attach the procgen fields after stacking (Layout.pad_to only
    handles the standard fields, like the pvs_* pattern) and build the
    signed (L, W, S) activity matrix. Pad tris/segs/rooms get code -1 =
    unconditional (pad tris are degenerate and never hit anyway)."""
    L, S = bank.tri_mask.shape
    R, NS = bank.room_segs.shape[1], bank.room_segs.shape[3]

    def pad_to(arr, shape, fill):
        out = np.full(shape, fill, arr.dtype)
        out[tuple(slice(0, s) for s in arr.shape)] = arr
        return out

    tw = pad_to(lay.tri_wall, (S,), -1)[None].repeat(L, 0)
    tj = pad_to(lay.tri_jwall, (S,), -1)[None].repeat(L, 0)
    rsw = pad_to(lay.room_seg_wall, (R, NS), -1)[None].repeat(L, 0)
    rw = pad_to(lay.room_wall, (R,), -1)[None].repeat(L, 0)
    wids = np.arange(n_walls, dtype=np.int32)[None, :, None]
    # active = base + wall_open @ K, exact 0/1 in f32:
    #   closed quad (tri_wall=w):   base 1, K[w]=-1 -> 1 - open_w
    #   junction tri (tri_jwall=w): base 0, K[w]=+1 -> open_w
    #   unconditional:              base 1, K zero  -> 1
    onehot = (tj[:, None, :] == wids).astype(np.float32) \
        - (tw[:, None, :] == wids).astype(np.float32)
    base = 1.0 - (tj >= 0).astype(np.float32)
    return dataclasses.replace(
        bank, tri_wall=tw, tri_jwall=tj, tri_active_base=base,
        tri_wall_onehot=onehot, room_seg_wall=rsw, room_wall=rw,
        # paired render bank (built in compile_super_maze; stacking
        # drops the optional fields like the pvs_* pattern)
        pg_verts9=lay.pg_verts9[None],
        pg_attr=lay.pg_attr[None],
        pg_verts9_alt=lay.pg_verts9_alt[None],
        pg_attr_alt=lay.pg_attr_alt[None],
        pg_sel_base=lay.pg_sel_base[None],
        pg_sel_onehot=lay.pg_sel_onehot[None],
        pg_tex=lay.pg_tex[None],
    )

"""Vectorized MiniWorld on PyTorch: a batch of envs stepped, auto-reset
and rendered on one device.

Counterpart of ``miniworld_tpu/vector.py``. The host half (bank
compilation and its chunk planners) is numpy, shared in logic with the
JAX package; the engine half runs every env together on batch-major
tensors — the JAX package's ``vmap`` is the leading axis B, its
``lax.scan`` over steps a Python loop:

    env = MiniWorldVec("MiniWorld-Hallway-v0", 1024)  # device="cuda"
    state, (obs, depth) = env.reset(seed=0)
    state, (obs, depth), reward, done, info = env.step(state, actions)
    key = rng_ops.key_data(1, "cuda")
    state, (obs, depth), outs = env.rollout(state, (obs, depth), key, 50)

On ``done`` an env auto-resets and ``obs`` is the first observation of
the new episode. Resets draw from the same threefry keys and
counter-based uniforms as the JAX package (ops/rng.py), so the two
packages step the same envs through the same episodes.

The port covers all 27 env ids of the JAX package (``envs.ENV_IDS``):
one layout bank rendered in the JAX package's chunk plan for its
``tri_chunk`` (one chunk, a dense or paired multi-chunk scan, or a
schedule of chunks per env: packed PVS, ``chunk_vis``, or a dense scan
seeded by mesh entities; ``install_statics``), Fourier textures
with Sign's SDF glyphs and its dict observations, or the exact nearest
texels of the u8 atlas (``tex_mode="nearest"``), analytic and mesh
entities, procgen mazes — a fresh maze per reset on the device
(``procgen``, the Maze family's default), rendered from the paired
super bank — domain randomization (``domain_rand``: the
per-episode and per-step parameter draws and each episode's texture
variants), ``supersample=2``, the raw 6-D actions of the specs
without a discrete table (RoomObjects, PutNext, CollectHealth, whose
step re-places a kit through ``place_one``), the camera ids' own
physics, reset and overlay (CameraControl, CameraControlClick: the spec's
``apply_action``, ``post_reset`` and ``post_render``), the orthographic top
view as the observation (``view="top"``, render/topview.py), the
entity-visibility query (``visible_ents``, render/visibility.py) and the
layout-bank refresh (``prepare_bank``, ``install_bank``,
``refresh_layouts``: fresh layouts from another ``bank_seed`` in the
installed chunk plan).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from miniworld_tpu_torch.convert import atlas_from_numpy, layout_from_numpy
from miniworld_tpu_torch.envs.base import Ctx, EnvSpec
from miniworld_tpu_torch.ops import mazegen, physics, place as place_ops, rng as rng_ops
from miniworld_tpu_torch.render.raycast import (
    camera_grid, chunk_starts, fourier_table, render_rgbd, room_of_point, wall_codes,
)
from miniworld_tpu_torch.render.textures import FOURIER_TERMS, TextureCatalog
from miniworld_tpu_torch.render.topview import render_top_view, top_statics
from miniworld_tpu_torch.render.visibility import vis_statics, visible_ents, visible_ents_plain
from miniworld_tpu_torch.scene.compile import Layout, compile_world, stack_layouts
from miniworld_tpu_torch.scene.entities import (
    SHAPE_BOX, SHAPE_MESH_BOX, SHAPE_MESH_TRIS, SHAPE_SPHERE,
)
from miniworld_tpu_torch.scene.world import World
from miniworld_tpu_torch.state import EnvState, StepResult, tree_select

# The JAX package's per-chunk scan overhead in prim equivalents
# (miniworld_tpu/vector.py _CHUNK_OVERHEAD_TRIS), fitted on its TPU. It
# decides the JAX package's chunk plan, which the port reproduces
# (``plan_chunks``) because the split decides quantized-depth ties.
JAX_CHUNK_OVERHEAD_TRIS = 56
# The z-key's row budget (render/raycast._IDX_BITS): the most prims one
# chunk can hold.
MAX_CHUNK = 1024
# The per-episode parameters a reset draws, in the order of the JAX
# package's ``_reset_one`` (its rows of the (8, 3) uniforms), and the
# per-step ones (``_step_one``'s ``split(k_params, 3)``).
RESET_PARAMS = ("sky_color", "light_pos", "light_color", "light_ambient",
                "cam_height", "cam_fwd_disp", "cam_pitch", "cam_fov_y")
STEP_PARAMS = ("forward_step", "forward_drift", "turn_step")


def _tex_table(catalog: TextureCatalog, fourier_k: int, tex_mode: str) -> np.ndarray:
    """The mode's texture table: the Fourier coefficients at ``fourier_k``
    terms, or the (N, R, R, 3) u8 atlas in nearest mode (JAX vector.py:
    85-88, 116-119)."""
    if tex_mode == "nearest":
        return catalog.build_atlas()
    return catalog.build_fourier(fourier_k)


def _fourier_k(spec: EnvSpec, fourier_k: int | None) -> int:
    """``fourier_k``, or the spec's own (Sign's 64), or FOURIER_TERMS."""
    return fourier_k or spec.fourier_k or FOURIER_TERMS


def bank_sizes(bank_np: Layout) -> dict:
    """The padded axis sizes of a stacked bank, before any repad for a
    chunk plan (``Layout.sizes`` without the layout axis): the
    ``min_sizes`` a refreshed bank is padded to (JAX vector.py:111-114)."""
    return dict(S=bank_np.tri_verts.shape[1], W=bank_np.segs.shape[1],
                NS=bank_np.room_segs.shape[3], R=bank_np.room_outline.shape[1],
                V=bank_np.room_outline.shape[2], P=bank_np.proto_shape.shape[1],
                M=bank_np.proto_mesh.shape[2], E=bank_np.slot_protos.shape[1],
                C=bank_np.slot_protos.shape[2], T=bank_np.tex_slot_base.shape[1])


def build_bank(spec: EnvSpec, tex_mode: str = "fourier", *, bank_seed: int = 0,
               fourier_k: int | None = None, min_sizes: dict | None = None):
    """Compile the spec's layout bank + texture table (host side), the
    JAX package's ``build_bank`` (vector.py:58-98; there ``bank_seed``
    is the second positional argument): ``spec.num_layouts`` layouts,
    layout i built from ``SeedSequence(bank_seed).spawn(n)[i]``, padded
    to at least ``min_sizes`` (a refresh passes the installed bank's
    ``bank_sizes``). ``fourier_k`` None: the spec's own or FOURIER_TERMS.
    Returns (bank, tex table): the Fourier table, or the u8 atlas in
    nearest mode (the JAX function also returns the sizes: ``bank_sizes``
    of the bank).
    """
    if tex_mode not in ("fourier", "nearest"):
        raise ValueError(f"tex_mode must be 'fourier' or 'nearest', got {tex_mode!r}")
    catalog = TextureCatalog()
    layouts = []
    seeds = np.random.SeedSequence(bank_seed).spawn(spec.num_layouts)
    for li in range(spec.num_layouts):
        world = World(catalog)
        world.agent_radius = spec.agent_radius
        spec.build(world, None, layout_rng=np.random.default_rng(seeds[li]),
                   layout_idx=li)
        layouts.append(compile_world(world, with_pvs=True))
    return (stack_layouts(layouts, min_sizes=min_sizes),
            _tex_table(catalog, _fourier_k(spec, fourier_k), tex_mode))


def widen_atlas(bank_np: Layout, tex_np: np.ndarray, min_rows: int = 257):
    """The bank and Fourier table of a texture catalog of more than 256
    rows, for any bank (the JAX package's too: a dataclass of the same
    fields): ``tex_np`` tiled until its rows reach ``min_rows`` plus one
    more copy, and every slot's atlas base (``tri_tex_base``,
    ``tex_slot_base``, a paired bank's ``pg_tex`` bases, packed copies'
    ``pvs_tri_tex_base``) moved into the last copy, at least
    ``min_rows`` rows up. The world and its texels are unchanged; every
    atlas row the render carries is above 256, so the attribute carry is
    float32 (``raycast.attr_carry_dtype``)."""
    n = tex_np.shape[0]
    copies = -(-min_rows // n) + 1
    shift = (copies - 1) * n

    def up(a):
        return None if a is None else np.where(a >= 0, a + shift, a).astype(a.dtype)

    repl = dict(tri_tex_base=up(bank_np.tri_tex_base), tex_slot_base=up(bank_np.tex_slot_base),
                pvs_tri_tex_base=up(bank_np.pvs_tri_tex_base))
    if bank_np.pg_tex is not None:  # (L, 2, 3, Sp): [variant][ids | base | count]
        pg_tex = bank_np.pg_tex.copy()
        pg_tex[:, :, 1] = up(pg_tex[:, :, 1])
        repl["pg_tex"] = pg_tex
    return (dataclasses.replace(bank_np, **repl),
            np.ascontiguousarray(np.concatenate([tex_np] * copies), tex_np.dtype))


def raise_slot_ids(bank_np: Layout, shift: int = 257):
    """The bank with every layout-local texture slot id moved ``shift`` up
    (slots 0 to shift - 1 unused, atlas row 0, one variant), for any bank
    as ``widen_atlas``: the slot columns of the prim rows (``tri_attr``,
    a paired bank's ``pg_attr`` / ``pg_attr_alt``, packed copies'
    ``pvs_attr``), ``tri_tex`` (and ``pvs_tri_tex``, the paired
    ``pg_tex`` ids), the mesh prototypes' slot column and the
    ``tex_slot_base`` / ``tex_slot_count`` tables. In nearest mode the
    world renders the same texels with more than 256 slot ids, so the
    attribute carry is float32 (``raycast.attr_carry_dtype``)."""
    def up(a):
        return None if a is None else np.where(a >= 0, a + shift, a).astype(a.dtype)

    def slot_col(a, col):
        if a is None:
            return None
        a = a.copy()
        a[..., col] = up(a[..., col])
        return a

    L = bank_np.tex_slot_base.shape[0]
    repl = dict(
        tri_attr=slot_col(bank_np.tri_attr, 14), tri_tex=up(bank_np.tri_tex),
        pvs_attr=slot_col(bank_np.pvs_attr, 14), pvs_tri_tex=up(bank_np.pvs_tri_tex),
        pg_attr=slot_col(bank_np.pg_attr, 14), pg_attr_alt=slot_col(bank_np.pg_attr_alt, 14),
        tex_slot_base=np.concatenate([np.zeros((L, shift), bank_np.tex_slot_base.dtype),
                                      bank_np.tex_slot_base], axis=1),
        tex_slot_count=np.concatenate([np.ones((L, shift), bank_np.tex_slot_count.dtype),
                                       bank_np.tex_slot_count], axis=1))
    mesh = bank_np.proto_mesh.copy()  # (L, P, M, 25), slot id in column 23
    mesh[..., 23] = np.where(bank_np.proto_mesh_mask, up(mesh[..., 23]), mesh[..., 23])
    repl["proto_mesh"] = mesh
    if bank_np.pg_tex is not None:
        pg_tex = bank_np.pg_tex.copy()
        pg_tex[:, :, 0] = up(pg_tex[:, :, 0])
        repl["pg_tex"] = pg_tex
    return dataclasses.replace(bank_np, **repl)


# the paired rows of a procgen super bank (Layout.pg_*, scene/supermaze.py)
PAIRED_FIELDS = ("pg_verts9", "pg_attr", "pg_verts9_alt", "pg_attr_alt", "pg_sel_base",
                 "pg_sel_onehot", "pg_tex")


def drop_paired_rows(bank_np: Layout):
    """A procgen super bank without its paired rows, for any bank as
    ``widen_atlas``: its render scans the dense rows, each env's killed by
    its maze (the JAX package's ``tri_active``, raycast.py:1220-1227)."""
    return dataclasses.replace(bank_np, **{f: None for f in PAIRED_FIELDS})


def build_super_bank(spec: EnvSpec, tex_mode: str = "fourier", fourier_k: int | None = None):
    """Compile the spec's maze grid into a procgen super bank (host
    side): one layout holding every wall variant (scene/supermaze.py);
    each env's maze is a wall-open bitmask generated at reset
    (ops/mazegen.py). Returns (bank, tex table) like ``build_bank``."""
    from miniworld_tpu_torch.scene.supermaze import compile_super_maze, finalize_super_bank

    catalog = TextureCatalog()
    lay = compile_super_maze(spec, catalog)
    bank_np = finalize_super_bank(stack_layouts([lay]), lay,
                                  mazegen.num_walls(spec.num_rows, spec.num_cols))
    return bank_np, _tex_table(catalog, _fourier_k(spec, fourier_k), tex_mode)


def _round_up16(n: int) -> int:
    return -(-int(n) // 16) * 16


def _chunk_visibility(bank_np: Layout, chunk: int) -> np.ndarray:
    """(L, n_chunks, R) bool: chunk c needed when rendering from room r.

    Mirrors the scan's chunk mapping exactly (last chunk clamps to
    [S - chunk, S)). A chunk is needed from room r if it contains an
    always-visible triangle or any triangle of a room in PVS(r).
    """
    tri_room, tri_mask = bank_np.tri_room, bank_np.tri_mask
    pvs = bank_np.room_pvs
    num_layouts, S = tri_room.shape
    n_chunks = -(-S // chunk)
    R = pvs.shape[1]
    vis = np.zeros((num_layouts, n_chunks, R), dtype=bool)
    for li in range(num_layouts):
        for c in range(n_chunks):
            start = min(c * chunk, S - chunk)
            rooms = tri_room[li, start:start + chunk]
            rooms = rooms[tri_mask[li, start:start + chunk]]
            if (rooms == -1).any():
                vis[li, c, :] = True
                continue
            rset = np.unique(rooms[rooms >= 0])
            if len(rset):
                vis[li, c, :] = pvs[li][:, rset].any(axis=1)
    return vis


def _repad_for_chunks(bank_np: Layout, chunk: int) -> Layout:
    """Pad the bank's triangle axis to a multiple of ``chunk``.

    Aligned chunks let the render scan slice without clamping and view
    per-tri episode state as clean (n_chunks, chunk) rows
    (raycast._tri_pass). Padding rows are masked out.
    """
    import dataclasses as _dc

    S = bank_np.tri_mask.shape[1]
    S2 = -(-S // chunk) * chunk
    if S2 == S:
        return bank_np
    pad = S2 - S

    def p(arr, axis, fill):
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        return np.pad(arr, widths, constant_values=fill)

    extra = {}
    if bank_np.tri_wall is not None:
        extra["tri_wall"] = p(bank_np.tri_wall, 1, -1)
        extra["tri_jwall"] = p(bank_np.tri_jwall, 1, -1)
        extra["tri_active_base"] = p(bank_np.tri_active_base, 1, 1.0)
        extra["tri_wall_onehot"] = p(bank_np.tri_wall_onehot, 2, 0.0)
    return _dc.replace(
        bank_np,
        tri_verts=p(bank_np.tri_verts, 1, 0.0),
        tri_verts9=p(bank_np.tri_verts9, 2, 0.0),
        tri_attr=p(bank_np.tri_attr, 1, 0.0),
        tri_uv=p(bank_np.tri_uv, 1, 0.0),
        tri_normal=p(bank_np.tri_normal, 1, 0.0),
        tri_tex=p(bank_np.tri_tex, 1, -1),
        tri_tex_base=p(bank_np.tri_tex_base, 1, -1.0),
        tri_tex_count=p(bank_np.tri_tex_count, 1, 1.0),
        tri_color=p(bank_np.tri_color, 1, 0.0),
        tri_mask=p(bank_np.tri_mask, 1, False),
        tri_room=p(bank_np.tri_room, 1, -2),
        tri_is_room=p(bank_np.tri_is_room, 1, False),
        **extra,
    )


def plan_culling(bank_np: Layout, chunk_cap: int, overhead_tris: int):
    """Choose (chunk_vis, tri_chunk, sched_len) for PVS chunk culling.

    Tries chunk sizes and picks the one minimizing the modeled scan
    cost ``worst_case_active_chunks * (chunk + overhead_tris)``, where
    ``overhead_tris`` is the fixed cost of one chunk iteration in prim
    equivalents — a property of the device and the render code, so the
    caller measures and passes it (the JAX package's value was fitted
    on its TPU and does not carry over); returns
    (None, chunk_cap, None) when full scans are at least as cheap
    (single-room scenes, open-air scenes, tiny banks).
    """
    pvs, room_mask = bank_np.room_pvs, bank_np.room_mask
    S = bank_np.tri_room.shape[1]
    full_k = min(chunk_cap, S)
    if all(pvs[li][np.ix_(m, m)].all()
           for li, m in enumerate(room_mask)):
        return None, full_k, None

    candidates = [k for k in (16, 32, 48, 64, 96, 128, 160, 192, 224, 256)
                  if k <= full_k] or [full_k]
    best = (None, full_k, None)
    # baseline: the full scan at its EFFECTIVE chunk (clamped to S —
    # using the raw cap here made a useless 2-chunk culling plan beat
    # a single-chunk full scan on MazeS3 once quads shrank S below it)
    best_cost = (-(-S // full_k)) * (full_k + overhead_tris)
    for k in candidates:
        vis = _chunk_visibility(bank_np, k)
        # worst case over (layout, valid room) of active chunk count
        bound = 1
        for li in range(vis.shape[0]):
            counts = vis[li].sum(axis=0)[room_mask[li]]
            if counts.size:
                bound = max(bound, int(counts.max()))
        cost = bound * (k + overhead_tris)
        if cost < best_cost:
            best_cost = cost
            best = (vis, k, bound)
    return best


def plan_packed_pvs(bank_np: Layout, chunk_cap: int, overhead_tris: int,
                    max_bytes: int = 768 << 20,
                    force_k: int | None = None):
    """Plan packed per-room PVS banks (the space-time alternative to
    chunk_vis culling).

    chunk_vis culling visits every chunk CONTAINING a visible triangle;
    because a room's PVS is scattered over the bank (a maze corridor's
    visible set is a row segment plus a column segment — no 1-D
    triangle order keeps both contiguous), the worst-case schedule
    covers more triangles than the PVS itself. Packing every
    room's visible set CONTIGUOUSLY (duplicating shared triangles, with
    identical visible-sets deduped) removes that slack: the schedule
    becomes ``room_base + arange(sched_len)``.

    Returns (packed dict | None, tri_chunk, sched_len, modeled_cost);
    None when a single region covers everything (no culling value) or
    the duplicated bank copies would exceed ``max_bytes``.
    The copies change which rows share a chunk and their indices within
    it, and so which row wins a tie at equal quantized depth: a render
    of this plan scans the packed chunks (vector.install_statics).
    """
    pvs, room_mask = bank_np.room_pvs, bank_np.room_mask
    if all(pvs[li][np.ix_(m, m)].all() for li, m in enumerate(room_mask)):
        return None, chunk_cap, None, np.inf

    L, S = bank_np.tri_room.shape

    # Per-layout room triangle index lists + per-room visible sets
    # (shared across chunk-size candidates).
    layouts = []
    p_max = 1  # largest single visible set, in triangles
    for li in range(L):
        tri_room, mask = bank_np.tri_room[li], bank_np.tri_mask[li]
        glob = np.where((tri_room == -1) & mask)[0]
        rooms = np.where(room_mask[li])[0]
        tris_of = {r: np.where((tri_room == r) & mask)[0] for r in rooms}
        vsets = {}  # frozenset of visible rooms -> region id
        room_vset = {}
        for r in rooms:
            key = frozenset(np.where(pvs[li][r] & room_mask[li])[0].tolist())
            room_vset[r] = key
            vsets.setdefault(key, len(vsets))
            p_max = max(p_max, len(glob) + sum(len(tris_of[q]) for q in key))
        layouts.append((glob, rooms, tris_of, vsets, room_vset))

    if force_k is not None:  # refresh path: reuse the planned chunk
        candidates = [force_k]
    else:
        # fixed ladder + the chunk sizes that cover the WORST visible
        # set in exactly 1 or 2 scan iterations
        ladder = [32, 48, 64, 96, 128, 160, 192, 224, 256,
                  _round_up16(-(-p_max // 2)), _round_up16(p_max)]
        candidates = sorted({k for k in ladder
                             if 16 <= k <= min(chunk_cap, S)}) \
            or [min(chunk_cap, S)]

    best = (None, chunk_cap, None, np.inf)
    for k in candidates:
        sched_len = 1
        s2_max = 0
        for glob, rooms, tris_of, vsets, room_vset in layouts:
            s2 = 0
            for key in vsets:
                n = len(glob) + sum(len(tris_of[r]) for r in key)
                n_chunks = max(-(-n // k), 1)
                sched_len = max(sched_len, n_chunks)
                s2 += n_chunks * k
            s2_max = max(s2_max, s2)
        cost = sched_len * (k + overhead_tris)
        # bank copies: verts9(9f) + attr(16f) + tex id/base/count(3f)
        bytes_needed = L * s2_max * 28 * 4
        if cost < best[3] and bytes_needed <= max_bytes:
            best = (k, sched_len, s2_max, cost)

    if best[0] is None:
        return None, chunk_cap, None, np.inf
    k, sched_len, s2_max, cost = best

    R = bank_np.room_mask.shape[1]
    verts9 = np.zeros((L, 9, s2_max), np.float32)
    attr = np.zeros((L, s2_max, bank_np.tri_attr.shape[2]), np.float32)
    tri_tex = np.full((L, s2_max), -1, np.int32)
    tri_tex_base = np.full((L, s2_max), -1.0, np.float32)
    tri_tex_count = np.ones((L, s2_max), np.float32)
    room_base = np.zeros((L, R), np.int32)
    room_nchunks = np.ones((L, R), np.int32)
    for li, (glob, rooms, tris_of, vsets, room_vset) in enumerate(layouts):
        region_base = {}
        region_nchunks = {}
        pos = 0
        # room centers for near-to-far region ordering (an occlusion
        # early-out can skip a chunk once every pixel's z-carry beats
        # its nearest depth, which only pays when nearer rooms render
        # first; the z-competition itself is order-invariant)
        ra = bank_np.room_aabb[li]
        centers = np.stack(
            [(ra[:, 0] + ra[:, 1]) * 0.5, (ra[:, 2] + ra[:, 3]) * 0.5],
            axis=1,
        )
        for key, _rid in vsets.items():
            reps = [r for r in rooms if room_vset[r] == key]
            # Nearest-neighbor CHAIN from the representative room, not
            # a plain distance sort: rooms at equal radius ring the
            # representative, and a sort puts opposite sides of the
            # ring in consecutive chunks — their AABBs then span the
            # whole scene and neither the occlusion early-out nor the
            # tile wedge test can ever fire. The chain keeps
            # consecutive rooms spatially contiguous (corridors pack
            # in walk order) while still starting at the camera's room.
            cur_pt = centers[reps[0]] if reps else centers[0]
            remaining = set(key)
            order = []
            while remaining:
                nxt = min(
                    remaining,
                    key=lambda r: (
                        float(np.sum((centers[r] - cur_pt) ** 2)), r,
                    ),
                )
                order.append(nxt)
                remaining.discard(nxt)
                cur_pt = centers[nxt]
            idx = np.concatenate(
                [glob] + [tris_of[r] for r in order]
            ).astype(np.int64) if (len(glob) or key) else np.zeros(0, np.int64)
            n_chunks = max(-(-len(idx) // k), 1)
            region_base[key] = pos // k
            region_nchunks[key] = n_chunks
            verts9[li, :, pos:pos + len(idx)] = bank_np.tri_verts9[li][:, idx]
            attr[li, pos:pos + len(idx)] = bank_np.tri_attr[li][idx]
            tri_tex[li, pos:pos + len(idx)] = bank_np.tri_tex[li][idx]
            tri_tex_base[li, pos:pos + len(idx)] = bank_np.tri_tex_base[li][idx]
            tri_tex_count[li, pos:pos + len(idx)] = bank_np.tri_tex_count[li][idx]
            pos += n_chunks * k
        for r in rooms:
            room_base[li, r] = region_base[room_vset[r]]
            room_nchunks[li, r] = region_nchunks[room_vset[r]]
    packed = dict(
        pvs_verts9=verts9, pvs_attr=attr, pvs_tri_tex=tri_tex,
        pvs_tri_tex_base=tri_tex_base, pvs_tri_tex_count=tri_tex_count,
        pvs_room_base=room_base, pvs_room_nchunks=room_nchunks,
    )
    return packed, k, sched_len, cost


def chunk_cap(num_envs: int, hw: int) -> int:
    """The JAX package's largest prim chunk for a batch of ``num_envs``
    envs rendering ``hw`` pixels each (``MiniWorldVec._chunk_cap``,
    miniworld_tpu/vector.py:470-489): a runaway guard on its (B', HW,
    chunk) f32 intermediates, B' = min(B, 1024), in multiples of 16, at
    most 1024 (the z-key's row budget)."""
    auto = int(4e10 / 4 / max(min(int(num_envs), 1024) * int(hw), 1))
    return min((auto // 16) * 16 or 16, MAX_CHUNK)


def plan_chunks(bank_np: Layout, num_envs: int, hw: int, tri_chunk: int | None = None):
    """The JAX package's chunk plan for a fresh bank (``_install_bank``
    with ``fresh=True``, miniworld_tpu/vector.py:573-625), from the port's
    copies of its planners at its per-chunk overhead. ``tri_chunk`` is the
    JAX constructor's argument (vector.py:488-490): the culling planner
    gets ``max(16, min(tri_chunk or cap, cap))``; the packed planner and
    the dense fallback still get the cap.

    Returns (bank repadded to a multiple of ``tri_chunk``, with the
    packed copies for "packed_pvs"; plan dict): ``kind`` "dense" (full
    scans of S / tri_chunk chunks), "packed_pvs" (per-room visible sets
    packed contiguously, ``sched_len`` chunks a render from the camera
    room's ``pvs_room_base``) or "chunk_vis" (the chunks visible from
    the camera's room, ``sched_len`` at most, the (L, NC, R) bool
    ``chunk_vis`` of ``_chunk_visibility``); ``tri_chunk``; ``sched_len``
    (None for dense); ``nc``, the chunks of a layout (of its packed copies
    for "packed_pvs"); ``cap``, the chunk cap.
    """
    cap = chunk_cap(num_envs, hw)
    s_nat = bank_np.tri_mask.shape[1]
    cull_cap = max(16, min(tri_chunk or cap, cap))
    _, chunks_k, chunks_bound = plan_culling(bank_np, cull_cap, JAX_CHUNK_OVERHEAD_TRIS)
    if chunks_bound is not None:
        chunks_cost = chunks_bound * (chunks_k + JAX_CHUNK_OVERHEAD_TRIS)
    else:
        chunks_cost = (-(-s_nat // chunks_k)) * (chunks_k + JAX_CHUNK_OVERHEAD_TRIS)
    packed, packed_k, packed_sched, packed_cost = plan_packed_pvs(
        bank_np, cap, JAX_CHUNK_OVERHEAD_TRIS)
    plan = dict(kind="dense", tri_chunk=None, sched_len=None, cap=cap)
    if packed is not None and packed_cost < chunks_cost:
        plan.update(kind="packed_pvs", tri_chunk=packed_k, sched_len=packed_sched,
                    nc=packed["pvs_verts9"].shape[2] // packed_k)
        return dataclasses.replace(_repad_for_chunks(bank_np, packed_k), **packed), plan
    tri_chunk = min(chunks_k, s_nat)
    trial = _repad_for_chunks(bank_np, tri_chunk)
    vis = _chunk_visibility(trial, tri_chunk)
    bound = _worst_schedule(vis, trial.room_mask)
    if bound < vis.shape[1]:
        plan.update(kind="chunk_vis", tri_chunk=tri_chunk, sched_len=bound, nc=vis.shape[1],
                    chunk_vis=vis)
        return trial, plan
    plan["tri_chunk"] = min(cap, s_nat)
    bank_np = _repad_for_chunks(bank_np, plan["tri_chunk"])
    plan["nc"] = bank_np.tri_mask.shape[1] // plan["tri_chunk"]
    return bank_np, plan


def _worst_schedule(vis: np.ndarray, room_mask: np.ndarray) -> int:
    """The most chunks ``_chunk_visibility``'s ``vis`` lets one valid
    room of a layout see (at least 1)."""
    bound = 1
    for li in range(vis.shape[0]):
        counts = vis[li].sum(axis=0)[room_mask[li]]
        if counts.size:
            bound = max(bound, int(counts.max()))
    return bound


def replan_chunks(bank_np: Layout, plan: dict, installed: Layout):
    """A refreshed bank in the installed ``plan`` (the JAX package's
    ``_install_bank`` with ``fresh=False``, vector.py:627-687): the same
    kind and chunk size, nothing re-planned. Packed PVS packs the new
    visible sets at the installed chunk (``force_k``) and pads the packed
    copies to the ``installed`` bank's length when they come out shorter,
    so the chunk count NC stays (a longer packing grows it, as in the JAX
    package); ``chunk_vis`` takes the new bank's visibility; a schedule
    keeps its length unless the new worst case is longer. Returns (bank
    repadded to the chunk, the updated plan: ``nc``, ``sched_len``,
    ``chunk_vis``; ``chunk_starts`` is made by the caller)."""
    plan = {k: v for k, v in plan.items() if k != "chunk_starts"}
    k = plan["tri_chunk"]
    if plan["kind"] == "packed_pvs":
        packed, _, sched_len, _ = plan_packed_pvs(bank_np, k, JAX_CHUNK_OVERHEAD_TRIS, force_k=k)
        if packed is None:
            raise ValueError("the refreshed bank has no packed-PVS plan at the installed chunk")
        pad = installed.pvs_attr.shape[1] - packed["pvs_attr"].shape[1]
        if pad > 0:
            fills = dict(pvs_verts9=(2, 0.0), pvs_attr=(1, 0.0), pvs_tri_tex=(1, -1),
                         pvs_tri_tex_base=(1, -1.0), pvs_tri_tex_count=(1, 1.0))
            for name, (axis, fill) in fills.items():
                widths = [(0, 0)] * packed[name].ndim
                widths[axis] = (0, pad)
                packed[name] = np.pad(packed[name], widths, constant_values=fill)
        plan.update(sched_len=max(plan["sched_len"], sched_len),
                    nc=packed["pvs_verts9"].shape[2] // k)
        return dataclasses.replace(_repad_for_chunks(bank_np, k), **packed), plan
    bank_np = _repad_for_chunks(bank_np, k)
    if plan["kind"] == "chunk_vis":
        vis = _chunk_visibility(bank_np, k)
        plan.update(sched_len=max(plan["sched_len"], _worst_schedule(vis, bank_np.room_mask)),
                    nc=vis.shape[1], chunk_vis=vis)
    else:
        plan["nc"] = bank_np.tri_mask.shape[1] // k
    return bank_np, plan


def chunk_row_views(verts9: np.ndarray, attr: np.ndarray, k: int):
    """A bank (L, 9, NC * k) f32, (L, NC * k, 16) f32 as rows of one chunk
    each, (L * NC, 9 * k) and (L * NC, k * 16): row ``layout * NC + c``
    holds chunk c of that layout, which a schedule reads as (L * NC, 9, k)
    and (L * NC, k, 16) banks of one chunk (raycast.static_rows)."""
    L, _, s = verts9.shape
    nc = s // k
    return (np.ascontiguousarray(verts9.reshape(L, 9, nc, k).transpose(0, 2, 1, 3)
                                 .reshape(L * nc, 9 * k)),
            np.ascontiguousarray(attr.reshape(L * nc, -1)))


def install_statics(bank_np: Layout, tex_np: np.ndarray, num_envs: int, hw: int,
                    domain_rand: bool = False, tex_mode: str = "fourier", view: str = "agent",
                    tri_chunk: int | None = None, replan=None):
    """The static decisions of the JAX package's ``_install_bank`` for
    a fresh bank, for a batch of ``num_envs`` envs rendering ``hw``
    pixels each (the supersampled count with supersample=2), the culling
    planner's chunk capped by ``tri_chunk`` (``plan_chunks``); for a
    refreshed bank with ``replan`` = (the installed plan, the installed
    bank), the installed plan (``replan_chunks``).

    Returns (bank, statics dict): the bank repadded for its chunk plan
    (``plan_chunks``), and ``plan`` (with ``chunk_starts``, the first
    row of each chunk the render scans), ``tri_chunk``, ``all_quads``,
    ``shapes_present``, ``has_gain``, ``pg_wall``: for a paired bank
    the (L, Sp) i32 wall of each row (-1 = none), from
    ``pg_sel_onehot`` / ``pg_sel_base``, else None, and ``slot_tex``.
    In fourier mode without ``domain_rand`` every slot renders variant
    0: each prim's atlas base is baked into its attr slot column (both
    variants of a paired procgen bank; JAX vector.py:672) and
    ``slot_tex`` is None. With it the slot columns stay as built, and
    ``slot_tex`` = (tex, tex_alt) gives the render each scanned row's
    (slot id, atlas base, variant count, 0), f32, from which a render
    draws the row's variant (raycast.py:277-310): (L, S, 4) from
    ``tri_tex*`` for a dense plan (one chunk or several, by the global
    row), the (L * NC, k, 4) chunk rows of ``pvs_tri_tex*`` for packed
    PVS, in the view of ``pvs_v9_rows``, those of ``tri_tex*`` for
    ``chunk_vis`` and for a dense plan of several chunks with mesh
    entities (``raycast.static_rows``' chunk rows), and both variants' rows of
    ``pg_tex`` for a paired bank (``tex_alt``; None otherwise). In
    ``tex_mode="nearest"`` the slot columns keep their layout-local slot
    ids, which the render resolves through ``EnvState.tex_map`` (where
    domain_rand draws the variants), and ``slot_tex`` is None.
    The render carries the slot column in bf16 while the ids are at
    most 256 and in float32 above (``raycast.attr_carry_dtype``: the 8x8
    procgen maze's 528 local slots in nearest mode, a Fourier atlas of
    more than 256 rows, e.g. ``widen_atlas``'s).

    The port renders the JAX package's split, because the split decides
    ties. Each row's z-key carries its index WITHIN its chunk
    (raycast.py:421-425), and the carry across chunks takes a chunk's
    winner only on a strictly greater key (raycast.py:444-456): a tie at
    equal quantized depth goes to the larger chunk-local index, and
    between chunks to the earlier chunk. So the port renders a dense
    plan in its chunks (one, or the multi-chunk scan), and a schedule
    (``raycast.chunk_schedule``) chunk by chunk: packed PVS scans the
    ``sched_len`` chunks from ``pvs_room_base[layout, room]`` of the
    camera room, rows of ``pvs_v9_rows`` / ``pvs_attr_rows``, the last
    clamped to the layout's own chunks (the 8x8 Maze's layout bank: one
    chunk of 176 at 80x60, two of 96 at 160x120 with supersample=2);
    ``chunk_vis`` the sorted chunks visible from the camera room, padded
    with repeats of the last; a dense plan of several chunks with mesh
    entities the chunks in order, seeded by the mesh pass. A super bank
    renders its paired rows (``pg_*``), which
    the repad leaves as they are: Sp rows over more than one chunk are
    scanned as JAX scans them, the last chunk's start clamped to Sp -
    tri_chunk, so that chunk re-reads rows at shifted local indices
    (``chunk_starts``; the 8x8 Maze's Sp = 608 in 2 chunks of 496 at a
    chunk cap of 496). A super bank without paired rows renders its
    dense rows in their chunk plan, each env's killed by its maze (the
    JAX package's ``tri_active``, raycast.py:1220-1227; ``MiniWorldVec``
    passes the render each row's ``raycast.wall_codes``).
    With ``view="top"`` the observation is the top view, which scans the
    dense rows as built (``tri_verts``, with the super bank's
    ``tri_active`` kill) and carries them in float32: the bank gets no
    chunk plan;
    fourier mode bakes each prim's atlas base into its slot column, and
    ``plan``, ``tri_chunk``, ``all_quads``, ``shapes_present``,
    ``pg_wall`` and ``slot_tex`` are None.
    """
    fourier = tex_mode == "fourier"
    bake = fourier and not domain_rand
    has_gain = fourier and bool(((tex_np[:, -1] > 1.0) | (tex_np[:, -1] < 0.0)).any())

    def bake_tri_slots(bank_np):  # each prim's atlas base in its slot column
        ta = bank_np.tri_attr.copy()
        ta[:, :, 14] = bank_np.tri_tex_base
        return dataclasses.replace(bank_np, tri_attr=ta)

    if view == "top":
        return (bake_tri_slots(bank_np) if bake else bank_np,
                dict(plan=None, tri_chunk=None, all_quads=None, pg_wall=None,
                     shapes_present=None, has_gain=has_gain, slot_tex=None))
    bank_np, plan = (plan_chunks(bank_np, num_envs, hw, tri_chunk) if replan is None
                     else replan_chunks(bank_np, *replan))
    tri_chunk, s_bank = plan["tri_chunk"], bank_np.tri_mask.shape[1]
    shp = bank_np.proto_shape
    shapes_present = (
        bool((shp == SHAPE_SPHERE).any()),
        bool(((shp == SHAPE_BOX) | (shp == SHAPE_MESH_BOX)).any()),
        bool((shp == SHAPE_MESH_TRIS).any()),
    )
    # the first row of each chunk the render scans (of the paired rows on
    # a super bank; packed PVS scans one chunk of its own a render)
    n_scan = s_bank if bank_np.pg_verts9 is None else bank_np.pg_verts9.shape[2]
    plan["chunk_starts"] = ([0] if plan["kind"] == "packed_pvs"
                            else chunk_starts(n_scan, min(tri_chunk, n_scan)))

    def slot_rows(ids, base, cnt):  # (..., n) each -> (..., n, 4) f32
        return np.ascontiguousarray(np.stack(
            [ids.astype(np.float32), base, cnt, np.zeros_like(base)], axis=-1), np.float32)

    if bake:
        bank_np = bake_tri_slots(bank_np)
    slot_tex = (slot_rows(bank_np.tri_tex, bank_np.tri_tex_base, bank_np.tri_tex_count), None)
    if plan["kind"] == "chunk_vis" or (plan["kind"] == "dense" and shapes_present[2]
                                       and plan["nc"] > 1):
        # scheduled over the layout bank's own chunks: their chunk-row views
        # (raycast.static_rows), with the slot table in the same rows
        v9r, atr = chunk_row_views(bank_np.tri_verts9, bank_np.tri_attr, tri_chunk)
        bank_np = dataclasses.replace(bank_np, pvs_v9_rows=v9r, pvs_attr_rows=atr)
        slot_tex = (slot_tex[0].reshape(-1, tri_chunk, 4), None)
    if plan["kind"] == "packed_pvs":
        # the chunk-row views of the JAX package's one-hot chunk read
        pa = bank_np.pvs_attr
        if bake:  # slot columns baked as in the bank
            pa = pa.copy()
            pa[:, :, 14] = bank_np.pvs_tri_tex_base
        v9r, atr = chunk_row_views(bank_np.pvs_verts9, pa, tri_chunk)
        bank_np = dataclasses.replace(bank_np, pvs_attr=pa, pvs_v9_rows=v9r, pvs_attr_rows=atr)
        slot_tex = (slot_rows(bank_np.pvs_tri_tex, bank_np.pvs_tri_tex_base,
                              bank_np.pvs_tri_tex_count).reshape(-1, tri_chunk, 4), None)
    all_quads = bool((bank_np.tri_attr[:, :, 15][bank_np.tri_mask] == 0.0).all())
    pg_wall = None
    if bank_np.pg_verts9 is not None:
        pga, pgaa = bank_np.pg_attr, bank_np.pg_attr_alt
        if bake:
            pga, pgaa = pga.copy(), pgaa.copy()
            pga[:, :, 14] = bank_np.pg_tex[:, 0, 1]
            pgaa[:, :, 14] = bank_np.pg_tex[:, 1, 1]
            bank_np = dataclasses.replace(bank_np, pg_attr=pga, pg_attr_alt=pgaa)
        pg_wall = _paired_walls(bank_np)
        pgt = bank_np.pg_tex  # (L, 2, 3, Sp): [variant][ids | base | count]
        slot_tex = tuple(slot_rows(pgt[:, v, 0], pgt[:, v, 1], pgt[:, v, 2]) for v in (0, 1))
        if all_quads and not ((pga[:, :, 15] == 0.0).all() and (pgaa[:, :, 15] == 0.0).all()):
            raise ValueError("all_quads holds for the dense bank but not its paired rows")
    statics = dict(
        plan=plan,
        tri_chunk=tri_chunk,
        all_quads=all_quads,
        pg_wall=pg_wall,
        shapes_present=shapes_present,
        has_gain=has_gain,
        slot_tex=slot_tex if fourier and domain_rand else None,
    )
    return bank_np, statics


def _paired_walls(bank_np: Layout) -> np.ndarray:
    """(L, Sp) i32 wall of each paired row, -1 for rows without one: the
    JAX package's per-env select ``pg_sel_base + wall_open @
    pg_sel_onehot`` as one lookup (use the primary variant where the
    wall is -1 or open). Raises unless every column of the one-hot
    holds at most one 1, its other entries 0, with base 1 exactly where
    the column is empty."""
    onehot, base = bank_np.pg_sel_onehot, bank_np.pg_sel_base  # (L, W, Sp), (L, Sp)
    count = onehot.sum(axis=1)
    if not (np.isin(onehot, (0.0, 1.0)).all() and (count <= 1).all()
            and np.array_equal(base, (count == 0).astype(base.dtype))):
        raise ValueError("pg_sel_onehot / pg_sel_base are not a one-wall-per-row selection")
    return np.where(count > 0, onehot.argmax(axis=1), -1).astype(np.int32)


def _pick(u, choices):
    """choices[b, e, min(floor(u * n), n - 1)] with n the valid count."""
    n = (choices >= 0).sum(dim=-1).to(torch.int32)
    i = torch.minimum(torch.floor(u * n).to(torch.int32), torch.clamp(n - 1, min=0))
    return torch.gather(choices, -1, i.long()[..., None])[..., 0]


class MiniWorldVec:
    """Batched env over a compiled layout bank, on one torch device:
    the CUDA card unless the caller asks for another (``device="cpu"``
    runs every stage's plain version)."""

    def __init__(
        self,
        spec: EnvSpec | str,
        num_envs: int,
        *,
        device="cuda",
        obs_width: int | None = None,
        obs_height: int | None = None,
        with_depth: bool = True,
        use_kernels: bool = True,
        domain_rand: bool = False,
        supersample: int = 1,
        procgen: bool | None = None,
        tex_mode: str = "fourier",
        view: str = "agent",
        tri_chunk: int | None = None,
        bank_seed: int = 0,
        place_budget: int | None = None,
        fourier_k: int | None = None,
    ):
        if view not in ("agent", "top"):
            raise ValueError(f"view must be 'agent' or 'top', got {view!r}")
        if tex_mode not in ("fourier", "nearest"):
            raise ValueError(f"tex_mode must be 'fourier' or 'nearest', got {tex_mode!r}")
        if view == "top" and domain_rand and tex_mode == "fourier":
            # the JAX package's top view reads the layout-local slot ids of
            # a domain_rand bank as atlas rows (miniworld_tpu/render/
            # topview.py:102-110), a fault of the reference not to adopt
            raise ValueError(
                "view='top' with domain_rand=True and tex_mode='fourier': the reference "
                "(miniworld_tpu/render/topview.py:102-110) reads layout-local slot ids as "
                "atlas rows there; use tex_mode='nearest', whose top view resolves the "
                "variants through tex_map")
        if supersample not in (1, 2):
            raise ValueError(f"supersample must be 1 or 2, got {supersample!r}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but torch sees no CUDA device")
        if isinstance(spec, str):
            from miniworld_tpu_torch.envs import make_spec

            spec = make_spec(spec)
        # Procgen: a fresh recursive-backtracker maze per reset, generated
        # on the device (the reference's reset semantics,
        # miniworld/envs/maze.py:100-149); the bank is one super layout
        # holding every wall variant and EnvState.wall_open the episode's
        # maze. None follows the spec (True for the Maze family).
        self.procgen = bool(spec.procgen_default if procgen is None else procgen)
        if self.procgen and not all(hasattr(spec, a) for a in
                                    ("num_rows", "num_cols", "room_size", "gap_size")):
            raise ValueError(
                f"procgen=True needs a maze-grid spec (num_rows/num_cols/room_size/"
                f"gap_size); {spec.name} has none"
            )
        self.spec = spec
        self.num_envs = int(num_envs)
        self.device = device
        self.obs_width = obs_width or spec.obs_width
        self.obs_height = obs_height or spec.obs_height
        self.with_depth = with_depth
        # per-episode and per-step parameter draws, and each episode's
        # texture variants (the JAX package's domain_rand)
        self.domain_rand = bool(domain_rand)
        # 2: each pixel the box-filtered mean of a 2x2 grid of samples
        self.supersample = int(supersample)
        # "nearest": exact texels of the u8 atlas, the JAX package's
        # bit-accurate texture path; "fourier": its Fourier texture model
        self.tex_mode = tex_mode
        # the reset's placement tries (None: the spec's), the Fourier
        # terms (None: the spec's, else FOURIER_TERMS) and the seed of the
        # layout bank's layouts (JAX vector.py:416-433)
        self.place_budget = spec.place_budget if place_budget is None else int(place_budget)
        self.fourier_k = _fourier_k(spec, fourier_k)
        # "top": each observation is the orthographic top view with the
        # agent marker (JAX vector.py:1132-1146); it ignores supersample,
        # as the JAX package's does
        self.view = view
        # True: each render stage and the reset's placement go through
        # their wrappers (CUDA kernels for CUDA tensors); False: the plain
        # PyTorch versions.
        self.use_kernels = use_kernels

        self._tri_chunk_cap = tri_chunk
        if self.procgen:
            bank_np, tex_np = build_super_bank(spec, tex_mode, self.fourier_k)
        else:
            bank_np, tex_np = build_bank(spec, tex_mode, bank_seed=bank_seed,
                                         fourier_k=self.fourier_k)
        # a refreshed bank is padded to at least these sizes
        self._bank_sizes = bank_sizes(bank_np)
        self.plan = None
        self._install(bank_np, tex_np)
        # the discrete table, or None: the raw 6-D actions (RoomObjects,
        # PutNext; the reference's Box space)
        self._action_table = (None if spec.discrete_actions is None else torch.as_tensor(
            np.asarray(spec.discrete_actions, np.float32), device=device))
        # domain randomization's (lo, hi) per parameter, on the device once
        self._param_bounds = {name: tuple(t[0] for t in self._bounds([name]))
                              for name in RESET_PARAMS + ("obj_color_bias",)}
        self._param_bounds["step"] = self._bounds(STEP_PARAMS)

    def _install(self, bank_np: Layout, tex_np: np.ndarray):
        """Plan a fresh bank (or, once a plan is installed, keep it:
        ``replan_chunks``) and put the bank, its statics and the texture
        table on the device."""
        device = self.device
        replan = None if self.plan is None else (self.plan, self._bank_np)
        bank_np, statics = install_statics(
            bank_np, tex_np, self.num_envs,
            self.obs_width * self.obs_height * self.supersample ** 2, self.domain_rand,
            self.tex_mode, self.view, self._tri_chunk_cap, replan)
        self._bank_np = bank_np
        # the JAX package's chunk plan (plan_chunks), which the render
        # follows; a chunk_vis plan's visibility on the device
        self.plan = statics["plan"]
        if self.plan is not None and "chunk_vis" in self.plan:
            self.plan = dict(self.plan, chunk_vis=torch.from_numpy(self.plan["chunk_vis"]).to(device))
        self.tri_chunk = statics["tri_chunk"]
        self._all_quads = statics["all_quads"]
        self._shapes_present = statics["shapes_present"]
        # the atlas has glyph rows (Sign): the epilogue's glyph branch
        self._has_gain = statics["has_gain"]
        self._bank = layout_from_numpy(bank_np, device)
        # the top view's per-layout grid, staged rows and tile lists
        self._top = (top_statics(self._bank, self.obs_width, self.obs_height)
                     if self.view == "top" else None)
        self.__dict__.pop("_vis", None)  # visible_ents' statics, made again at first use
        self._pg_wall = (None if statics["pg_wall"] is None
                         else torch.from_numpy(statics["pg_wall"]).to(device))
        # a super bank without paired rows: each dense row's maze kill
        # (raycast.wall_codes), which the agent view's render reads
        self._row_code = (wall_codes(self._bank).to(device)
                          if self.view == "agent" and bank_np.tri_wall is not None
                          and bank_np.pg_verts9 is None else None)
        # domain_rand: each scanned row's (slot id, atlas base, variant
        # count), in the rows' view (a paired bank's two variants)
        self._slot_tex = (None if statics["slot_tex"] is None else
                          tuple(None if t is None else torch.from_numpy(t).to(device)
                                for t in statics["slot_tex"]))
        self._fourier_table = None
        if self.tex_mode == "nearest":  # the (N, R, R, 3) u8 atlas
            self._atlas = torch.from_numpy(np.ascontiguousarray(tex_np, np.uint8)).to(device)
        else:
            self._atlas = atlas_from_numpy(tex_np, device)
            # what the epilogue kernel reads in place of the atlas, made once
            self._fourier_table = fourier_table(atlas_from_numpy(tex_np),
                                                self.fourier_k).to(device)
        self.num_layouts = bank_np.tri_verts.shape[0]
        self.num_ent_slots = bank_np.slot_protos.shape[1]

    # -- layout-bank refresh (JAX vector.py:769-815) ---------------------------

    def prepare_bank(self, bank_seed: int):
        """Compile a fresh layout bank on the host from ``bank_seed``,
        padded to the installed bank's sizes: no device work and no
        state of this env touched, so it may run in a background thread
        while the env steps; ``install_bank`` swaps it in."""
        return build_bank(self.spec, self.tex_mode, bank_seed=bank_seed,
                          fourier_k=self.fourier_k, min_sizes=self._bank_sizes)

    def install_fresh(self, bank_np: Layout, tex_np: np.ndarray):
        """Install another compiled bank and texture table, planned afresh
        (the JAX package's ``_install_bank(..., fresh=True)``): e.g. a bank
        and atlas from ``widen_atlas`` or ``raise_slot_ids``, or a procgen
        super bank without its paired rows (``drop_paired_rows``), which
        renders its dense rows with each env's maze kill. Envs in an
        episode keep their state: reset after it."""
        self.plan = None
        self._bank_sizes = bank_sizes(bank_np)
        self._install(bank_np, tex_np)

    def install_bank(self, prepared):
        """Swap in a bank from ``prepare_bank`` (on the thread that steps
        the env), in the installed chunk plan: the same kind and chunk,
        a packed-PVS bank's packed copies padded to the installed length
        (``replan_chunks``). Its texture table must have the installed
        one's shape. Raises under procgen."""
        if self.procgen:
            raise ValueError("a procgen env has no layout bank to swap: each reset generates "
                             "a fresh maze")
        bank_np, tex_np = prepared
        if tuple(tex_np.shape) != tuple(self._atlas.shape):
            raise ValueError(
                f"the refreshed texture table is {tuple(tex_np.shape)}, the installed one "
                f"{tuple(self._atlas.shape)}: a refresh needs the spec's texture set to be the "
                "same for every layout")
        self._install(bank_np, tex_np)

    def refresh_layouts(self, bank_seed: int):
        """Swap in ``num_layouts`` new layouts built from
        ``SeedSequence(bank_seed)`` (``prepare_bank``, then
        ``install_bank``), as the reference builds a fresh world every
        reset (miniworld/miniworld.py:558-618). A no-op under procgen,
        whose resets already generate a fresh maze each. Envs in an
        episode keep their layout index and see the new layout's
        geometry, so refresh between rollouts."""
        if self.procgen:
            return
        self.install_bank(self.prepare_bank(bank_seed))

    # -- reset ---------------------------------------------------------------

    def _default(self, name: str, n: int) -> torch.Tensor:
        """(n, *shape) per-episode parameter at its default (no domain
        randomization)."""
        d = torch.as_tensor(np.asarray(self.spec.params.params[name].default,
                                       np.float32), device=self.device)
        return d.expand((n,) + tuple(d.shape)).clone()

    def _bounds(self, names):
        """(lo, hi) float32 tensors of the parameters ``names``, stacked
        on a leading axis."""
        params = self.spec.params.params
        return tuple(torch.as_tensor(np.stack([np.asarray(getattr(params[n], side), np.float32)
                                               for n in names]), device=self.device)
                     for side in ("min", "max"))

    def _reset_params(self, u3, n: int) -> dict:
        """The per-episode parameters of ``RESET_PARAMS`` from their (n, 8,
        3) counter-based uniform rows ``u3`` (the JAX package's
        ``_sample_param_u``: ``lo + u * (hi - lo)``, a () parameter from
        the row's first column); at their defaults without domain
        randomization (``u3`` None)."""
        if u3 is None:
            return {name: self._default(name, n) for name in RESET_PARAMS}
        out = {}
        for i, name in enumerate(RESET_PARAMS):
            lo, hi = self._param_bounds[name]
            uu = u3[:, i] if lo.dim() == 1 else u3[:, i, 0]
            out[name] = lo + uu * (hi - lo)
        return out

    def _step_params(self, k_params: torch.Tensor):
        """(forward_step, forward_drift, turn_step) of a step: each env's
        ``jax.random.uniform`` draws from ``split(k_params, 3)`` (the JAX
        package's ``_sample_param``), one threefry call for the three, as
        (B,) tensors; floats at their defaults without domain
        randomization."""
        params = self.spec.params.params
        if not self.domain_rand:
            return tuple(float(params[name].default) for name in STEP_PARAMS)
        lo, hi = self._param_bounds["step"]
        draws = rng_ops.uniform(rng_ops.split(k_params, 3), (), lo, hi)  # (B, 3)
        return tuple(draws[:, i] for i in range(3))

    def _reset_batch(self, keys: torch.Tensor) -> EnvState:
        """Reset one env per key (B, 2): the JAX package's ``_reset_one``
        for every env at once, from the same counter-based draws."""
        spec, bank = self.spec, self._bank
        n = keys.shape[0]
        dev = self.device
        k_rng, k_post = rng_ops.split(keys, 2).unbind(1)
        seed = rng_ops.cheap_seed(keys)

        def u(purpose, shape=()):
            return rng_ops.uniforms(seed, purpose, shape)

        if self.num_layouts > 1:
            layout_id = torch.clamp(torch.floor(u(10, (1,))[:, 0] * self.num_layouts),
                                    max=self.num_layouts - 1).to(torch.int32)
        else:
            layout_id = torch.zeros(n, dtype=torch.int32, device=dev)
        lid = layout_id.long()

        # Procgen: this episode's maze, a fresh wall-open bitmask per reset.
        # Placement sees it as junction-room weights (a closed wall's
        # junction does not exist, miniworld/miniworld.py:957-963) and as
        # gated collision segments.
        wall_open = room_weight = seg_gate = None
        if self.procgen:
            gen = mazegen.gen_walls if self.use_kernels else mazegen.gen_walls_plain
            wall_open = gen(rng_ops.sub(seed, 17), spec.num_rows, spec.num_cols)
            rw = bank.room_wall[lid]  # (B, R): -1 = cell, w = junction of wall w
            room_weight = torch.where(rw < 0, torch.ones_like(wall_open[:, :1]),
                                      torch.gather(wall_open, 1, torch.clamp(rw, min=0).long()))
            seg_gate = (bank.room_seg_wall, wall_open)

        E = self.num_ent_slots
        ent_proto = torch.clamp(_pick(u(11, (E,)), bank.slot_protos[lid]), min=0)
        p = ent_proto.long()
        lid_e = lid[:, None]
        size_lo, size_hi = bank.slot_size_lo[lid], bank.slot_size_hi[lid]
        size_mul = size_lo + u(12, (E,)) * (size_hi - size_lo)
        ent_size = bank.proto_size[lid_e, p] * size_mul[..., None]
        ent_radius = bank.proto_radius[lid_e, p] * size_mul
        ent_height = bank.proto_height[lid_e, p] * size_mul
        # obj_color_bias per entity (entity.py:405-407)
        if self.domain_rand:
            b_lo, b_hi = self._param_bounds["obj_color_bias"]
            bias = b_lo + u(13, (E, 3)) * (b_hi - b_lo)
        else:
            bias = self._default("obj_color_bias", n)[:, None, :].expand(n, E, 3)
        colorable = bank.proto_colorable[lid_e, p]
        ent_color = torch.clamp(
            bank.proto_color[lid_e, p]
            + torch.where(colorable[..., None], bias, torch.zeros_like(bias)),
            0.0, 1.0,
        )

        # placement alternative per slot (row E = the agent)
        rule_mask = bank.rule_mask[lid]  # (B, E+1, A)
        n_alts = rule_mask.sum(dim=2).to(torch.int32)
        alts = torch.minimum(torch.floor(u(14, (E + 1,)) * n_alts).to(torch.int32),
                             torch.clamp(n_alts - 1, min=0)).long()
        place_seeds = rng_ops.hash_u32(
            rng_ops.sub(seed, 18)[:, None],
            torch.arange(E + 1, dtype=torch.int64, device=dev)[None, :],
        )
        # each slot's rule row at its alternative, (B, E+1, ...); every
        # slot, then the agent, placed in one call (the kernel on the card)
        slots = torch.arange(E + 1, device=dev)[None, :]
        rules = {name: getattr(bank, name)[lid[:, None], slots, alts]
                 for name in place_ops.RULE_FIELDS}
        agent_r = torch.full((n, 1), spec.agent_radius, dtype=torch.float32, device=dev)
        slot_mask = bank.slot_mask[lid]
        place = place_ops.place_all if self.use_kernels else place_ops.place_all_plain
        ent_pos, ent_dir, agent_pos, agent_dir = place(
            place_seeds, bank, layout_id, rules, torch.cat([ent_radius, agent_r], dim=1),
            slot_mask, budget=self.place_budget, room_weight=room_weight, seg_gate=seg_gate,
        )

        # per-episode params (reset consumption; miniworld.py:586-599)
        par = self._reset_params(u(15, (8, 3)) if self.domain_rand else None, n)
        # Texture variants (opengl.py:136-140): one draw per (room, role)
        # slot from the keyed hash of its id, as the slot table and as
        # the key the render resolves each prim's variant from
        tex_map = bank.tex_slot_base[lid]
        tkey = torch.zeros(n, dtype=torch.int64, device=dev)
        if self.domain_rand:
            tkey = rng_ops.sub(seed, 16)
            u_var = rng_ops.hash01(tkey[:, None], torch.arange(tex_map.shape[1], device=dev))
            count = bank.tex_slot_count[lid]
            offs = torch.minimum(torch.floor(u_var * count.to(torch.float32)).to(torch.int32),
                                 count - 1)
            tex_map = tex_map + offs
        state = EnvState(
            pos=agent_pos, dir=agent_dir,
            cam_pitch=par["cam_pitch"], cam_height=par["cam_height"],
            cam_fov_y=par["cam_fov_y"], cam_fwd_disp=par["cam_fwd_disp"],
            carrying=torch.full((n,), -1, dtype=torch.int32, device=dev),
            ent_pos=ent_pos, ent_dir=ent_dir,
            ent_alive=slot_mask.clone(),
            ent_proto=ent_proto.to(torch.int32), ent_color=ent_color,
            ent_size=ent_size, ent_radius=ent_radius, ent_height=ent_height,
            step_count=torch.zeros(n, dtype=torch.int32, device=dev),
            rng=k_rng, layout_id=layout_id,
            sky_color=par["sky_color"], light_pos=par["light_pos"],
            light_color=par["light_color"], light_ambient=par["light_ambient"],
            tex_map=tex_map.to(torch.int32), tri_slots=tkey,
            wall_open=wall_open,
            task={k: torch.as_tensor(v, device=dev).expand(n).clone()
                  for k, v in spec.init_task().items()},
        )
        return spec.post_reset(bank, state, k_post)

    # -- step ------------------------------------------------------------------

    def _step_batch(self, state: EnvState, action: torch.Tensor):
        spec, bank = self.spec, self._bank
        keys = rng_ops.split(state.rng, 3)
        state = state.replace(rng=keys[:, 0], step_count=state.step_count + 1)
        prev = state
        fwd_step, fwd_drift, turn_step = self._step_params(keys[:, 1])

        lid = state.layout_id.long()
        room = room_of_point(bank, state.layout_id, state.pos[:, [0, 2]])
        segs4 = bank.room_segs[lid, room]  # (B, 4, NS) room-local walls
        if self.procgen:  # open walls' closed-quad segments stop colliding
            segs4 = place_ops.gate_segs4(segs4, bank.room_seg_wall[lid, room], state.wall_open)

        n = action.shape[0]
        no_idx = torch.full((n,), -1, dtype=torch.int32, device=self.device)
        if spec.override_physics:
            # the camera ids move the camera, not the body (JAX vector.py:
            # 1069-1083): (B,) Discrete ids or (B, 2) clicks, the click in
            # the first two columns of the task's action vector
            click = getattr(spec, "click_action", False)
            if action.dim() != (2 if click else 1):
                raise ValueError(f"{spec.name} takes " + (
                    "(B, 2) clicks" if click else f"(B,) action ids in [0, {spec.num_actions})"))
            action_idx = no_idx if click else action.to(torch.int32)
            action_vec = torch.zeros((n, 6), dtype=torch.float32, device=self.device)
            if click:
                action_vec[:, :2] = action
            state = spec.apply_action(bank, state, action)
            res = StepResult(moved=torch.zeros(n, dtype=torch.bool, device=self.device),
                             picked_up=no_idx, dropped=no_idx)
        else:
            if action.dim() == 1:
                if self._action_table is None:
                    raise ValueError(f"{spec.name} takes (B, 6) action vectors: it has no "
                                     "discrete action table")
                action_idx = action.to(torch.int32)
                action_vec = self._action_table[action_idx.long()]
            else:
                action_idx = no_idx
                action_vec = physics.clip_action(action.to(torch.float32))
            state, res = physics.physics_step(
                bank.proto_pickable[lid], state, action_vec, segs4=segs4,
                max_forward_step=spec.max_forward_step,
                fwd_step=fwd_step, fwd_drift=fwd_drift, turn_step=turn_step,
                agent_radius=spec.agent_radius,
            )
        truncated = state.step_count >= spec.max_episode_steps
        ctx = Ctx(prev=prev, state=state, res=res, action=action_vec,
                  action_idx=action_idx, truncated=truncated, bank=bank,
                  use_kernels=self.use_kernels)
        reward, term, state = spec.transition(ctx)
        done = term | truncated
        info = {
            "agent_pos": state.pos,
            "agent_dir": state.dir,
            "cam_pitch": state.cam_pitch,
            "termination": term,
            "truncation": truncated,
        }
        info.update(spec.info(ctx))
        # on-device auto-reset, computed for every env like the JAX
        # package (no host sync to find the done ones)
        state = tree_select(done, self._reset_batch(keys[:, 2]), state)
        return state, reward.to(torch.float32), done, info

    # -- observation -------------------------------------------------------------

    def render(self, state: EnvState):
        """(rgb (B, H, W, 3) u8, depth (B, H, W, 1) f32): the agent's
        view, or with ``view="top"`` the top view (``render_top_view``)."""
        if self.view == "top":
            return render_top_view(
                self._bank, state, self._atlas, width=self.obs_width, height=self.obs_height,
                agent_radius=self.spec.agent_radius, statics=self._top, tex_mode=self.tex_mode,
                k_terms=self.fourier_k, table=self._fourier_table, has_gain=self._has_gain,
                use_kernels=self.use_kernels)
        return render_rgbd(
            self._bank, state, self._atlas,
            width=self.obs_width, height=self.obs_height, k_terms=self.fourier_k,
            shapes_present=self._shapes_present, all_quads=self._all_quads,
            has_gain=self._has_gain, use_kernels=self.use_kernels, pg_wall=self._pg_wall,
            table=self._fourier_table, plan=self.plan, slot_tex=self._slot_tex,
            supersample=self.supersample, tex_mode=self.tex_mode, row_code=self._row_code,
        )

    def _obs(self, state: EnvState):
        """(observation, image) of ``state``: the render with the spec's
        overlay (``post_render``: CameraControl's crosshair), the image as
        {"obs": image, "goal": (B,) int32} for a ``dict_obs`` spec (Sign;
        the JAX package's ``_wrap_obs_one``), with the depth beside it when
        ``with_depth``."""
        rgb, depth = self.render(state)
        img = rgb = self.spec.post_render(rgb, state)
        if self.spec.dict_obs:
            rgb = {"obs": rgb, "goal": torch.full((rgb.shape[0],), self.spec.goal,
                                                  dtype=torch.int32, device=rgb.device)}
        return ((rgb, depth) if self.with_depth else rgb), img

    @functools.cached_property
    def _vis(self):
        """visible_ents' room rows (``vis_statics``), built at its first call."""
        return vis_statics(self._bank)

    def visible_ents(self, state: EnvState) -> torch.Tensor:
        """(B, E) bool: each entity visible from the agent's camera
        (get_visible_ents, JAX vector.py:1195-1205): the reference's
        occlusion queries per pixel at the observation's size
        (render/visibility.py), on the env's device."""
        cam = camera_grid(state, self.obs_width, self.obs_height)
        wall_open = state.wall_open if self._bank.tri_wall_onehot is not None else None
        f = visible_ents if self.use_kernels else visible_ents_plain
        return f(self._vis, state.layout_id, wall_open, cam, state.ent_pos, state.ent_alive)

    # -- public API -------------------------------------------------------------

    def reset(self, seed: int):
        """Returns (state, obs); keys are ``split(key(seed), B)`` as in
        ``jax.random.split(jax.random.key(seed), B)``."""
        keys = rng_ops.split(rng_ops.key_data(seed, self.device), self.num_envs)
        state = self._reset_batch(keys)
        return state, self._obs(state)[0]

    def step(self, state: EnvState, actions: torch.Tensor):
        """Returns (state, obs, reward, done, info). ``actions``: (B,)
        discrete indices or (B, 6) action vectors; CameraControl's (B,)
        ids, CameraControlClick's (B, 2) clicks."""
        state, reward, done, info = self._step_batch(state, actions)
        return state, self._obs(state)[0], reward, done, info

    def reset_keys(self, keys: torch.Tensor):
        """Returns (state, obs) of one env reset per key in ``keys`` (n, 2):
        the JAX package's ``_reset_jit`` on ``keys`` and its render, for a
        caller that draws the keys itself (the trainers' share of a global
        ``split(key, B)``, parallel/dist.py)."""
        state = self._reset_batch(keys.to(self.device))
        return state, self._obs(state)[0]

    def set_discrete_actions(self, discrete_actions):
        """Install (or remove, with None) the discrete-action table, like
        the reference's MiniWorldEnv.set_discrete_actions
        (miniworld/miniworld.py:654-664; JAX vector.py:1223-1242): each row
        is a 6-D action vector that a (B,) action indexes. Without one,
        ``step`` takes (B, 6) action vectors."""
        if discrete_actions is None:
            self._action_table = None
            return
        table = torch.as_tensor(np.asarray(discrete_actions, np.float32), device=self.device)
        if table.dim() != 2 or table.shape[1] != 6:
            raise ValueError(f"a discrete action table is (n, 6), got {tuple(table.shape)}")
        self._action_table = table

    def sample_actions(self, key: torch.Tensor, num: int | None = None) -> torch.Tensor:
        """Uniform random actions from key data (..., 2), the JAX
        package's ``sample_actions`` value for value (JAX vector.py:
        1244-1257), for ``num`` envs (default ``num_envs``): (..., n)
        discrete indices, ``jax.random.randint(key, (n,), 0, A)``, for a
        table-action spec; (..., n, 6) vectors, ``jax.random.uniform(key,
        (n, 6), minval=[-1, -1, -1, -1, 0, 0], maxval=1)``, for one
        without a table; CameraControl's ids ``randint(key, (n,), 0, 6)``
        and CameraControlClick's clicks ``uniform(key, (n, 2))``."""
        key = key.to(self.device)
        spec = self.spec
        n = self.num_envs if num is None else int(num)
        if self._action_table is not None:
            return rng_ops.randint(key, n, self._action_table.shape[0])
        if getattr(spec, "num_actions", 0):
            return rng_ops.randint(key, n, spec.num_actions)
        if getattr(spec, "click_action", False):
            return rng_ops.uniform(key, (n, 2), 0.0, 1.0)
        return rng_ops.uniform(key, (n, 6), [-1.0, -1.0, -1.0, -1.0, 0.0, 0.0], [1.0] * 6)

    def rollout_actions(self, key: torch.Tensor, horizon: int) -> torch.Tensor:
        """(horizon, B[, 6 or 2]) actions of ``rollout`` from key data (2,): step t
        acts on the first split of ``split(key, horizon)[t]``, as the JAX
        package's ``rollout_fn`` does, in four batched threefry calls."""
        step_keys = rng_ops.split(key.to(self.device), horizon)  # (horizon, 2)
        # the first of two splits is split(k, 1)[0]: split i of k is
        # threefry(k, (0, i)) whatever their number
        return self.sample_actions(rng_ops.split(step_keys, 1)[:, 0])

    def rollout(self, state: EnvState, obs, key: torch.Tensor, horizon: int, *, policy=None,
                return_obs: bool = False, return_actions: bool = False):
        """``horizon`` steps (step + render each) from the (2,) key data
        ``key`` (``ops.rng.key_data(seed)``), the JAX package's
        ``rollout_fn`` (JAX vector.py:1262-1337).

        Returns (state, obs, outs) with ``outs`` the per-step sums of
        ``rollout_fn``: "reward" (horizon,) f32, "dones" (horizon,) and
        "obs_sum" (horizon,) int64, the latter a checksum of every 8th
        pixel row and column of the image (a dict observation's "obs", the
        JAX package's image leaf, after the spec's overlay) that keeps each
        render's result live. No host sync happens inside.

        ``policy``: ``(obs, depth, key) -> actions`` for the batch, where
        ``obs`` is the observation's image (Sign's dict of image and goal),
        ``depth`` its (B, H, W, 1) depth (None without ``with_depth``) and
        ``key`` step t's ``k_act``, the first of two splits of
        ``split(key, horizon)[t]``. Without one the actions are
        ``rollout_fn``'s random ones (``rollout_actions``); they depend only
        on the key and the step, so the whole horizon's are drawn before
        the loop, once, not per step.

        ``return_obs``: ``outs["obs"]`` (and ``outs["depth"]`` with
        ``with_depth``) stack the observations the actions were taken
        from, (horizon, B, ...); ``return_actions``: ``outs["actions"]``,
        ``outs["rewards"]`` and ``outs["done_mask"]`` stack each step's
        (B, ...) actions, rewards and dones.
        """
        if policy is None:
            actions_all = self.rollout_actions(key, horizon)
        else:
            # k_act of step t: split(split(key, horizon)[t], 2)[0], which is
            # split(k, 1)[0] (split i of k is threefry(k, (0, i)))
            act_keys = rng_ops.split(rng_ops.split(key.to(self.device), horizon), 1)[:, 0]
        rewards, dones, sums = [], [], []
        stacked = {k: [] for k in ("obs", "depth", "actions", "rewards", "done_mask")}
        for t in range(horizon):
            o, d = obs if self.with_depth else (obs, None)
            actions = actions_all[t] if policy is None else policy(o, d, act_keys[t])
            if return_obs:
                stacked["obs"].append(o)
                if self.with_depth:
                    stacked["depth"].append(d)
            state, reward, done, _ = self._step_batch(state, actions)
            obs, img = self._obs(state)
            rewards.append(reward.sum())
            dones.append(done.sum())
            sums.append(img[:, ::8, ::8].to(torch.int64).sum())
            if return_actions:
                stacked["actions"].append(actions)
                stacked["rewards"].append(reward)
                stacked["done_mask"].append(done)
        outs = {"reward": torch.stack(rewards), "dones": torch.stack(dones),
                "obs_sum": torch.stack(sums)}
        for k, v in stacked.items():
            if not v:
                continue
            if isinstance(v[0], dict):  # Sign's {"obs", "goal"}
                outs[k] = {kk: torch.stack([x[kk] for x in v]) for kk in v[0]}
            else:
                outs[k] = torch.stack(v)
        return state, obs, outs

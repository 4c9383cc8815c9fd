"""Batched entity placement (rejection sampling).

Counterpart of ``miniworld_tpu/ops/place.py`` (reference:
MiniWorldEnv.place_entity, miniworld/miniworld.py:922-992): a fixed
retry budget, the first valid try wins, an in-room clamped fallback
when every try fails. Draws are the counter-based uniforms of
ops/rng.py, so each env sees the JAX package's numbers.

``place_all`` places every entity slot of a reset in order and then the
agent (the JAX package's ``_reset_one`` placement loop, vector.py:
935-984): for CUDA tensors in one launch of the ``place`` kernel
(``csrc/place.cu``, one warp per env, a slot's tries in parallel lanes),
for CPU tensors through ``place_all_plain``, which runs ``_place_one``
per slot with every env advanced together. On a procgen maze every
placement also takes the episode's maze: per-env room weights and
wall-gated segments.

``place_one`` places one entity per env against an obstacle list the
caller gives (CollectHealth's kit respawn inside the step, the JAX
package's envs/interact.py:200-214): for CUDA tensors one launch of the
place kernel's second entry (the same tries), for CPU tensors
``place_one_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from miniworld_tpu_torch.ops import geom, rng as rng_ops
from miniworld_tpu_torch.render.cuda_build import check, is_cuda, launch, stream

# The per-env rule rows ``place_all`` takes: (B, E+1, ...) each, row E
# the agent's, already picked by the reset's placement alternative.
RULE_FIELDS = ("rule_room", "rule_bbox", "rule_pos", "rule_dir", "rule_dir_lo",
               "rule_dir_hi")
_MAX_SLOTS = 32  # the kernel keeps the placed slots in shared memory (place.cu)


def sample_room(u, room_mask, room_area, room_weight=None):
    """(B,) room index drawn proportionally to floor bbox area from
    uniforms u (B,); room_mask/room_area are (B, R) per-env rows.

    ``room_weight`` ((B, R) f32, procgen) multiplies the area weights:
    the junction rooms of a maze's closed walls get 0, as the reference
    chooses among the rooms that exist (miniworld/miniworld.py:957-963).
    """
    probs = torch.where(room_mask, room_area, torch.zeros_like(room_area))
    if room_weight is not None:
        probs = probs * room_weight
    cdf = torch.cumsum(probs, dim=1)
    pick = (u * cdf[:, -1])[:, None] < cdf
    return torch.argmax(pick.to(torch.int32), dim=1)


def gate_segs4(segs4, codes, wall_open):
    """Deactivate each env's non-solid segments in a (B, 4, NS) pack.

    ``codes`` ((B, NS) i32): -1 = always solid; w = solid iff wall w is
    CLOSED in ``wall_open`` ((B, W) f32, 1 = open). A gated segment is
    shifted by 1e9 on all four coordinates, as the JAX package adds it
    (same convention as the pack's SEG_PAD padding), so the distance
    tests need no mask.
    """
    openv = torch.gather(wall_open, 1, torch.clamp(codes, min=0).long())
    solid = (codes < 0) | (openv < 0.5)
    shift = torch.where(solid, torch.zeros_like(openv), torch.full_like(openv, 1e9))
    return segs4 + shift[:, None, :]


def place_one_plain(*args, **kwargs):
    """Plain version of the place_one kernel: one entity pose per env.
    Returns (pos (B,3), dir (B,)); the arguments are ``_place_one``'s."""
    return _place_one(*args, **kwargs)[:2]


def _place_one(seed, bank, layout_id, rule_room, rule_bbox, rule_pos,
               rule_dir, rule_dir_lo, rule_dir_hi, radius, ent_pos_xz,
               ent_radius, ent_mask, budget: int = 16, room_weight=None,
               seg_gate=None):
    """``place_one``'s draw: (pos (B,3), dir (B,), first (B,) i64), the
    index of the first passing try, ``budget`` where every try failed
    and the fallback placed the entity.

    ``seed`` (B,) u32 subseeds; ``bank`` the device Layout (leading
    layout axis), rows picked by ``layout_id`` (B,). Rule tensors are
    per env: rule_room (B,), rule_bbox (B,4), rule_pos (B,3), rule_dir /
    lo / hi (B,); radius (B,); ent_* (B,E,...) the entities placed so far.
    Procgen mazes pass ``room_weight`` (B, R) f32 (sample_room) and
    ``seg_gate`` = (room_seg_wall (L, R, NS) i32, wall_open (B, W) f32),
    which gates each sampled room's wall segments (gate_segs4).
    """
    lid = layout_id.long()
    room_mask = bank.room_mask[lid]
    room_area = bank.room_area[lid]
    us = rng_ops.uniforms(seed, 1, (budget + 2, 4))  # (B, budget+2, 4)

    def room_for(u0):
        return torch.where(rule_room >= 0, rule_room.long(),
                           sample_room(u0, room_mask, room_area, room_weight))

    def one_try(u):
        room_idx = room_for(u[:, 0])
        aabb = bank.room_aabb[lid, room_idx]  # [min_x, max_x, min_z, max_z]
        bbox = torch.where(torch.isnan(rule_bbox), aabb, rule_bbox)
        zero = torch.zeros_like(radius)
        lo = torch.stack([bbox[:, 0] - radius, zero, bbox[:, 2] - radius], dim=-1)
        hi = torch.stack([bbox[:, 1] + radius, zero, bbox[:, 3] + radius], dim=-1)
        pos = lo + u[:, 1:4] * (hi - lo)
        pos_xz = pos[:, [0, 2]]
        inside = geom.point_inside_convex(
            pos_xz,
            bank.room_outline[lid, room_idx],
            bank.room_norms[lid, room_idx],
            bank.room_vmask[lid, room_idx],
        )
        segs4 = bank.room_segs[lid, room_idx]  # (B, 4, NS) room-local walls
        if seg_gate is not None:
            room_seg_wall, wall_open = seg_gate
            segs4 = gate_segs4(segs4, room_seg_wall[lid, room_idx], wall_open)
        wall_hit = geom.circle_segs4(pos_xz, radius, segs4)
        ent_hit = geom.circle_vs_entities(pos_xz, radius, ent_pos_xz,
                                          ent_radius, ent_mask) >= 0
        return pos, inside & ~wall_hit & ~ent_hit

    pos, _ = one_try(us[:, budget])
    first = torch.full_like(radius, budget, dtype=torch.long)
    for i in range(budget):
        cand, ok = one_try(us[:, i])
        take = ok & (first == budget)
        pos = torch.where(take[:, None], cand, pos)
        first = torch.where(take, i, first)
    found = first < budget

    # budget exhausted: clamp into the rule room's bbox inset by the radius
    room_idx = room_for(us[:, budget + 1, 0])
    aabb = bank.room_aabb[lid, room_idx]

    def clamp_axis(v, a_lo, a_hi):
        lo_b = torch.minimum(a_lo + radius, a_hi - radius)
        hi_b = torch.maximum(a_lo + radius, a_hi - radius)
        return torch.minimum(torch.maximum(v, lo_b), hi_b)

    ctr = torch.stack([
        clamp_axis(pos[:, 0], aabb[:, 0], aabb[:, 1]),
        pos[:, 1] * 0.0,
        clamp_axis(pos[:, 2], aabb[:, 2], aabb[:, 3]),
    ], dim=-1)
    pos = torch.where(found[:, None], pos, ctr)
    exact = ~torch.isnan(rule_pos[:, 0])
    pos = torch.where(exact[:, None], torch.nan_to_num(rule_pos), pos)

    u_dir = us[:, budget + 1, 1]
    d = torch.where(torch.isnan(rule_dir),
                    rule_dir_lo + u_dir * (rule_dir_hi - rule_dir_lo), rule_dir)
    return pos, d, first


def place_all_plain(*args, **kwargs):
    """Plain version of the place kernel; the arguments are
    ``_place_all_plain``'s. Returns (ent_pos, ent_dir, agent_pos,
    agent_dir)."""
    return _place_all_plain(*args, **kwargs)[:4]


def _place_all_plain(seeds, bank, layout_id, rules, radius, slot_mask,
                     budget: int = 16, room_weight=None, seg_gate=None):
    """Plain version of the place kernel: entity slots 0..E-1 in order,
    each colliding with the valid slots placed before it, then the
    agent against all of them.

    ``seeds`` (B, E+1) u32 subseeds (int64); ``rules`` the dict of
    RULE_FIELDS rows (B, E+1, ...); ``radius`` (B, E+1) (the entities'
    radii, then the agent's); ``slot_mask`` (B, E). Returns (ent_pos
    (B, E, 3), ent_dir (B, E), agent pos (B, 3), agent dir (B,)); an
    invalid slot gets position and direction 0. Procgen mazes pass
    ``room_weight`` and ``seg_gate`` (place_one) for every placement.
    A fifth output, (B, E+1) i64, holds each slot's first passing try
    (``_place_one``; the agent's last): the tries its pose depends on.
    """
    n, e_slots = slot_mask.shape
    dev = radius.device
    ent_radius = radius[:, :e_slots]
    ent_pos = torch.zeros((n, e_slots, 3), dtype=torch.float32, device=dev)
    ent_dir = torch.zeros((n, e_slots), dtype=torch.float32, device=dev)
    placed = torch.zeros((n, e_slots), dtype=torch.bool, device=dev)
    first = []

    def place(row):
        pos, d, f = _place_one(
            seeds[:, row], bank, layout_id,
            *(rules[name][:, row] for name in RULE_FIELDS),
            radius[:, row], ent_pos[:, :, [0, 2]], ent_radius, placed,
            budget=budget, room_weight=room_weight, seg_gate=seg_gate,
        )
        first.append(f)
        return pos, d

    for e in range(e_slots):  # sequential: each slot collides with earlier ones
        pos, d = place(e)
        valid = slot_mask[:, e]
        ent_pos[:, e] = torch.where(valid[:, None], pos, torch.zeros_like(pos))
        ent_dir[:, e] = torch.where(valid, d, torch.zeros_like(d))
        placed[:, e] = valid
    agent_pos, agent_dir = place(e_slots)
    return ent_pos, ent_dir, agent_pos, agent_dir, torch.stack(first, dim=1)


def _bank_args(bank, n, room_weight, seg_gate):
    """(pointers, dims, tensors) of the kernels' room tensors and procgen
    gate (null pointers without a maze), dims (R, V, NS, Wn), for ``n``
    envs; the caller holds ``tensors`` (converted copies among them)
    until its launch."""
    if (room_weight is None) != (seg_gate is None):
        raise ValueError("the place kernels take room_weight and seg_gate together")
    L, R, V, _ = bank.room_outline.shape
    ns = bank.room_segs.shape[3]
    if seg_gate is None:
        n_walls = 0
        gate_ptrs = (ctypes.c_void_p(0),) * 3
    else:
        room_seg_wall, wall_open = seg_gate
        n_walls = wall_open.shape[1]
        gate_ptrs = (check(room_weight, "room_weight", torch.float32, (n, R)),
                     check(room_seg_wall, "room_seg_wall", torch.int32, (L, R, ns)),
                     check(wall_open, "wall_open", torch.float32, (n, n_walls)))
    rooms = dict(
        room_mask=(bank.room_mask.to(torch.uint8).contiguous(), torch.uint8, (L, R)),
        room_area=(bank.room_area, torch.float32, (L, R)),
        room_aabb=(bank.room_aabb, torch.float32, (L, R, 4)),
        room_outline=(bank.room_outline, torch.float32, (L, R, V, 2)),
        room_norms=(bank.room_norms, torch.float32, (L, R, V, 2)),
        room_vmask=(bank.room_vmask.to(torch.uint8).contiguous(), torch.uint8, (L, R, V)),
        room_segs=(bank.room_segs, torch.float32, (L, R, 4, ns)),
    )
    ptrs = tuple(check(t, name, dt, shape) for name, (t, dt, shape) in rooms.items())
    return ptrs + gate_ptrs, (R, V, ns, n_walls), rooms


def _rule_args(rules, lead):
    """Pointers to the rule rows (RULE_FIELDS order), each (*lead, ...);
    ``rules`` gets the converted tensors, which the caller holds until its
    launch."""
    tails = {"rule_bbox": (4,), "rule_pos": (3,)}
    out = []
    for name in RULE_FIELDS:
        t = rules[name]
        dt = torch.int32 if name == "rule_room" else torch.float32
        t = t.to(dt).contiguous()
        rules[name] = t
        out.append(check(t, name, dt, tuple(lead) + tails.get(name, ())))
    return out


def place_one(seed, bank, layout_id, rule_room, rule_bbox, rule_pos, rule_dir, rule_dir_lo,
              rule_dir_hi, radius, ent_pos_xz, ent_radius, ent_mask, budget: int = 16,
              room_weight=None, seg_gate=None):
    """One entity pose per env against an obstacle list: the place_one
    kernel for CUDA tensors (``csrc/place.cu``, one warp an env, the
    tries in lanes as in ``place_all``), ``place_one_plain`` for CPU
    tensors. Arguments as ``_place_one``'s, the obstacles (B, O, ...)
    with O <= 32. Returns (pos (B,3), dir (B,)). Launches count in
    ``cuda_build.LAUNCHES["place_one"]``."""
    procgen = tuple(t for t in (room_weight, *(seg_gate or ())) if t is not None)
    if not is_cuda(seed, layout_id, radius, ent_pos_xz, bank.room_segs, *procgen):
        return place_one_plain(seed, bank, layout_id, rule_room, rule_bbox, rule_pos,
                               rule_dir, rule_dir_lo, rule_dir_hi, radius, ent_pos_xz,
                               ent_radius, ent_mask, budget, room_weight, seg_gate)
    n, n_obs = ent_mask.shape
    if n_obs > _MAX_SLOTS:
        raise ValueError(f"place_one kernel takes at most {_MAX_SLOTS} obstacles, got {n_obs}")
    bank_ptrs, (R, V, ns, n_walls), _rooms = _bank_args(bank, n, room_weight, seg_gate)
    rules = dict(zip(RULE_FIELDS, (rule_room, rule_bbox, rule_pos, rule_dir, rule_dir_lo,
                                   rule_dir_hi)))
    seeds = seed.to(torch.int32).contiguous()
    xz = ent_pos_xz.to(torch.float32).contiguous()
    r_obs = ent_radius.to(torch.float32).contiguous()
    mask = ent_mask.to(torch.uint8).contiguous()
    radius = radius.to(torch.float32).contiguous()
    pos = torch.empty((n, 3), dtype=torch.float32, device=radius.device)
    d = torch.empty((n,), dtype=torch.float32, device=radius.device)
    launch(
        "mw_place_one", "place_one",
        check(seeds, "seed", torch.int32, (n,)),
        check(layout_id, "layout_id", torch.int32, (n,)),
        *_rule_args(rules, (n,)),
        check(radius, "radius", torch.float32, (n,)),
        check(xz, "ent_pos_xz", torch.float32, (n, n_obs, 2)),
        check(r_obs, "ent_radius", torch.float32, (n, n_obs)),
        check(mask, "ent_mask", torch.uint8, (n, n_obs)),
        *bank_ptrs,
        ctypes.c_int(n), ctypes.c_int(n_obs), ctypes.c_int(R), ctypes.c_int(V),
        ctypes.c_int(ns), ctypes.c_int(n_walls), ctypes.c_int(budget),
        check(pos, "pos", torch.float32, (n, 3)), check(d, "dir", torch.float32, (n,)),
        stream(),
    )
    return pos, d


def place_all(seeds, bank, layout_id, rules, radius, slot_mask, budget: int = 16,
              room_weight=None, seg_gate=None):
    """The place kernel for CUDA tensors, ``place_all_plain`` for CPU
    tensors. Same contract as ``place_all_plain``. Launches count in
    ``cuda_build.LAUNCHES["place"]`` with the render's kernels."""
    procgen = tuple(t for t in (room_weight, *(seg_gate or ())) if t is not None)
    if not is_cuda(seeds, layout_id, radius, slot_mask, bank.room_segs, *procgen):
        return place_all_plain(seeds, bank, layout_id, rules, radius, slot_mask, budget,
                               room_weight, seg_gate)
    n, e_slots = slot_mask.shape
    if e_slots > _MAX_SLOTS:
        raise ValueError(f"place kernel takes at most {_MAX_SLOTS} entity slots, got {e_slots}")
    bank_ptrs, (R, V, ns, n_walls), _rooms = _bank_args(bank, n, room_weight, seg_gate)
    rules = dict(rules)
    dev = radius.device
    ent_pos = torch.empty((n, e_slots, 3), dtype=torch.float32, device=dev)
    ent_dir = torch.empty((n, e_slots), dtype=torch.float32, device=dev)
    agent_pos = torch.empty((n, 3), dtype=torch.float32, device=dev)
    agent_dir = torch.empty((n,), dtype=torch.float32, device=dev)
    a = e_slots + 1
    seeds = seeds.to(torch.int32).contiguous()
    radius = radius.contiguous()
    slot_mask = slot_mask.to(torch.uint8).contiguous()
    launch(
        "mw_place", "place",
        check(seeds, "seeds", torch.int32, (n, a)),
        check(layout_id, "layout_id", torch.int32, (n,)),
        *_rule_args(rules, (n, a)),
        check(radius, "radius", torch.float32, (n, a)),
        check(slot_mask, "slot_mask", torch.uint8, (n, e_slots)),
        *bank_ptrs,
        ctypes.c_int(n), ctypes.c_int(e_slots), ctypes.c_int(R), ctypes.c_int(V),
        ctypes.c_int(ns), ctypes.c_int(n_walls), ctypes.c_int(budget),
        check(ent_pos, "ent_pos", torch.float32, (n, e_slots, 3)),
        check(ent_dir, "ent_dir", torch.float32, (n, e_slots)),
        check(agent_pos, "agent_pos", torch.float32, (n, 3)),
        check(agent_dir, "agent_dir", torch.float32, (n,)),
        stream(),
    )
    return ent_pos, ent_dir, agent_pos, agent_dir

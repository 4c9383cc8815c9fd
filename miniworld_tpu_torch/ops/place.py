"""Batched reset-time entity placement (rejection sampling).

Counterpart of ``miniworld_tpu/ops/place.py`` (reference:
MiniWorldEnv.place_entity, miniworld/miniworld.py:922-992): a fixed
retry budget, the first valid try wins, an in-room clamped fallback
when every try fails. The budgeted tries run as a loop over ``budget``
with every env advanced together; draws are the counter-based uniforms
of ops/rng.py, so each env sees the JAX package's numbers.
"""

from __future__ import annotations

import torch

from miniworld_tpu_torch.ops import geom, rng as rng_ops


def sample_room(u, room_mask, room_area):
    """(B,) room index drawn proportionally to floor bbox area from
    uniforms u (B,); room_mask/room_area are (B, R) per-env rows."""
    probs = torch.where(room_mask, room_area, torch.zeros_like(room_area))
    cdf = torch.cumsum(probs, dim=1)
    pick = (u * cdf[:, -1])[:, None] < cdf
    return torch.argmax(pick.to(torch.int32), dim=1)


def place_one(seed, bank, layout_id, rule_room, rule_bbox, rule_pos,
              rule_dir, rule_dir_lo, rule_dir_hi, radius, ent_pos_xz,
              ent_radius, ent_mask, budget: int = 16):
    """Sample one entity pose per env. Returns (pos (B,3), dir (B,)).

    ``seed`` (B,) u32 subseeds; ``bank`` the device Layout (leading
    layout axis), rows picked by ``layout_id`` (B,). Rule tensors are
    per env: rule_room (B,), rule_bbox (B,4), rule_pos (B,3), rule_dir /
    lo / hi (B,); radius (B,); ent_* (B,E,...) the entities placed so far.
    """
    lid = layout_id.long()
    room_mask = bank.room_mask[lid]
    room_area = bank.room_area[lid]
    us = rng_ops.uniforms(seed, 1, (budget + 2, 4))  # (B, budget+2, 4)

    def room_for(u0):
        return torch.where(rule_room >= 0, rule_room.long(),
                           sample_room(u0, room_mask, room_area))

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
        wall_hit = geom.circle_segs4(pos_xz, radius, segs4)
        ent_hit = geom.circle_vs_entities(pos_xz, radius, ent_pos_xz,
                                          ent_radius, ent_mask) >= 0
        return pos, inside & ~wall_hit & ~ent_hit

    pos, _ = one_try(us[:, budget])
    found = torch.zeros_like(radius, dtype=torch.bool)
    for i in range(budget):
        cand, ok = one_try(us[:, i])
        take = ok & ~found
        pos = torch.where(take[:, None], cand, pos)
        found = found | ok

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
    return pos, d

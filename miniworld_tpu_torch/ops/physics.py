"""Agent dynamics, collision, pickup/drop over a batch of envs.

Counterpart of ``miniworld_tpu/ops/physics.py`` (reference hot loop:
MiniWorldEnv.step / move_agent / _update_agent_orientation / intersect,
miniworld/miniworld.py:691-813, 1020-1058). Same mask-based control
flow — both branches computed, selected per env — with the vmap axis
written out as a leading batch dimension B.
"""

from __future__ import annotations

import math

import torch

from miniworld_tpu_torch.ops import geom
from miniworld_tpu_torch.state import EnvState, StepResult

AGENT_RADIUS = 0.4  # miniworld/entity.py:470
PITCH_LIMIT = 89.0  # miniworld/miniworld.py:729-731

_ACTION_LOW = (-1.0, -1.0, -1.0, -1.0, 0.0, 0.0)
_ACTION_HIGH = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


def take_ent(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for per-env entity tables x (B, E, ...)."""
    return x[_rows(x), idx.long()]


def set_ent(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Copy of x with x[b, idx[b]] = val[b]."""
    out = x.clone()
    out[_rows(x), idx.long()] = val
    return out


def _sel(pred, a, b):
    return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim())), a, b)


def intersect(segs4, state: EnvState, pos, radius, skip_ent=None,
              include_agent: bool = False, agent_radius: float = AGENT_RADIUS):
    """Collision query (miniworld.py:1020-1046), Y ignored.

    ``segs4`` (B, 4, NS): the room-local wall packs. ``skip_ent`` (B,)
    or None. Returns (wall_hit (B,) bool, first_ent (B,) i32 or -1); with
    ``include_agent`` the agent's circle reports as index E.
    """
    pos_xz = torch.stack([pos[:, 0], pos[:, 2]], dim=-1)
    wall_hit = geom.circle_segs4(pos_xz, radius, segs4)

    num_ents = state.ent_pos.shape[1]
    mask = state.ent_alive
    if skip_ent is not None:
        idxs = torch.arange(num_ents, device=pos.device)
        mask = mask & (idxs[None, :] != skip_ent[:, None])
    ent_xz = state.ent_pos[:, :, [0, 2]]
    first_ent = geom.circle_vs_entities(pos_xz, radius, ent_xz,
                                        state.ent_radius, mask)
    if include_agent:
        dx = state.pos[:, 0] - pos_xz[:, 0]
        dz = state.pos[:, 2] - pos_xz[:, 1]
        d2 = dx * dx + dz * dz
        rsum = radius + agent_radius
        agent_hit = d2 < rsum * rsum
        first_ent = torch.where((first_ent < 0) & agent_hit,
                                torch.full_like(first_ent, num_ents), first_ent)
    return wall_hit, first_ent


def carry_pos(state: EnvState, agent_pos, ent_idx, max_forward_step: float,
              agent_radius: float = AGENT_RADIUS):
    """Position of a carried object (miniworld.py:677-689), (B,3)."""
    r_e = take_ent(state.ent_radius, ent_idx)
    h_e = take_ent(state.ent_height, ent_idx)
    dist = agent_radius + r_e + max_forward_step
    p = agent_pos + geom.yaw_dir_vec(state.dir) * 1.05 * dist[:, None]
    y = torch.clamp(state.cam_height - h_e - 0.3, min=0.0)
    return torch.stack([p[:, 0], y, p[:, 2]], dim=-1)


def update_orientation(segs4, state: EnvState, yaw_delta, pitch_delta,
                       max_forward_step: float,
                       agent_radius: float = AGENT_RADIUS) -> EnvState:
    """Yaw/pitch update with carried-object collision revert
    (miniworld.py:719-745)."""
    has_carry = state.carrying >= 0
    c = torch.clamp(state.carrying, min=0)
    new_dir = state.dir + yaw_delta
    new_pitch = torch.clamp(state.cam_pitch + pitch_delta, -PITCH_LIMIT, PITCH_LIMIT)
    turned = state.replace(dir=new_dir, cam_pitch=new_pitch)

    p = carry_pos(turned, turned.pos, c, max_forward_step, agent_radius)
    wall_hit, ent_hit = intersect(
        segs4, turned, p, take_ent(turned.ent_radius, c), skip_ent=c,
        include_agent=True, agent_radius=agent_radius,
    )
    blocked = has_carry & (wall_hit | (ent_hit >= 0))
    apply_carry = has_carry & ~blocked
    ent_pos = _sel(apply_carry, set_ent(turned.ent_pos, c, p), turned.ent_pos)
    ent_dir = _sel(apply_carry, set_ent(turned.ent_dir, c, turned.dir),
                   turned.ent_dir)
    return turned.replace(
        dir=torch.where(blocked, state.dir, turned.dir),
        cam_pitch=torch.where(blocked, state.cam_pitch, turned.cam_pitch),
        ent_pos=ent_pos,
        ent_dir=ent_dir,
    )


def move_agent(segs4, state: EnvState, fwd_dist, strafe_dist,
               max_forward_step: float, agent_radius: float = AGENT_RADIUS):
    """Translation with collision + carried object (miniworld.py:691-717)."""
    has_carry = state.carrying >= 0
    c = torch.clamp(state.carrying, min=0)
    next_pos = (
        state.pos
        + geom.yaw_dir_vec(state.dir) * fwd_dist[:, None]
        + geom.yaw_right_vec(state.dir) * strafe_dist[:, None]
    )
    agent_r = torch.full_like(fwd_dist, agent_radius)
    wall_hit, ent_hit = intersect(segs4, state, next_pos, agent_r)
    agent_blocked = wall_hit | (ent_hit >= 0)

    p = carry_pos(state, next_pos, c, max_forward_step, agent_radius)
    w2, e2 = intersect(segs4, state, p, take_ent(state.ent_radius, c),
                       skip_ent=c, include_agent=True,
                       agent_radius=agent_radius)
    carry_blocked = has_carry & (w2 | (e2 >= 0))

    moved = ~agent_blocked & ~carry_blocked
    apply_carry = moved & has_carry
    ent_pos = _sel(apply_carry, set_ent(state.ent_pos, c, p), state.ent_pos)
    ent_dir = _sel(apply_carry, set_ent(state.ent_dir, c, state.dir), state.ent_dir)
    new_state = state.replace(
        pos=_sel(moved, next_pos, state.pos),
        ent_pos=ent_pos,
        ent_dir=ent_dir,
    )
    return new_state, moved


def physics_step(proto_pickable, state: EnvState, action, *, segs4,
                 max_forward_step: float, fwd_step, fwd_drift, turn_step,
                 agent_radius: float = AGENT_RADIUS):
    """One physics step from clipped 6-D actions (B, 6)
    (miniworld.py:778-797). ``proto_pickable`` (B, P) is each env's
    prototype table row. ``fwd_step`` / ``fwd_drift`` / ``turn_step``
    are this step's parameters: floats (their defaults) or (B,) tensors
    (each env's domain-randomized draw). Returns (state, StepResult)."""
    yaw_delta = action[:, 2] * turn_step * (math.pi / 180.0)
    pitch_delta = action[:, 3] * turn_step
    state = update_orientation(segs4, state, yaw_delta, pitch_delta,
                               max_forward_step, agent_radius)

    forward_dist = action[:, 0] * fwd_step
    strafe_dist = action[:, 1] * fwd_step + fwd_drift
    state, moved = move_agent(segs4, state, forward_dist, strafe_dist,
                              max_forward_step, agent_radius)

    # Pickup probe (miniworld.py:789-793)
    test_pos = state.pos + geom.yaw_dir_vec(state.dir) * 1.5 * agent_radius
    probe_r = torch.full_like(forward_dist, 1.2 * agent_radius)
    wall_hit, first_ent = intersect(segs4, state, test_pos, probe_r)
    first_proto = take_ent(state.ent_proto, torch.clamp(first_ent, min=0))
    pickable = take_ent(proto_pickable, first_proto)
    can_pick = (
        (action[:, 4] > 0.5)
        & (state.carrying < 0)
        & ~wall_hit
        & (first_ent >= 0)
        & pickable
    )
    minus1 = torch.full_like(first_ent, -1)
    picked = torch.where(can_pick, first_ent, minus1)
    state = state.replace(carrying=torch.where(can_pick, first_ent, state.carrying))

    # Drop (miniworld.py:795-797)
    do_drop = (action[:, 5] > 0.5) & (state.carrying >= 0)
    c = torch.clamp(state.carrying, min=0)
    cur = take_ent(state.ent_pos, c)
    dropped_row = torch.stack(
        [cur[:, 0], torch.where(do_drop, torch.zeros_like(cur[:, 1]), cur[:, 1]),
         cur[:, 2]], dim=-1,
    )
    dropped = torch.where(do_drop, state.carrying, minus1)
    state = state.replace(
        ent_pos=set_ent(state.ent_pos, c, dropped_row),
        carrying=torch.where(do_drop, minus1, state.carrying),
    )
    return state, StepResult(moved=moved, picked_up=picked, dropped=dropped)


def near(state: EnvState, idx0: int, idx1: int | None = None, *,
         max_forward_step: float, agent_radius: float = AGENT_RADIUS):
    """(B,) proximity predicate (miniworld.py:1048-1058): 3-D distance vs
    r0 + r1 + 1.1 * max forward step; ``idx1=None`` means the agent."""
    p0 = state.ent_pos[:, idx0]
    r0 = state.ent_radius[:, idx0]
    if idx1 is None:
        p1, r1 = state.pos, agent_radius
    else:
        p1, r1 = state.ent_pos[:, idx1], state.ent_radius[:, idx1]
    dist = torch.linalg.vector_norm(p0 - p1, dim=-1)
    return dist < r0 + r1 + 1.1 * max_forward_step


def clip_action(action: torch.Tensor) -> torch.Tensor:
    """Clip (B, 6) actions to the Box bounds (miniworld.py:483-487);
    NaNs map to 0."""
    low = torch.tensor(_ACTION_LOW, dtype=torch.float32, device=action.device)
    high = torch.tensor(_ACTION_HIGH, dtype=torch.float32, device=action.device)
    return torch.clamp(torch.nan_to_num(action), low, high)

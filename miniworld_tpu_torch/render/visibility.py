"""Entity visibility query of the PyTorch port (``MiniWorldVec.visible_ents``).

Counterpart of ``miniworld_tpu/render/visibility.py`` (the reference's
``get_visible_ents``, miniworld/miniworld.py:1576-1670: the rooms alone
rendered into a depth buffer, then a 0.2 m box at each entity's base
position drawn inside an occlusion query). Per pixel: the nearest room
prim along the agent camera's ray (``_room_depth``, with the dense
``tri_active`` kill of a procgen maze), then each alive entity's query
box slab-tested against the same ray; the entity is visible where some
pixel enters its box in front of that depth.

One hand-written CUDA kernel for Hopper (``csrc/visible_ents.cu``) with
its plain PyTorch version beside it. The wrapper takes the plain version
ONLY for tensors on the CPU; for CUDA tensors it launches the kernel
(and adds one to ``cuda_build.LAUNCHES["visible_ents"]``) or raises.
The arithmetic is the JAX expressions', operation by operation: rays
materialised as fwd + xv right + yv up (``raycast.camera_rays``), the
unnormalised test cov <= det, t > NEAR, the slabs' true divisions.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from miniworld_tpu_torch.ops import geom
from miniworld_tpu_torch.render.cuda_build import check, is_cuda, launch, stream
from miniworld_tpu_torch.render.raycast import FAR, NEAR, Camera, _cam_args, _env_blocks
from miniworld_tpu_torch.render.topview import row_live, wall_codes

# Query box half-extent and height (miniworld/miniworld.py:1640-1647)
BOX_R = 0.1
BOX_H = 0.2
# A staged room row: v0, e1 = v1 - v0, e2 = v2 - v0, kind, 0, 0
VIS_FIELDS = 12
# The most entity slots the kernel flags (csrc/visible_ents.cu MAX_E)
MAX_KERNEL_ENTS = 64
# The kernel's counts (csrc/visible_ents.cu N_STATS) and its tiles
N_STATS = 6
VIS_TILE = (16, 8)


class VisStatics(NamedTuple):
    """Each layout's room rows, the prims the query's depth buffer holds
    (``vis_statics``)."""

    rows: torch.Tensor  # (L, Sr, VIS_FIELDS) f32
    row_code: torch.Tensor  # (L, Sr) i32 maze kill (topview.wall_codes), -2 padding


def vis_statics(bank, device=None) -> VisStatics:
    """The room rows of ``bank`` (the port's Layout): every row with
    ``tri_mask & tri_is_room`` and a maze code other than "never", in
    bank order, as v0, e1 and e2 (the JAX expression's float32
    subtractions) and the kind column."""
    device = bank.tri_mask.device if device is None else device
    verts = bank.tri_verts.cpu().to(torch.float32)
    kind = bank.tri_attr[..., 15].cpu().to(torch.float32)
    code = wall_codes(bank)
    keep = bank.tri_mask.cpu() & bank.tri_is_room.cpu() & (code != -2)
    L = verts.shape[0]
    sr = max(int(keep.sum(dim=1).max()), 1)
    rows = torch.zeros((L, sr, VIS_FIELDS), dtype=torch.float32)
    codes = torch.full((L, sr), -2, dtype=torch.int32)
    for li in range(L):
        ids = torch.nonzero(keep[li])[:, 0]
        v = verts[li, ids]
        v0 = v[:, 0]
        rows[li, :ids.shape[0], :9] = torch.cat([v0, v[:, 1] - v0, v[:, 2] - v0], dim=1)
        rows[li, :ids.shape[0], 9] = kind[li, ids]
        codes[li, :ids.shape[0]] = code[li, ids]
    return VisStatics(rows.to(device).contiguous(), codes.to(device).contiguous())


def _rays(cam: Camera):
    """(B, HW, 3) ray directions, fwd + xv * right + yv * up per
    component (raycast.camera_rays)."""
    xv, yv = cam.xv()[:, :, None], cam.yv()[:, :, None]
    return (cam.fwd[:, None, :] + xv * cam.right[:, None, :]) + yv * cam.up[:, None, :]


def room_depth_plain(st: VisStatics, layout_id, wall_open, cam: Camera):
    """(B, HW) f32 nearest live room-row hit per ray, inf where none
    (visibility._room_depth): per (env, row) g_det = e2 x e1, g_u = e2 x
    s, g_v = s x e1 with s = origin - v0, t_num = e2 . g_v; per pixel
    det, u_num and v_num the ray's K=3 dots, hit where det > 1e-12, u_num
    >= 0, v_num >= 0, max(u, v) + kind min(u, v) <= det and NEAR < t <
    FAR, t = t_num * (1 / det). Runs over blocks of envs."""
    b, sr = layout_id.shape[0], st.rows.shape[1]
    hw = cam.width * cam.height
    out = []
    for sl in _env_blocks(b, sr * hw):
        lid = layout_id[sl].long()
        r = st.rows[lid]  # (n, Sr, 12)
        v0, e1, e2 = r[..., 0:3], r[..., 3:6], r[..., 6:9]
        s = cam.origin[sl][:, None, :] - v0
        g_det, g_u, g_v = geom.cross(e2, e1), geom.cross(e2, s), geom.cross(s, e1)
        t_num = (e2[..., 0] * g_v[..., 0] + e2[..., 1] * g_v[..., 1]) + e2[..., 2] * g_v[..., 2]
        d = _rays(Camera(*(x[sl] for x in cam[:6]), cam.xbase, cam.ybase))[:, :, None, :]

        def dot(g):  # (n, HW, Sr)
            g = g[:, None, :, :]
            return (d[..., 0] * g[..., 0] + d[..., 1] * g[..., 1]) + d[..., 2] * g[..., 2]

        det, u_num, v_num = dot(g_det), dot(g_u), dot(g_v)
        inv_det = 1.0 / torch.where(det > 1e-12, det, torch.ones_like(det))
        t = t_num[:, None, :] * inv_det
        kind = r[:, None, :, 9]
        cov = torch.maximum(u_num, v_num) + kind * torch.minimum(u_num, v_num)
        live = row_live(st.row_code[lid], None if wall_open is None else wall_open[sl])
        hit = ((det > 1e-12) & (u_num >= 0.0) & (v_num >= 0.0) & (cov <= det)
               & (t > NEAR) & (t < FAR) & live[:, None, :])
        out.append(torch.where(hit, t, torch.full_like(t, math.inf)).amin(dim=2))
    return torch.cat(out)


def box_entry(cam: Camera, ent_pos):
    """(t_in, hit) (B, HW, E): where each pixel's ray enters each entity's
    query box (pos + (-0.1, 0, -0.1) to pos + (0.1, 0.2, 0.1); slabs by
    true division of ((pos + lo) - o) with |d| < 1e-12 taken as 1e-12),
    hit where t_in <= t_out and NEAR < t_in < FAR; no depth, no liveness."""
    dev = ent_pos.device
    lo_off = torch.tensor([-BOX_R, 0.0, -BOX_R], dtype=torch.float32, device=dev)
    hi_off = torch.tensor([BOX_R, BOX_H, BOX_R], dtype=torch.float32, device=dev)
    d = _rays(cam)  # (n, HW, 3)
    safe_d = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)[:, :, None, :]
    o = cam.origin[:, None, None, :]
    pos = ent_pos[:, None, :, :]  # (n, 1, E, 3)
    t1 = ((pos + lo_off) - o) / safe_d  # (n, HW, E, 3)
    t2 = ((pos + hi_off) - o) / safe_d
    t_in = torch.minimum(t1, t2).amax(dim=3)
    t_out = torch.maximum(t1, t2).amin(dim=3)
    return t_in, (t_in <= t_out) & (t_in > NEAR) & (t_in < FAR)


def visible_ents_plain(st: VisStatics, layout_id, wall_open, cam: Camera, ent_pos, ent_alive):
    """Plain version of the visible_ents kernel (visibility.visible_ents):
    (B, E) bool, alive and some pixel whose ray enters the entity's query
    box (``box_entry``) in front of ``room_depth_plain``. cam: the agent
    camera at the observation's size. Runs over blocks of envs."""
    d_static = room_depth_plain(st, layout_id, wall_open, cam)  # (B, HW)
    b, E = ent_alive.shape
    out = []
    for sl in _env_blocks(b, E * cam.width * cam.height * 3):
        t_in, hit = box_entry(Camera(*(x[sl] for x in cam[:6]), cam.xbase, cam.ybase),
                              ent_pos[sl])
        hit = hit & (t_in < d_static[sl][:, :, None])
        out.append(ent_alive[sl] & hit.any(dim=1))
    return torch.cat(out)


def visible_ents(st: VisStatics, layout_id, wall_open, cam: Camera, ent_pos, ent_alive,
                 stats=None):
    """The visible_ents kernel for CUDA tensors, the plain version for CPU
    tensors. Same contract as ``visible_ents_plain``. ``stats``: a (6,)
    int64 CUDA tensor of zeros to which the kernel adds its counts (envs
    that staged rows, (tile, entity) pairs the cull kept, slab tests,
    occlusion scans, rows those scans tested, rows staged); not read on
    the CPU."""
    wo = () if wall_open is None else (wall_open,)
    if not is_cuda(layout_id, st.rows, cam.origin, ent_pos, ent_alive, *wo):
        return visible_ents_plain(st, layout_id, wall_open, cam, ent_pos, ent_alive)
    L, sr = st.row_code.shape
    b, E = ent_alive.shape
    nw = 0 if wall_open is None else wall_open.shape[1]
    if E > MAX_KERNEL_ENTS:
        raise ValueError(f"visible_ents kernel takes at most {MAX_KERNEL_ENTS} entity slots, "
                         f"got {E}")
    alive = ent_alive.to(torch.uint8).contiguous()
    out = torch.zeros((b, E), dtype=torch.uint8, device=ent_pos.device)
    cam_ptrs, _cam_tensors = _cam_args(cam, b)
    extra = () if stats is None else (check(stats, "stats", torch.int64, (N_STATS,)),)
    launch(
        "mw_visible_ents" if stats is None else "mw_visible_ents_stats", "visible_ents",
        check(st.rows, "rows", torch.float32, (L, sr, VIS_FIELDS)),
        check(st.row_code, "row_code", torch.int32, (L, sr)),
        check(layout_id, "layout_id", torch.int32, (b,)),
        ctypes.c_void_p(0) if wall_open is None
        else check(wall_open, "wall_open", torch.float32, (b, nw)),
        *cam_ptrs,
        check(ent_pos, "ent_pos", torch.float32, (b, E, 3)),
        check(alive, "ent_alive", torch.uint8, (b, E)),
        ctypes.c_int(b), ctypes.c_int(sr), ctypes.c_int(E), ctypes.c_int(cam.width),
        ctypes.c_int(cam.height), ctypes.c_int(nw),
        check(out, "visible", torch.uint8, (b, E)),
        *extra,
        stream(),
    )
    return out.bool()

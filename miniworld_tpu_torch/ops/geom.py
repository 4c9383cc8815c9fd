"""Batched geometry ops (counterpart of ``miniworld_tpu/ops/geom.py``).

Every function takes batch-major tensors: a leading env axis B replaces
the JAX package's vmap. Conventions are the JAX package's (and the
reference's): +Y up, floor y=0, yaw ``d`` gives forward
(cos d, 0, -sin d) and right (sin d, 0, cos d); collision lives in the
XZ plane. Arithmetic follows the JAX expressions term by term so the
two packages agree to float32 rounding.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _libm(name: str):
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float]
    return np.frompyfunc(fn, 1, 1)


def _unary(name: str, x: torch.Tensor, torch_fn) -> torch.Tensor:
    """float32 ``name`` of ``x``: the C library's ``name``f on the CPU —
    the function XLA:CPU evaluates for the JAX package, so camera frames
    and moves agree bit for bit there (the keyed z-buffer's depth
    quantization turns one-ulp camera differences into depth steps) —
    and torch's own (CUDA's ``name``f, as the kernels call) elsewhere.
    The CPU path is per element: it serves the parity tests' small
    batches, not the card."""
    if x.device.type != "cpu":
        return torch_fn(x)
    a = x.detach().to(torch.float32).numpy()
    out = _libm(name + "f")(a).astype(np.float32) if a.size else a.copy()
    return torch.from_numpy(np.asarray(out, np.float32).reshape(a.shape))


@functools.lru_cache(maxsize=None)
def _libm_atan2f():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.atan2f.restype = ctypes.c_float
    lib.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
    return np.frompyfunc(lib.atan2f, 2, 1)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2: on the CPU the C library's ``atan2f``, which XLA:CPU
    calls (numpy's float32 arctan2 may take a vector library's, an ulp
    away); elsewhere torch's."""
    if x.device.type != "cpu":
        return torch.atan2(y, x)
    a, b = y.detach().to(torch.float32).numpy(), x.detach().to(torch.float32).numpy()
    out = _libm_atan2f()(a, b).astype(np.float32) if a.size else a.copy()
    return torch.from_numpy(np.asarray(out, np.float32).reshape(a.shape))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once (IEEE), as XLA:CPU and the
    kernels' ``sqrtf`` compute it. On the CPU numpy's: torch's goes
    through MKL's vector math there, which is within one ulp, and on a
    process's first call has returned one thread's share of a large
    tensor far less accurate, so that two renders of one state differed.
    Elsewhere torch's."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.asarray(np.sqrt(x.detach().to(torch.float32).numpy())))


def cos(x):
    return _unary("cos", x, torch.cos)


def sin(x):
    return _unary("sin", x, torch.sin)


def tan(x):
    return _unary("tan", x, torch.tan)


def log(x):
    return _unary("log", x, torch.log)


def log1p(x):
    return _unary("log1p", x, torch.log1p)


def yaw_dir_vec(d: torch.Tensor) -> torch.Tensor:
    """Forward movement direction for yaw ``d`` (entity.py:95-103)."""
    return torch.stack([cos(d), torch.zeros_like(d), -sin(d)], dim=-1)


def yaw_right_vec(d: torch.Tensor) -> torch.Tensor:
    """Rightward direction for yaw ``d`` (entity.py:105-113)."""
    return torch.stack([sin(d), torch.zeros_like(d), cos(d)], dim=-1)


def circle_segs4(point_xz: torch.Tensor, radius: torch.Tensor,
                 segs4: torch.Tensor) -> torch.Tensor:
    """(B,) bool: circle (B,2)/(B,) vs component-major segment packs
    (B, 4, NS) of rows [a_x, a_z, b_x, b_z]; pad columns are far away."""
    ax, az, bx, bz = segs4[:, 0], segs4[:, 1], segs4[:, 2], segs4[:, 3]
    px = point_xz[:, 0:1]
    pz = point_xz[:, 1:2]
    abx, abz = bx - ax, bz - az
    apx = px - ax
    apz = pz - az
    t = (apx * abx + apz * abz) / torch.clamp(abx * abx + abz * abz, min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    dx = ax + t * abx - px
    dz = az + t * abz - pz
    r = radius[:, None]
    return torch.any(dx * dx + dz * dz < r * r, dim=1)


def point_inside_convex(p_xz, outline_xz, edge_norms_xz, vert_mask):
    """(B,) bool: point (B,2) strictly inside a convex outline (B,V,2)
    with inward edge normals (B,V,2); padded vertices (mask False) pass
    (Room.point_inside, miniworld/miniworld.py:273-285)."""
    ap = p_xz[:, None, :] - outline_xz
    dot = edge_norms_xz[..., 0] * ap[..., 0] + edge_norms_xz[..., 1] * ap[..., 1]
    ok = torch.where(vert_mask, dot > 0.0, torch.ones_like(vert_mask))
    return torch.all(ok, dim=1)


def circle_vs_entities(pos_xz, radius, ent_pos_xz, ent_radius, ent_mask):
    """(B,) int32 index of the first overlapping entity, or -1
    (MiniWorldEnv.intersect entity loop, miniworld/miniworld.py:1034-1044).

    pos_xz (B,2), radius (B,), ent_pos_xz (B,E,2), ent_radius (B,E),
    ent_mask (B,E) (must already exclude the queried entity itself)."""
    dx = ent_pos_xz[..., 0] - pos_xz[:, 0:1]
    dz = ent_pos_xz[..., 1] - pos_xz[:, 1:2]
    d2 = dx * dx + dz * dz
    rsum = radius[:, None] + ent_radius
    hit = (d2 < rsum * rsum) & ent_mask
    idx = torch.argmax(hit.to(torch.int32), dim=1).to(torch.int32)
    return torch.where(hit.any(dim=1), idx, torch.full_like(idx, -1))


def cam_basis(yaw: torch.Tensor, pitch_deg: torch.Tensor):
    """Camera (forward, up, right) basis, each (B,3), from yaw and pitch
    (Agent.cam_dir / cam_up, miniworld/entity.py:488-517)."""
    p = torch.deg2rad(pitch_deg)
    cp, sp = cos(p), sin(p)
    cy, sy = cos(yaw), sin(yaw)
    fwd = torch.stack([cp * cy, sp, -cp * sy], dim=-1)
    up = torch.stack([-sp * cy, cp, sp * sy], dim=-1)
    right = cross(fwd, up)
    return fwd, up, right


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, componentwise as jnp.cross computes it
    (torch.linalg.cross rounds differently)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def cam_position(pos, yaw, cam_height, cam_fwd_disp):
    """Camera eye position (Agent.cam_pos, miniworld/entity.py:476-486)."""
    disp = yaw_dir_vec(yaw) * cam_fwd_disp[..., None]
    zero = torch.zeros_like(cam_height)
    return pos + disp + torch.stack([zero, cam_height, zero], dim=-1)

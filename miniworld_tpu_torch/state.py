"""Batched env state for the PyTorch port.

Counterpart of ``miniworld_tpu/state.py``. The JAX package keeps one
``EnvState`` pytree per env and vmaps over it; here every field carries
an explicit leading batch axis B, so the same dataclass holds all envs:

  * floats are float32, ints int32 (as in the JAX package);
  * ``rng`` holds each env's threefry key data, (B, 2) int64 whose
    values are the two uint32 words (ops/rng.py does its u32 arithmetic
    in int64);
  * ``tri_slots`` is the (B,) texture-variant key, also a uint32 value
    in int64.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass
class EnvState:
    # --- agent (reference: miniworld/entity.py:455-529) ---
    pos: torch.Tensor  # (B,3) f32 floor-level position
    dir: torch.Tensor  # (B,) f32 yaw radians
    cam_pitch: torch.Tensor  # (B,) f32 degrees
    cam_height: torch.Tensor  # (B,) f32
    cam_fov_y: torch.Tensor  # (B,) f32 degrees
    cam_fwd_disp: torch.Tensor  # (B,) f32
    carrying: torch.Tensor  # (B,) i32 entity index or -1

    # --- entities (padded to the env class's slot count E) ---
    ent_pos: torch.Tensor  # (B,E,3) f32
    ent_dir: torch.Tensor  # (B,E) f32
    ent_alive: torch.Tensor  # (B,E) bool
    ent_proto: torch.Tensor  # (B,E) i32 prototype row
    ent_color: torch.Tensor  # (B,E,3) f32
    ent_size: torch.Tensor  # (B,E,3) f32
    ent_radius: torch.Tensor  # (B,E) f32
    ent_height: torch.Tensor  # (B,E) f32

    # --- episode ---
    step_count: torch.Tensor  # (B,) i32
    rng: torch.Tensor  # (B,2) int64 threefry key data (u32 words)
    layout_id: torch.Tensor  # (B,) i32 index into the layout bank

    # per-episode domain randomization samples
    sky_color: torch.Tensor  # (B,3) f32
    light_pos: torch.Tensor  # (B,3) f32
    light_color: torch.Tensor  # (B,3) f32
    light_ambient: torch.Tensor  # (B,3) f32
    tex_map: torch.Tensor  # (B,T) i32 texture slot -> atlas index
    tri_slots: torch.Tensor  # (B,) int64 u32 texture-variant key

    # procgen wall-open bitmask; None for banks without procgen
    wall_open: Any = None
    # env-specific task state (dict of (B, ...) tensors)
    task: dict = field(default_factory=dict)

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)

    def tensors(self) -> dict:
        """Field name -> tensor, for every tensor field (task included)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                out[f.name] = v
        for k, v in self.task.items():
            out[f"task.{k}"] = v
        return out

    def to(self, device) -> "EnvState":
        def mv(v):
            return v.to(device) if isinstance(v, torch.Tensor) else v

        return dataclasses.replace(
            self,
            **{f.name: mv(getattr(self, f.name))
               for f in dataclasses.fields(self) if f.name != "task"},
            task={k: mv(v) for k, v in self.task.items()},
        )


@dataclass
class StepResult:
    """Side-channel outputs of the physics step used by task logic."""

    moved: torch.Tensor  # (B,) bool agent translation applied
    picked_up: torch.Tensor  # (B,) i32 entity picked this step, or -1
    dropped: torch.Tensor  # (B,) i32 entity dropped this step, or -1


def _bcast(pred: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return pred.reshape(pred.shape + (1,) * (x.dim() - pred.dim()))


def tree_select(pred: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per-env ``torch.where`` over every field: ``a`` where ``pred``."""

    def sel(x, y):
        if x is None:
            return None
        return torch.where(_bcast(pred, x), x, y)

    return dataclasses.replace(
        a,
        **{f.name: sel(getattr(a, f.name), getattr(b, f.name))
           for f in dataclasses.fields(a) if f.name != "task"},
        task={k: sel(a.task[k], b.task[k]) for k in a.task},
    )

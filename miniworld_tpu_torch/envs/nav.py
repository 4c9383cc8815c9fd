"""Navigation specs of the port's first slice.

Counterpart of ``miniworld_tpu/envs/nav.py``: the Hallway spec only
(envs/hallway.py:45-74 in the reference). The other navigation envs
join with their slices (ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from miniworld_tpu_torch.envs.base import (
    DIR_QUARTER,
    GoToEnvSpec,
    default_discrete_actions,
)


@dataclass
class Hallway(GoToEnvSpec):
    """Red box at the end of a hallway (envs/hallway.py:45-74)."""

    name: str = "Hallway"
    gym_id: str = "MiniWorld-Hallway-v0"
    max_episode_steps: int = 250
    discrete_actions: np.ndarray = field(default_factory=default_discrete_actions)
    length: float = 12

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        room = world.add_rect_room(
            min_x=-1, max_x=-1 + self.length, min_z=-2, max_z=2
        )
        box = world.proto_id("box", "red")
        world.place(box, min_x=room.max_x - 2)
        if rng is not None:
            d = float(rng.uniform(-math.pi / 4, math.pi / 4))
            world.place_agent(dir=d, max_x=room.max_x - 2)
        else:
            world.place_agent(dir_range=DIR_QUARTER, max_x=room.max_x - 2)

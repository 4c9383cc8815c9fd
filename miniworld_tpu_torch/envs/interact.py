"""Interactive specs ported so far: PickupObjects.

Counterpart of ``miniworld_tpu/envs/interact.py`` (reference
envs/pickupobjects.py); the other pickup/drop tasks and Sign join with
their slices (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from miniworld_tpu_torch.envs.base import Ctx, EnvSpec, action_from_components
from miniworld_tpu_torch.scene.entities import COLOR_NAMES


@dataclass
class PickupObjects(EnvSpec):
    """Pick up 5 random objects; +1 each, all picked -> done
    (envs/pickupobjects.py:43-103)."""

    name: str = "PickupObjects"
    gym_id: str = "MiniWorld-PickupObjects-v0"
    max_episode_steps: int = 400
    size: float = 12
    num_objs: int = 5
    discrete_actions: np.ndarray = field(
        default_factory=lambda: np.stack(
            [
                action_from_components(turn=-1.0),
                action_from_components(turn=1.0),
                action_from_components(forward=1.0),
                action_from_components(forward=-1.0),
                action_from_components(pickup=1.0),
            ]
        )
    )

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        world.add_rect_room(
            min_x=0, max_x=self.size, min_z=0, max_z=self.size,
            wall_tex="brick_wall", floor_tex="asphalt", no_ceiling=True,
        )
        if rng is not None:
            # Reference rng order per object: choice(3 types), choice(6
            # colors), then placement (pickupobjects.py:76-85).
            for _ in range(self.num_objs):
                t = int(rng.choice(3))
                color = COLOR_NAMES[int(rng.choice(len(COLOR_NAMES)))]
                if t == 1:
                    world.place(world.proto_id("box", color, 0.9))
                elif t == 0:
                    world.place(world.proto_id("ball", color, 0.9))
                else:
                    world.place(world.proto_id("key", color))
        else:
            choices = (
                [world.proto_id("ball", c, 0.9) for c in COLOR_NAMES]
                + [world.proto_id("box", c, 0.9) for c in COLOR_NAMES]
                + [world.proto_id("key", c) for c in COLOR_NAMES]
            )
            for _ in range(self.num_objs):
                world.place(choices)
        world.place_agent()

    def init_task(self):
        return {"num_picked_up": np.int32(0)}

    def transition(self, ctx: Ctx):
        # Anything the agent is carrying after the step disappears and
        # scores (pickupobjects.py:94-101): the JAX package's
        # ``ent_alive.at[c].set(...)`` as one masked write over the batch.
        s = ctx.state
        has = s.carrying >= 0
        slots = torch.arange(s.ent_alive.shape[1], device=s.ent_alive.device)
        picked = has[:, None] & (slots[None, :] == s.carrying[:, None].long())
        n = s.task["num_picked_up"] + has.to(torch.int32)
        new_state = s.replace(
            ent_alive=s.ent_alive & ~picked,
            carrying=torch.where(has, torch.full_like(s.carrying, -1), s.carrying),
            task={"num_picked_up": n},
        )
        reward = has.to(torch.float32)
        term = n >= self.num_objs
        return reward, term, new_state

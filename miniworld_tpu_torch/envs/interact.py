"""Interactive specs: PickupObjects, PutNext, CollectHealth and Sign.

Counterpart of ``miniworld_tpu/envs/interact.py`` (reference
envs/pickupobjects.py, putnext.py, collecthealth.py, sign.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from miniworld_tpu_torch.envs.base import Ctx, EnvSpec, action_from_components
from miniworld_tpu_torch.ops import place as place_ops, rng as rng_ops
from miniworld_tpu_torch.params import DEFAULT_PARAMS
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

    def host_reset(self, env, rng):
        return {"num_picked_up": 0}

    def host_transition(self, env, action, reward, termination):
        # pickupobjects.py:94-101
        if env.carrying is not None:
            env.carrying.alive = False
            env.carrying = None
            env.task["num_picked_up"] += 1
            reward += 1.0
            if env.task["num_picked_up"] == self.num_objs:
                termination = True
        return reward, termination


@dataclass
class PutNext(EnvSpec):
    """Put the red box next to the yellow box (envs/putnext.py:49-80):
    six boxes of sizes 0.6-0.85, the raw 6-D action space."""

    name: str = "PutNext"
    gym_id: str = "MiniWorld-PutNext-v0"
    max_episode_steps: int = 250
    size: float = 12
    red_slot: int = 4  # COLOR_NAMES order: blue, green, grey, purple, red, yellow
    yellow_slot: int = 5

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        world.add_rect_room(min_x=0, max_x=self.size, min_z=0, max_z=self.size)
        for color in COLOR_NAMES:
            if rng is not None:
                s = float(rng.uniform(0.6, 0.85))
                world.place(world.proto_id("box", color, s))
            else:
                world.place(world.proto_id("box", color, 1.0), size_lo=0.6, size_hi=0.85)
        world.place_agent()

    def transition(self, ctx: Ctx):
        # putnext.py:72-80: nothing carried and the red box near the yellow
        s = ctx.state
        done = (s.carrying < 0) & self.near(s, self.red_slot, self.yellow_slot)
        reward = torch.where(done, self.reward(s), torch.zeros_like(s.dir))
        return reward, done, s

    def host_transition(self, env, action, reward, termination):
        # putnext.py:72-80
        red = env.entities[self.red_slot]
        yellow = env.entities[self.yellow_slot]
        if env.carrying is None and env.near(red, yellow):
            reward += env._reward()
            termination = True
        return reward, termination


@dataclass
class CollectHealth(EnvSpec):
    """Slime room; health drains 2 a step, medkits restore it
    (envs/collecthealth.py:49-102): 18 medkit meshes, the raw 6-D
    actions.

    Deviation note (the JAX package's): the reference's respawn trigger
    compares the raw action to ``Actions.pickup`` (collecthealth.py:83),
    which a 6-D action vector never equals; the JAX package implements
    the intent, and so does the port: pickup pressed while holding a kit
    re-places the kit and restores health.
    """

    name: str = "CollectHealth"
    gym_id: str = "MiniWorld-CollectHealth-v0"
    max_episode_steps: int = 1000
    size: float = 16
    num_kits: int = 18

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        world.add_rect_room(
            min_x=0, max_x=self.size, min_z=0, max_z=self.size,
            wall_tex="cinder_blocks", floor_tex="slime",
        )
        kit = world.proto_id("mesh", "medkit", 0.40, False)
        for _ in range(self.num_kits):
            world.place(kit)
        world.place_agent()

    def init_task(self):
        return {"health": np.int32(100)}

    def transition(self, ctx: Ctx):
        """Health -2; pickup (action[4] > 0.5) while carrying a kit puts
        the kit back at a fresh position (``place_one`` against the other
        live kits and the agent, every env each step, the kernel on the
        card) and health back to 100; reward 2 alive, -100 at death."""
        s, bank = ctx.state, ctx.bank
        n, num_ents = s.ent_radius.shape
        dev = s.pos.device
        rows = torch.arange(n, device=dev)
        respawn = (ctx.action[:, 4] > 0.5) & (s.carrying >= 0)
        c = torch.clamp(s.carrying, min=0).long()

        key, sub = rng_ops.split(s.rng, 2).unbind(1)
        ent_xz = torch.cat([s.ent_pos[:, :, [0, 2]], s.pos[:, None, [0, 2]]], dim=1)
        ent_r = torch.cat([s.ent_radius, torch.full((n, 1), self.agent_radius, device=dev)], 1)
        others = s.ent_alive & (torch.arange(num_ents, device=dev)[None, :] != c[:, None])
        mask = torch.cat([others, torch.ones((n, 1), dtype=torch.bool, device=dev)], dim=1)
        lid = s.layout_id.long()
        row = torch.clamp(c, max=bank.rule_room.shape[1] - 2)  # min(c, E - 1)
        rule = [getattr(bank, name)[lid, row, 0] for name in place_ops.RULE_FIELDS]
        place = place_ops.place_one if ctx.use_kernels else place_ops.place_one_plain
        new_pos, new_dir = place(rng_ops.cheap_seed(sub), bank, s.layout_id, *rule,
                                 s.ent_radius[rows, c], ent_xz, ent_r, mask)
        moved = respawn[:, None] & (torch.arange(num_ents, device=dev)[None, :] == c[:, None])
        ent_pos = torch.where(moved[:, :, None], new_pos[:, None, :], s.ent_pos)
        ent_dir = torch.where(moved, new_dir[:, None], s.ent_dir)

        health = torch.where(respawn, torch.full_like(s.task["health"], 100),
                             s.task["health"] - 2)
        alive = health > 0
        reward = torch.where(alive, torch.full_like(s.dir, 2.0), torch.full_like(s.dir, -100.0))
        new_state = s.replace(
            rng=key, ent_pos=ent_pos, ent_dir=ent_dir,
            carrying=torch.where(respawn, torch.full_like(s.carrying, -1), s.carrying),
            task={"health": health},
        )
        return reward, ~alive, new_state

    def info(self, ctx: Ctx):
        return {"health": ctx.state.task["health"]}

    def host_reset(self, env, rng):
        return {"health": 100}

    def host_transition(self, env, action, reward, termination):
        # collecthealth.py:77-102, with the JAX package's deviation: the
        # kit is taken by the pickup component of the 6-D action
        env.task["health"] -= 2
        pickup_pressed = (
            np.asarray(action).ndim > 0 and float(np.asarray(action)[4]) > 0.5
        )
        if pickup_pressed and env.carrying is not None:
            kit = env.carrying
            env.carrying = None
            # re-placed like the reference's place_entity (consumes
            # np_random; collision with the entities and the agent)
            rng = env.np_random
            rooms = env.world.rooms
            probs = env.world._room_probs
            while True:
                r = rooms[int(rng.choice(len(rooms), p=probs))]
                pos = rng.uniform(
                    low=[r.min_x - kit.radius, 0, r.min_z - kit.radius],
                    high=[r.max_x + kit.radius, 0, r.max_z + kit.radius],
                )
                if not r.point_inside(pos):
                    continue
                if env.intersect(kit, pos, kit.radius):
                    continue
                kit.pos = pos
                kit.dir = float(rng.uniform(-math.pi, math.pi))
                break
            env.task["health"] = 100
        if env.task["health"] > 0:
            reward += 2.0
        else:
            reward -= 100.0
            termination = True
        return reward, termination

    def host_info(self, env):
        return {"health": env.task["health"]}


@dataclass
class Sign(EnvSpec):
    """U-maze with coloured boxes and keys and a coloured-word sign
    (envs/sign.py:23-195).

    The sign's text is drawn per episode, so the layout bank has 3
    entries (BLUE, RED, GREEN) and the layout index is the colour
    index. Observations are dicts {"obs": image, "goal": 0 or 1}.
    """

    name: str = "Sign"
    gym_id: str = "MiniWorld-Sign-v0"
    max_episode_steps: int = 200
    size: float = 10
    goal: int = 0
    num_layouts: int = 3
    dict_obs: bool = True
    # the sign's text must be readable: SDF glyphs need K=64
    fourier_k: int = 64
    end_action_index: int = 3
    discrete_actions: np.ndarray = field(
        default_factory=lambda: np.stack(
            [
                action_from_components(turn=-1.0),
                action_from_components(turn=1.0),
                action_from_components(forward=1.0),
                action_from_components(),  # end the episode (sign.py:101-110)
            ]
        )
    )

    def __post_init__(self):
        # no_random + big turn steps (sign.py:80-82)
        p = DEFAULT_PARAMS.no_random()
        p.set("forward_step", 0.15)
        p.set("turn_step", 45)
        self.params = p

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        if rng is not None:
            color_index = int(rng.integers(0, 3))  # sign.py:117
            self._eager_color_index = color_index  # the adapter's episode colour
        else:
            color_index = layout_idx
        gap_size = 0.25
        sz = self.size
        top_room = world.add_rect_room(min_x=0, max_x=sz, min_z=0, max_z=sz * 0.65)
        left_room = world.add_rect_room(
            min_x=0, max_x=sz * 3 / 5, min_z=sz * 0.65 + gap_size, max_z=sz * 1.3
        )
        right_room = world.add_rect_room(
            min_x=sz * 3 / 5, max_x=sz, min_z=sz * 0.65 + gap_size, max_z=sz * 1.3
        )
        world.connect_rooms(top_room, left_room, min_x=0, max_x=sz * 3 / 5)
        world.connect_rooms(left_room, right_room, min_z=sz * 0.65 + gap_size, max_z=sz * 1.3)

        # exact placements (sign.py:143-156)
        world.place(world.proto_id("box", "blue"), pos=(1, 0, 1))
        world.place(world.proto_id("box", "red"), pos=(9, 0, 1))
        world.place(world.proto_id("box", "green"), pos=(9, 0, 5))
        world.place(world.proto_id("mesh", "key_blue", 0.6, False), pos=(5, 0, 1))
        world.place(world.proto_id("mesh", "key_red", 0.6, False), pos=(1, 0, 5))
        world.place(world.proto_id("mesh", "key_green", 0.6, False), pos=(1, 0, 9))

        text = ["BLUE", "RED", "GREEN"][color_index]
        world.bake_text_frame(pos=[sz, 1.35, sz + gap_size], direction=math.pi, text=text,
                              height=1)
        world.place_agent(room=top_room)

    # slots: 0-2 boxes (blue, red, green), 3-5 keys (blue, red, green)
    def transition(self, ctx: Ctx):
        s = ctx.state
        color_index = s.layout_id  # the bank entry is the sign's colour
        touched = torch.zeros_like(s.step_count, dtype=torch.bool)
        for obj_index in range(2):
            for ci in range(3):
                touched = touched | (self.near_agent(s, obj_index * 3 + ci)
                                     & (color_index == ci))
        term = (ctx.action_idx == self.end_action_index) | touched
        reward = touched.to(torch.float32)
        return reward, term, s

    def host_reset(self, env, rng):
        # build() kept the episode's sign colour (sign.py:117)
        return {"color_index": self._eager_color_index}

    def host_transition(self, env, action, reward, termination):
        # sign.py:170-182
        end_requested = np.isscalar(action) and int(action) == self.end_action_index
        if end_requested:
            termination = True
        color_index = env.task["color_index"]
        for obj_index in range(2):
            for ci in range(3):
                if env.near(env.entities[obj_index * 3 + ci]) and ci == color_index:
                    termination = True
                    reward = 1.0
        return reward, termination

"""Navigation specs ported so far: go-to-goal tasks over static geometry.

Counterpart of ``miniworld_tpu/envs/nav.py``: Hallway, the OneRoom
family, FourRooms, the TMaze and YMaze families, the Maze family,
WallGap, NavigateWallGap, Sidewalk, GreenKey, ThreeRooms and
RoomObjects (reference envs/hallway.py, oneroom.py, fourrooms.py,
tmaze.py, ymaze.py, maze.py, wallgap.py, navigatewallgap.py,
sidewalk.py, greenkey.py, threerooms.py, roomobjects.py). The other navigation envs join with
their slices (ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from miniworld_tpu_torch.envs.base import (
    DIR_QUARTER,
    Ctx,
    EnvSpec,
    GoToEnvSpec,
    default_discrete_actions,
)
from miniworld_tpu_torch.params import DEFAULT_PARAMS
from miniworld_tpu_torch.scene.entities import COLOR_NAMES


def _fast_params():
    """no_random + big steps (oneroom.py:80-83, maze.py:176-178)."""
    p = DEFAULT_PARAMS.no_random()
    p.set("forward_step", 0.7)
    p.set("turn_step", 45)
    return p


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


@dataclass
class OneRoom(GoToEnvSpec):
    """Red box in one square room (envs/oneroom.py:46-72)."""

    name: str = "OneRoom"
    gym_id: str = "MiniWorld-OneRoom-v0"
    max_episode_steps: int = 1800
    discrete_actions: np.ndarray = field(default_factory=default_discrete_actions)
    size: float = 10

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        world.add_rect_room(min_x=0, max_x=self.size, min_z=0, max_z=self.size)
        world.place(world.proto_id("box", "red"))
        world.place_agent()


@dataclass
class OneRoomS6(OneRoom):
    name: str = "OneRoomS6"
    gym_id: str = "MiniWorld-OneRoomS6-v0"
    size: float = 6
    max_episode_steps: int = 100


@dataclass
class OneRoomS6Fast(OneRoomS6):
    name: str = "OneRoomS6Fast"
    gym_id: str = "MiniWorld-OneRoomS6Fast-v0"
    max_episode_steps: int = 50

    def __post_init__(self):
        self.params = _fast_params()


@dataclass
class FourRooms(GoToEnvSpec):
    """Four connected rooms, red box (envs/fourrooms.py:46-73)."""

    name: str = "FourRooms"
    gym_id: str = "MiniWorld-FourRooms-v0"
    max_episode_steps: int = 250
    discrete_actions: np.ndarray = field(default_factory=default_discrete_actions)

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        room0 = world.add_rect_room(min_x=-7, max_x=-1, min_z=1, max_z=7)
        room1 = world.add_rect_room(min_x=1, max_x=7, min_z=1, max_z=7)
        room2 = world.add_rect_room(min_x=1, max_x=7, min_z=-7, max_z=-1)
        room3 = world.add_rect_room(min_x=-7, max_x=-1, min_z=-7, max_z=-1)
        world.connect_rooms(room0, room1, min_z=3, max_z=5, max_y=2.2)
        world.connect_rooms(room1, room2, min_x=3, max_x=5, max_y=2.2)
        world.connect_rooms(room2, room3, min_z=-5, max_z=-3, max_y=2.2)
        world.connect_rooms(room3, room0, min_x=-5, max_x=-3, max_y=2.2)
        world.place(world.proto_id("box", "red"))
        world.place_agent()


@dataclass
class TMaze(GoToEnvSpec):
    """T-junction maze, goal in one arm (envs/tmaze.py:45-91)."""

    name: str = "TMaze"
    gym_id: str = "MiniWorld-TMaze-v0"
    max_episode_steps: int = 280
    discrete_actions: np.ndarray = field(default_factory=default_discrete_actions)
    goal_pos: tuple | None = None

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        room1 = world.add_rect_room(min_x=-1, max_x=8, min_z=-2, max_z=2)
        room2 = world.add_rect_room(min_x=8, max_x=12, min_z=-8, max_z=8)
        world.connect_rooms(room1, room2, min_z=-2, max_z=2)

        box = world.proto_id("box", "red")
        if self.goal_pos is not None:
            gp = self.goal_pos
            world.place(
                box, min_x=gp[0], max_x=gp[0], min_z=gp[2], max_z=gp[2]
            )
        elif rng is not None:
            # Reference consumption order: integers(0,2) then placement
            # (tmaze.py:72-75).
            if rng.integers(0, 2) == 0:
                world.place(box, room=room2, max_z=room2.min_z + 2)
            else:
                world.place(box, room=room2, min_z=room2.max_z - 2)
        else:
            world.place(
                box,
                rules=[
                    world._make_rule(room=room2, max_z=room2.min_z + 2),
                    world._make_rule(room=room2, min_z=room2.max_z - 2),
                ],
            )
        if rng is not None:
            d = float(rng.uniform(-math.pi / 4, math.pi / 4))
            world.place_agent(dir=d, room=room1)
        else:
            world.place_agent(dir_range=DIR_QUARTER, room=room1)

    def info(self, ctx: Ctx):
        # info["goal_pos"] every step (tmaze.py:89)
        return {"goal_pos": ctx.state.ent_pos[:, self.goal_slot]}

    def host_info(self, env):
        return {"goal_pos": env.entities[self.goal_slot].pos.copy()}


@dataclass
class TMazeLeft(TMaze):
    name: str = "TMazeLeft"
    gym_id: str = "MiniWorld-TMazeLeft-v0"
    goal_pos: tuple = (10, 0, -6)


@dataclass
class TMazeRight(TMaze):
    name: str = "TMazeRight"
    gym_id: str = "MiniWorld-TMazeRight-v0"
    goal_pos: tuple = (10, 0, 6)


def _ymaze_outlines():
    """Main/left/right arm outlines (envs/ymaze.py:56-88)."""
    main_outline = np.array(
        [[-9.15, 0, -2], [-9.15, 0, +2], [-1.15, 0, +2], [-1.15, 0, -2]]
    )
    hub = np.array([[-1.15, -2], [-1.15, +2], [2.31, 0]])

    def rot(angle_deg):
        # numpy version of the reference's gen_rot_matrix row product
        axis = np.array([0.0, 1.0, 0.0])
        a = math.cos(angle_deg * math.pi / 360)
        b, c, d = -axis * math.sin(angle_deg * math.pi / 360)
        return np.array(
            [
                [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
                [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
            ]
        )

    left = main_outline @ rot(-120)
    right = main_outline @ rot(+120)
    return main_outline, hub, left, right


@dataclass
class YMaze(GoToEnvSpec):
    """Y-shaped maze with a triangular hub (envs/ymaze.py:47-127)."""

    name: str = "YMaze"
    gym_id: str = "MiniWorld-YMaze-v0"
    max_episode_steps: int = 280
    discrete_actions: np.ndarray = field(default_factory=default_discrete_actions)
    goal_pos: tuple | None = None

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        main_outline, hub, left, right = _ymaze_outlines()
        main_arm = world.add_room(outline=np.delete(main_outline, 1, 1))
        hub_room = world.add_room(outline=hub)
        left_arm = world.add_room(outline=np.delete(left, 1, 1))
        right_arm = world.add_room(outline=np.delete(right, 1, 1))

        world.connect_rooms(main_arm, hub_room, min_z=-2, max_z=2)
        world.connect_rooms(left_arm, hub_room, min_z=-1.995, max_z=0)
        world.connect_rooms(right_arm, hub_room, min_z=0, max_z=1.995)

        box = world.proto_id("box", "red")
        if self.goal_pos is not None:
            gp = self.goal_pos
            world.place(box, min_x=gp[0], max_x=gp[0], min_z=gp[2], max_z=gp[2])
        elif rng is not None:
            if rng.integers(0, 2) == 0:
                world.place(box, room=left_arm, max_z=left_arm.min_z + 2.5)
            else:
                world.place(box, room=right_arm, min_z=right_arm.max_z - 2.5)
        else:
            world.place(
                box,
                rules=[
                    world._make_rule(room=left_arm, max_z=left_arm.min_z + 2.5),
                    world._make_rule(room=right_arm, min_z=right_arm.max_z - 2.5),
                ],
            )
        if rng is not None:
            d = float(rng.uniform(-math.pi / 4, math.pi / 4))
            world.place_agent(dir=d, room=main_arm)
        else:
            world.place_agent(dir_range=DIR_QUARTER, room=main_arm)

    def info(self, ctx: Ctx):
        # info["goal_pos"] every step (ymaze.py:125)
        return {"goal_pos": ctx.state.ent_pos[:, self.goal_slot]}

    def host_info(self, env):
        return {"goal_pos": env.entities[self.goal_slot].pos.copy()}


@dataclass
class YMazeLeft(YMaze):
    name: str = "YMazeLeft"
    gym_id: str = "MiniWorld-YMazeLeft-v0"
    goal_pos: tuple = (3.9, 0, -7.0)


@dataclass
class YMazeRight(YMaze):
    name: str = "YMazeRight"
    gym_id: str = "MiniWorld-YMazeRight-v0"
    goal_pos: tuple = (3.9, 0, 7.0)


@dataclass
class Maze(GoToEnvSpec):
    """Procedural recursive-backtracking maze (envs/maze.py:48-162).

    By default (``procgen_default``) every reset generates a fresh maze
    on the device (ops/mazegen.py) over the super bank of
    scene/supermaze.py. With ``procgen=False`` each env draws one of
    ``num_layouts`` mazes compiled into a bank; ``build`` then makes
    layout ``layout_idx`` from its ``layout_rng`` with the reference's
    rng consumption (choice-based neighbour shuffle, maze.py:113-121).
    """

    name: str = "Maze"
    gym_id: str = "MiniWorld-Maze-v0"
    discrete_actions: np.ndarray = field(default_factory=default_discrete_actions)
    num_rows: int = 8
    num_cols: int = 8
    room_size: float = 3
    gap_size: float = 0.25
    num_layouts: int = 64
    max_episode_steps: int = 0  # derived below
    procgen_default: bool = True

    def __post_init__(self):
        if not self.max_episode_steps:
            self.max_episode_steps = self.num_rows * self.num_cols * 24

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        if rng is None:
            rng = layout_rng if layout_rng is not None else np.random.default_rng(0)
        rows = []
        for j in range(self.num_rows):
            row = []
            for i in range(self.num_cols):
                min_x = i * (self.room_size + self.gap_size)
                max_x = min_x + self.room_size
                min_z = j * (self.room_size + self.gap_size)
                max_z = min_z + self.room_size
                row.append(
                    world.add_rect_room(
                        min_x=min_x, max_x=max_x, min_z=min_z, max_z=max_z,
                        wall_tex="brick_wall",
                    )
                )
            rows.append(row)

        visited = set()

        def visit(i, j):
            room = rows[j][i]
            visited.add(id(room))
            orders = [(0, 1), (0, -1), (-1, 0), (1, 0)]
            neighbors = []
            while len(neighbors) < 4:
                elem = orders[rng.choice(len(orders))]
                orders.remove(elem)
                neighbors.append(elem)
            for dj, di in neighbors:
                ni, nj = i + di, j + dj
                if nj < 0 or nj >= self.num_rows or ni < 0 or ni >= self.num_cols:
                    continue
                neighbor = rows[nj][ni]
                if id(neighbor) in visited:
                    continue
                if di == 0:
                    world.connect_rooms(room, neighbor, min_x=room.min_x, max_x=room.max_x)
                elif dj == 0:
                    world.connect_rooms(room, neighbor, min_z=room.min_z, max_z=room.max_z)
                visit(ni, nj)

        import sys

        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, self.num_rows * self.num_cols * 8 + 100))
        try:
            visit(0, 0)
        finally:
            sys.setrecursionlimit(old_limit)

        world.place(world.proto_id("box", "red"))
        world.place_agent()


@dataclass
class MazeS2(Maze):
    name: str = "MazeS2"
    gym_id: str = "MiniWorld-MazeS2-v0"
    num_rows: int = 2
    num_cols: int = 2


@dataclass
class MazeS3(Maze):
    name: str = "MazeS3"
    gym_id: str = "MiniWorld-MazeS3-v0"
    num_rows: int = 3
    num_cols: int = 3


@dataclass
class MazeS3Fast(MazeS3):
    name: str = "MazeS3Fast"
    gym_id: str = "MiniWorld-MazeS3Fast-v0"
    max_episode_steps: int = 300

    def __post_init__(self):
        self.params = _fast_params()


@dataclass
class WallGap(GoToEnvSpec):
    """Two open-air rooms with a gap (envs/wallgap.py:42-89)."""

    name: str = "WallGap"
    gym_id: str = "MiniWorld-WallGap-v0"
    max_episode_steps: int = 2000
    discrete_actions: np.ndarray = field(default_factory=default_discrete_actions)

    def _build_rooms(self, world):
        room0 = world.add_rect_room(
            min_x=-7, max_x=7, min_z=0.5, max_z=8,
            wall_tex="brick_wall", floor_tex="asphalt", no_ceiling=True,
        )
        room1 = world.add_rect_room(
            min_x=-7, max_x=7, min_z=-8, max_z=-0.5,
            wall_tex="brick_wall", floor_tex="asphalt", no_ceiling=True,
        )
        world.connect_rooms(room0, room1, min_x=-1.5, max_x=1.5)
        return room0, room1

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        room0, room1 = self._build_rooms(world)
        world.place(world.proto_id("box", "red"), room=room1)
        # Decorative building (wallgap.py:74-78)
        world.bake_mesh("building", 30, pos=np.array([30.0, 0, 30]), direction=-math.pi)
        world.place_agent(room=room0)


@dataclass
class NavigateWallGap(WallGap):
    """Reward for crossing into the bottom room
    (envs/navigatewallgap.py:48-100)."""

    name: str = "NavigateWallGap"
    gym_id: str = "MiniWorld-NavigateWallGap-v0"
    bottom_room_bbox: tuple = (-7.0, 7.0, -8.0, -0.5)

    def init_task(self):
        return {"passed_gap": False}

    def transition(self, ctx: Ctx):
        x, z = ctx.state.pos[:, 0], ctx.state.pos[:, 2]
        bx0, bx1, bz0, bz1 = self.bottom_room_bbox
        in_bottom = (x >= bx0) & (x <= bx1) & (z >= bz0) & (z <= bz1)
        fire = ~ctx.state.task["passed_gap"] & in_bottom
        reward = fire.to(torch.float32)
        new_task = {"passed_gap": ctx.state.task["passed_gap"] | fire}
        return reward, fire, ctx.state.replace(task=new_task)

    def host_reset(self, env, rng):
        return {"passed_gap": False}

    def host_transition(self, env, action, reward, termination):
        x, z = env.agent_pos[0], env.agent_pos[2]
        bx0, bx1, bz0, bz1 = self.bottom_room_bbox
        in_bottom = bx0 <= x <= bx1 and bz0 <= z <= bz1
        if in_bottom and not env.task["passed_gap"]:
            env.task["passed_gap"] = True
            reward += 1.0
            termination = True
        return reward, termination


@dataclass
class Sidewalk(GoToEnvSpec):
    """Sidewalk with cones; entering the street ends the episode
    (envs/sidewalk.py:50-107)."""

    name: str = "Sidewalk"
    gym_id: str = "MiniWorld-Sidewalk-v0"
    max_episode_steps: int = 150
    discrete_actions: np.ndarray = field(default_factory=default_discrete_actions)
    street_room_idx: int = 1
    goal_slot: int = 0  # set in build

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        sidewalk = world.add_rect_room(
            min_x=-3, max_x=0, min_z=0, max_z=12,
            wall_tex="brick_wall", floor_tex="concrete_tiles", no_ceiling=True,
        )
        world.add_rect_room(
            min_x=0, max_x=6, min_z=-80, max_z=80,
            floor_tex="asphalt", no_ceiling=True,
        )
        world.connect_rooms(sidewalk, world.rooms[1], min_z=0, max_z=12)

        world.bake_mesh("building", 30, pos=np.array([30.0, 0, 30]), direction=-math.pi)
        for i in range(1, int(sidewalk.max_z) // 2):
            # no dir: one rng uniform per cone, like the reference's
            # place_entity(..., pos=...) (sidewalk.py:82-84)
            world.bake_mesh("cone", 0.75, pos=np.array([1.0, 0, 2 * i]))
        self.goal_slot = world.place(
            world.proto_id("box", "red"),
            room=sidewalk, min_z=sidewalk.max_z - 2, max_z=sidewalk.max_z,
        )
        world.place_agent(room=sidewalk, min_z=0, max_z=1.5)

    def transition(self, ctx: Ctx):
        in_street = self.agent_in_room(ctx.bank, ctx.state, self.street_room_idx)
        reached = self.near_agent(ctx.state, self.goal_slot)
        # Street check runs first; reaching the box overrides its reward
        # (sidewalk.py:95-106).
        reward = torch.where(reached, self.reward(ctx.state), torch.zeros_like(ctx.state.dir))
        return reward, in_street | reached, ctx.state

    def host_transition(self, env, action, reward, termination):
        if env.world.rooms[self.street_room_idx].point_inside(env.agent_pos):
            termination = True
        if env.near(env.entities[self.goal_slot]):
            reward += env._reward()
            termination = True
        return reward, termination


@dataclass
class GreenKey(GoToEnvSpec):
    """Go to the green key among distractors (envs/greenkey.py:41-66)."""

    name: str = "GreenKey"
    gym_id: str = "MiniWorld-GreenKey-v0"
    max_episode_steps: int = 2000
    discrete_actions: np.ndarray = field(default_factory=default_discrete_actions)
    size: float = 8

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        world.add_rect_room(min_x=0, max_x=self.size, min_z=0, max_z=self.size)
        world.place(world.proto_id("key", "green"))
        world.place(world.proto_id("ball", "red"))
        world.place(world.proto_id("box", "blue"))
        world.place_agent()


@dataclass
class ThreeRooms(EnvSpec):
    """Exploration env: three rooms, assorted objects, no reward
    (envs/threerooms.py:41-80)."""

    name: str = "ThreeRooms"
    gym_id: str = "MiniWorld-ThreeRooms-v0"
    max_episode_steps: int = 400
    discrete_actions: np.ndarray = field(default_factory=default_discrete_actions)

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        room0 = world.add_rect_room(min_x=-7, max_x=7, min_z=0.5, max_z=7)
        room1 = world.add_rect_room(min_x=-7, max_x=-1, min_z=-7, max_z=-0.5)
        room2 = world.add_rect_room(min_x=1, max_x=7, min_z=-7, max_z=-0.5)
        world.connect_rooms(room0, room1, min_x=-5.25, max_x=-2.75)
        world.connect_rooms(room0, room2, min_x=2.75, max_x=5.25)

        world.place(world.proto_id("box", "red"))
        world.place(world.proto_id("box", "green", 0.6))
        world.bake_image_frame(pos=[0, 1.35, 7], direction=math.pi / 2, tex_name="logo_mila",
                               width=1.8)
        world.place(world.proto_id("mesh", "duckie", 0.25, False))
        world.place(world.proto_id("key", "blue"))
        world.place(world.proto_id("ball", "green"))
        world.place_agent()


@dataclass
class RoomObjects(EnvSpec):
    """Observation-only room with one box, ball and key of random colours
    (envs/roomobjects.py:48-82); the raw 6-D action space, no reward."""

    name: str = "RoomObjects"
    gym_id: str = "MiniWorld-RoomObjects-v0"
    max_episode_steps: int = 10**9  # the reference's math.inf
    size: float = 10
    # roomobjects.py:67 sets agent.radius = 1.5 every reset: the whole
    # episode (collision, the pickup probe) runs at 1.5, not just placement
    agent_radius: float = 1.5
    # at radius 1.5 a try passes about 1 time in 5; 48 tries keep a
    # budget's exhaustion (the clamped fallback) rare
    place_budget: int = 48

    def build(self, world, rng, layout_rng=None, layout_idx=0):
        world.add_rect_room(
            min_x=0, max_x=self.size, min_z=0, max_z=self.size,
            wall_tex="brick_wall", floor_tex="asphalt", no_ceiling=True,
        )
        world.agent_radius = 1.5  # roomobjects.py:67
        if rng is not None:
            # each colour draw interleaves with its placement's rejection
            # sampling (roomobjects.py:70-76)
            for kind, scale in (("box", 0.9), ("ball", 0.9), ("key", None)):
                c = COLOR_NAMES[int(rng.choice(len(COLOR_NAMES)))]
                world.place(world.proto_id(kind, c) if scale is None
                            else world.proto_id(kind, c, scale))
        else:
            world.place([world.proto_id("box", c, 0.9) for c in COLOR_NAMES])
            world.place([world.proto_id("ball", c, 0.9) for c in COLOR_NAMES])
            world.place([world.proto_id("key", c) for c in COLOR_NAMES])
        world.place_agent()

"""Navigation specs ported so far: go-to-goal tasks over static geometry.

Counterpart of ``miniworld_tpu/envs/nav.py``: Hallway, FourRooms, the
TMaze family and the Maze family (reference envs/hallway.py,
fourrooms.py, tmaze.py, maze.py). The other navigation envs join with
their slices (ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from miniworld_tpu_torch.envs.base import (
    DIR_QUARTER,
    Ctx,
    GoToEnvSpec,
    default_discrete_actions,
)
from miniworld_tpu_torch.params import DEFAULT_PARAMS


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

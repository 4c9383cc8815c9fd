"""Env registry of the port: the ids ported so far.

The JAX package registers all 27 reference ids (miniworld_tpu/envs);
the port adds them slice by slice (ROADMAP.md), and ``make_spec``
names the ported set when asked for any other.
"""

from __future__ import annotations

from miniworld_tpu_torch.envs.base import EnvSpec
from miniworld_tpu_torch.envs.interact import PickupObjects, PutNext, Sign
from miniworld_tpu_torch.envs.nav import (
    FourRooms, GreenKey, Hallway, Maze, MazeS2, MazeS3, MazeS3Fast, NavigateWallGap, OneRoom,
    OneRoomS6, OneRoomS6Fast, RoomObjects, Sidewalk, ThreeRooms, TMaze, TMazeLeft, TMazeRight,
    WallGap, YMaze, YMazeLeft, YMazeRight,
)

SPEC_CLASSES = [Hallway, OneRoom, OneRoomS6, OneRoomS6Fast, FourRooms, TMaze, TMazeLeft,
                TMazeRight, YMaze, YMazeLeft, YMazeRight, Maze, MazeS2, MazeS3, MazeS3Fast,
                WallGap, NavigateWallGap, Sidewalk, GreenKey, ThreeRooms, RoomObjects,
                PickupObjects, PutNext, Sign]

_REGISTRY = {}
for cls in SPEC_CLASSES:
    _inst = cls()
    _REGISTRY[_inst.gym_id] = cls
    _REGISTRY[_inst.name] = cls

ENV_IDS = sorted({cls().gym_id for cls in SPEC_CLASSES})


def make_spec(name: str, **kwargs) -> EnvSpec:
    """Instantiate a spec by gym id or short name."""
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"env {name!r} is not ported to miniworld_tpu_torch yet; "
            f"ported: {ENV_IDS} (the JAX package miniworld_tpu has all 27)"
        )
    return _REGISTRY[name](**kwargs)


__all__ = ["ENV_IDS", "make_spec", "EnvSpec", "FourRooms", "GreenKey", "Hallway", "Maze",
           "MazeS2", "MazeS3", "MazeS3Fast", "NavigateWallGap", "OneRoom", "OneRoomS6",
           "OneRoomS6Fast", "PickupObjects", "PutNext", "RoomObjects", "Sidewalk", "Sign",
           "TMaze", "TMazeLeft", "TMazeRight", "ThreeRooms", "WallGap", "YMaze", "YMazeLeft",
           "YMazeRight"]

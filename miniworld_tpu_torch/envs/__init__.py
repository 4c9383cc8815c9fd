"""Env registry of the port: the 27 reference ids of the JAX package
(miniworld_tpu/envs/__init__.py)."""

from __future__ import annotations

from miniworld_tpu_torch.envs.base import EnvSpec
from miniworld_tpu_torch.envs.cameracontrol import CameraControl, CameraControlClick
from miniworld_tpu_torch.envs.interact import CollectHealth, PickupObjects, PutNext, Sign
from miniworld_tpu_torch.envs.nav import (
    FourRooms, GreenKey, Hallway, Maze, MazeS2, MazeS3, MazeS3Fast, NavigateWallGap, OneRoom,
    OneRoomS6, OneRoomS6Fast, RoomObjects, Sidewalk, ThreeRooms, TMaze, TMazeLeft, TMazeRight,
    WallGap, YMaze, YMazeLeft, YMazeRight,
)

SPEC_CLASSES = [CameraControl, CameraControlClick, CollectHealth, FourRooms, GreenKey, Hallway,
                Maze, MazeS2, MazeS3, MazeS3Fast, NavigateWallGap, OneRoom, OneRoomS6,
                OneRoomS6Fast, PickupObjects, PutNext, RoomObjects, Sidewalk, Sign, ThreeRooms,
                TMaze, TMazeLeft, TMazeRight, WallGap, YMaze, YMazeLeft, YMazeRight]

_REGISTRY = {}
for cls in SPEC_CLASSES:
    _inst = cls()
    _REGISTRY[_inst.gym_id] = cls
    _REGISTRY[_inst.name] = cls

ENV_IDS = sorted({cls().gym_id for cls in SPEC_CLASSES})


def make_spec(name: str, **kwargs) -> EnvSpec:
    """Instantiate a spec by gym id or short name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown env {name!r}; known: {ENV_IDS}")
    return _REGISTRY[name](**kwargs)


__all__ = ["ENV_IDS", "make_spec", "EnvSpec"] + [c.__name__ for c in SPEC_CLASSES]

"""Nearest-mode renders of the port against the JAX package's, per id:
reset and 3 steps at B=2, 32x24 (``reset_and_steps``: states within
FLOAT_ATOL, images by ``assert_images_match``) for Hallway,
PickupObjects (mesh rows with local slots), MazeS3 procgen and the 8x8
procgen Maze, whose 528 layout-local slot ids take the float32
attribute carry. Sidewalk (the multi-chunk scan) and Sign (the 78-row
atlas) are in test_torch_nearest_wide.py: the Tier-1 command
(ROADMAP.md) spreads the suite over its workers file by file
(pytest-xdist ``--dist loadfile``), and the six ids in one file would
take one worker about two minutes (this file's four about 55 s, the
other two about 70 s, on the CPU), above the 1.5 minutes a test file of
the port is kept under."""

import pytest

from _torch_parity import reset_and_steps
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)


@pytest.mark.parametrize("env_id", ["MiniWorld-Hallway-v0", "MiniWorld-PickupObjects-v0",
                                    "MiniWorld-MazeS3-v0", "MiniWorld-Maze-v0"])
def test_reset_and_steps(env_id):
    reset_and_steps(env_id, 2, 32, 24, 3, seed=5, tex_mode="nearest")

"""Nearest-mode renders of the port against the JAX package's for
Sidewalk (3,072 rows in 3 chunks of 1,024 at B=2) and Sign (a 78-row
u8 atlas, mesh rows, dict observations): reset and 3 steps at B=2,
32x24, as test_torch_nearest_ids.py runs the others. They are a file
of their own so that the suite's file-by-file distribution over workers
(``--dist loadfile``) runs them beside those: see that file."""

import pytest

from _torch_parity import reset_and_steps
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)


@pytest.mark.parametrize("env_id", ["MiniWorld-Sidewalk-v0", "MiniWorld-Sign-v0"])
def test_reset_and_steps(env_id):
    reset_and_steps(env_id, 2, 32, 24, 3, seed=5, tex_mode="nearest")

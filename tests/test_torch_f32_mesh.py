"""The float32 attribute carry with mesh rows against the JAX package on
the CPU (tests/test_torch_f32_carry.py's ``check_f32_case``): Sign's glyph
atlas above 256 rows (GAIN and mesh rows), PickupObjects in nearest mode
with its slot ids above 256 (mesh rows in one chunk), ThreeRooms at
tri_chunk=16 likewise (mesh rows seeding a schedule).

Tolerances: rewards and dones exact; states within FLOAT_ATOL (1e-5);
renders under the _torch_parity rules (winner differs on at most 0.1% of
the pixels, depth within rtol 1e-5 and RGB within 2 u8 levels where it
agrees).
"""

import pytest

from test_torch_f32_carry import MESH_CASES, check_f32_case
from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)


@pytest.mark.parametrize("case", MESH_CASES)
def test_f32_mesh_matches_jax(case):
    """check_f32_case on the cases with mesh rows."""
    check_f32_case(case)

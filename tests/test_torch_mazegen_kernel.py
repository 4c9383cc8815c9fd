"""The redesigned mazegen kernel's step on the CPU: ``mazegen_walk``
(tests/_kernel_models.py), which copies the kernel's packed neighbour
entries, visited bitmask and bit walk to the pick-th candidate, makes
the same walls as ``gen_walls_plain`` bit for bit on the grids of the
kernel's visited-mask instances (2x2, 3x3: one word; 8x8: two; 16x16:
eight), and as the JAX package's ``gen_walls`` on the two grids that
tests/test_torch_maze.py does not hold against it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _kernel_models import mazegen_walk
from miniworld_tpu.ops import mazegen as jmazegen
from miniworld_tpu_torch.ops import mazegen, rng as trng

from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)


def _seeds(n, salt):
    return np.random.default_rng(100 + salt).integers(0, 2**32, n, dtype=np.uint64)


@pytest.mark.parametrize("rows,cols", [(2, 2), (3, 3), (8, 8), (16, 16)], ids=str)
def test_walk_matches_plain(rows, cols):
    seeds = torch.from_numpy(_seeds(48, rows).astype(np.int64))
    us = trng.uniforms(seeds, 2, (2 * rows * cols - 1,))
    got = mazegen_walk(us, rows, cols)
    want = mazegen.gen_walls_plain(seeds, rows, cols)
    assert torch.equal(got, want)
    assert all(mazegen.maze_is_spanning_tree(w > 0.5, rows, cols) for w in got.numpy())


@pytest.mark.parametrize("rows,cols", [(2, 2), (16, 16)], ids=str)
def test_walk_matches_jax(rows, cols):
    seeds = _seeds(16, rows)
    want = jax.jit(jax.vmap(lambda s: jmazegen.gen_walls(s, rows, cols)))(
        jnp.asarray(seeds.astype(np.uint32)))
    us = trng.uniforms(torch.from_numpy(seeds.astype(np.int64)), 2, (2 * rows * cols - 1,))
    np.testing.assert_array_equal(mazegen_walk(us, rows, cols).numpy(), np.asarray(want))

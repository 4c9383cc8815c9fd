"""Per-reset maze generation (recursive backtracker), batched over envs.

Counterpart of ``miniworld_tpu/ops/mazegen.py`` (reference:
miniworld/envs/maze.py:100-149): an iterative DFS from cell (0, 0) that,
at the top cell of its stack, picks uniformly among the currently
unvisited neighbours and opens the wall to it. A DFS over N cells does
N-1 pushes and N pops, so it ends in exactly ``2N - 1`` steps.

Wall ids number the ``rows*(cols-1)`` horizontal walls (between (i, j)
and (i, j+1), id i*(cols-1)+j), then the ``(rows-1)*cols`` vertical
walls (between (i, j) and (i+1, j), id H + i*cols + j). A maze opens
exactly ``rows*cols - 1`` walls: a spanning tree of the cell grid.

``gen_walls`` runs the ``mazegen`` kernel (``csrc/mazegen.cu``, one
thread per env) for CUDA tensors and ``gen_walls_plain`` for CPU
tensors. Both draw step i's uniform as the JAX package does,
``uniforms(seed, 2, (2N-1,))[i]`` of ops/rng.py, so a seed gives the
same maze in both packages.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from miniworld_tpu_torch.ops import rng as rng_ops
from miniworld_tpu_torch.render.cuda_build import check, is_cuda, launch, stream

# The kernel keeps the visited set as a register bitmask of up to 8 words
# and the DFS stack in shared memory (csrc/mazegen.cu): grids up to this
# many cells.
MAX_CELLS = 256


def num_walls(rows: int, cols: int) -> int:
    return rows * (cols - 1) + (rows - 1) * cols


def hwall_id(i: int, j: int, cols: int) -> int:
    """Wall between (i, j) and (i, j+1)."""
    return i * (cols - 1) + j


def vwall_id(i: int, j: int, rows: int, cols: int) -> int:
    """Wall between (i, j) and (i+1, j)."""
    return rows * (cols - 1) + i * cols + j


def wall_cells(rows: int, cols: int) -> np.ndarray:
    """(W, 2) i32: the two cell indices each wall separates."""
    out = []
    for i in range(rows):
        for j in range(cols - 1):
            out.append((i * cols + j, i * cols + j + 1))
    for i in range(rows - 1):
        for j in range(cols):
            out.append((i * cols + j, (i + 1) * cols + j))
    return np.asarray(out, dtype=np.int32)


def neighbor_tables(rows: int, cols: int):
    """Static (N, 4) neighbour cell ids and wall ids (-1 = off-grid), in
    the direction order [+x, -x, +z, -z] over which the pick ranks."""
    n = rows * cols
    nbr_cell = np.full((n, 4), -1, dtype=np.int32)
    nbr_wall = np.full((n, 4), -1, dtype=np.int32)
    for i in range(rows):
        for j in range(cols):
            c = i * cols + j
            if j + 1 < cols:
                nbr_cell[c, 0] = c + 1
                nbr_wall[c, 0] = hwall_id(i, j, cols)
            if j - 1 >= 0:
                nbr_cell[c, 1] = c - 1
                nbr_wall[c, 1] = hwall_id(i, j - 1, cols)
            if i + 1 < rows:
                nbr_cell[c, 2] = c + cols
                nbr_wall[c, 2] = vwall_id(i, j, rows, cols)
            if i - 1 >= 0:
                nbr_cell[c, 3] = c - cols
                nbr_wall[c, 3] = vwall_id(i - 1, j, rows, cols)
    return nbr_cell, nbr_wall


@functools.lru_cache(maxsize=16)
def _device_tables(rows: int, cols: int, device: torch.device):
    """(nbr_cell, nbr_wall) as (N, 4) int32 tensors on ``device``,
    built once per grid and device (read only)."""
    return tuple(torch.from_numpy(t).to(device) for t in neighbor_tables(rows, cols))


def gen_walls_plain(seed: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Plain version of the mazegen kernel: one maze per env.

    ``seed`` (B,) u32 subseeds (int64) -> (B, W) f32 in {0, 1}, 1 = wall
    open. Exactly ``2N - 1`` steps, every env advanced together; the
    JAX package's one-hot contracts are indexed reads here.
    """
    n, w = rows * cols, num_walls(rows, cols)
    b = seed.shape[0]
    dev = seed.device
    nbr_cell, nbr_wall = (t.long() for t in _device_tables(rows, cols, dev))
    us = rng_ops.uniforms(seed, 2, (2 * n - 1,))  # (B, 2N-1)
    envs = torch.arange(b, device=dev)
    visited = torch.zeros((b, n), dtype=torch.bool, device=dev)
    visited[:, 0] = True
    stack = torch.zeros((b, n), dtype=torch.int64, device=dev)  # cell 0 at slot 0
    sp = torch.ones(b, dtype=torch.int64, device=dev)
    walls = torch.zeros((b, w), dtype=torch.float32, device=dev)
    for i in range(2 * n - 1):
        done = sp <= 0
        cur = stack[envs, torch.clamp(sp - 1, min=0)]
        nbrs, wids = nbr_cell[cur], nbr_wall[cur]  # (B, 4)
        in_grid = nbrs >= 0
        seen = torch.gather(visited, 1, torch.clamp(nbrs, min=0))
        cand = in_grid & ~seen
        c_i = cand.to(torch.int64)
        k = c_i.sum(dim=1)
        pick = torch.minimum(torch.floor(us[:, i] * k.to(torch.float32)).to(torch.int64),
                             torch.clamp(k - 1, min=0))
        rank = torch.cumsum(c_i, dim=1) - c_i  # candidates before each direction
        choose = cand & (rank == pick[:, None])
        nc = torch.where(choose, nbrs, torch.zeros_like(nbrs)).sum(dim=1)
        wid = torch.where(choose, wids, torch.zeros_like(wids)).sum(dim=1)
        advance = (k > 0) & ~done
        walls[envs, wid] = torch.where(advance, 1.0, walls[envs, wid])
        visited[envs, nc] = visited[envs, nc] | advance
        top = torch.clamp(sp, max=n - 1)  # a full stack has no candidates
        stack[envs, top] = torch.where(advance, nc, stack[envs, top])
        sp = torch.where(done, sp, torch.where(advance, sp + 1, sp - 1))
    return walls


def gen_walls(seed: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The mazegen kernel for CUDA tensors, ``gen_walls_plain`` for CPU
    tensors. Same contract as ``gen_walls_plain``; launches count in
    ``cuda_build.LAUNCHES["mazegen"]``."""
    if not is_cuda(seed):
        return gen_walls_plain(seed, rows, cols)
    n, w = rows * cols, num_walls(rows, cols)
    if n > MAX_CELLS:
        raise ValueError(f"mazegen kernel takes at most {MAX_CELLS} cells, got {rows}x{cols}")
    b = seed.shape[0]
    nbr_cell, nbr_wall = _device_tables(rows, cols, seed.device)
    seeds = seed.to(torch.int32).contiguous()  # the u32 bits
    out = torch.empty((b, w), dtype=torch.float32, device=seed.device)
    launch(
        "mw_mazegen", "mazegen",
        check(seeds, "seed", torch.int32, (b,)),
        check(nbr_cell, "nbr_cell", torch.int32, (n, 4)),
        check(nbr_wall, "nbr_wall", torch.int32, (n, 4)),
        ctypes.c_int(b), ctypes.c_int(n), ctypes.c_int(w),
        check(out, "walls", torch.float32, (b, w)),
        stream(),
    )
    return out


# ---------------------------------------------------------------------------
# Host oracles (numpy), for the tests and the chip run's checks.


def host_gen_walls(rng: np.random.Generator, rows: int, cols: int) -> np.ndarray:
    """Numpy mirror of gen_walls (iterative DFS, uniform among
    currently-unvisited neighbours)."""
    n = rows * cols
    nbr_cell, nbr_wall = neighbor_tables(rows, cols)
    open_w = np.zeros(num_walls(rows, cols), bool)
    visited = np.zeros(n, bool)
    visited[0] = True
    stack = [0]
    while stack:
        c = stack[-1]
        cand = [
            (nbr_cell[c, d], nbr_wall[c, d])
            for d in range(4)
            if nbr_cell[c, d] >= 0 and not visited[nbr_cell[c, d]]
        ]
        if not cand:
            stack.pop()
            continue
        nc, wid = cand[int(rng.integers(len(cand)))]
        open_w[wid] = True
        visited[nc] = True
        stack.append(int(nc))
    return open_w


def maze_is_spanning_tree(open_w: np.ndarray, rows: int, cols: int) -> bool:
    """Connectivity + exact edge-count check (union-find)."""
    n = rows * cols
    if int(np.sum(open_w)) != n - 1:
        return False
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    cells = wall_cells(rows, cols)
    for wid in np.where(open_w)[0]:
        a, b = cells[wid]
        ra, rb = find(int(a)), find(int(b))
        if ra == rb:
            return False  # cycle
        parent[ra] = rb
    return len({find(c) for c in range(n)}) == 1

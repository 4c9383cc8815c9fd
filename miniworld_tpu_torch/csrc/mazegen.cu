// Per-reset maze generation: one recursive-backtracker maze per env,
// one thread per env.
//
// Replaces: miniworld_tpu/ops/mazegen.py:gen_walls, a lax.scan of
// 2N - 1 steps whose every dynamic index is a one-hot contract (XLA-fused
// jnp in the JAX package). The plain PyTorch version is gen_walls_plain
// in miniworld_tpu_torch/ops/mazegen.py; the two agree bit for bit.
//
// Each step looks at the cell on top of the DFS stack, collects its
// unvisited grid neighbours in the order [+x, -x, +z, -z] (the host's
// neighbour tables), and either pushes the k-th of the k candidates,
// k = min(floor(u * k), k - 1) with u the step's uniform, opening the
// wall between, or pops. After 2N - 1 steps the stack is empty (N - 1
// pushes, N pops). Step i's uniform is ops/rng.py's
// uniforms(s, 2, (2N-1,))[i] = hash01(hash_u32(s, 2), i) for the env's
// subseed s.
//
// What bounds it on an H100: neither bytes (4 W bytes out per env, 3.7 MB
// at B = 8192 on an 8x8 grid) nor operations (some 10^8 integer ops) come
// near the card's rates; the 127 steps of an 8x8 maze are a dependent
// chain, so the kernel is latency-bound. What the design buys is one
// launch per reset instead of the plain version's 2N - 1 steps of about
// fifteen small launches each. The visited set is a bitmask and the
// stack a byte array, both in the thread's own registers and local
// memory; the tables are a few hundred bytes that stay in L1.

#include <cuda_runtime.h>

#include "rng.cuh"

#define MAX_CELLS 256
#define MAX_WALLS (2 * MAX_CELLS)

__global__ void mazegen_kernel(
    const unsigned int* __restrict__ seeds,  // (B,) subseeds
    const int* __restrict__ nbr_cell,        // (N, 4), -1 off-grid
    const int* __restrict__ nbr_wall,        // (N, 4)
    int B, int N, int Wn,
    float* __restrict__ walls)               // (B, Wn), 1 = open
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const unsigned int key = hash_u32(seeds[b], 2u);  // uniforms(s, 2, ...)
    unsigned int visited[MAX_CELLS / 32];
    unsigned int open[MAX_WALLS / 32];
    for (int i = 0; i < MAX_CELLS / 32; ++i) visited[i] = 0u;
    for (int i = 0; i < MAX_WALLS / 32; ++i) open[i] = 0u;
    unsigned char stack[MAX_CELLS];
    visited[0] = 1u;
    stack[0] = 0;
    int sp = 1;
    for (int i = 0; i < 2 * N - 1 && sp > 0; ++i) {
        const int cur = stack[sp - 1];
        int cand_cell[4], cand_wall[4];
        int k = 0;
        for (int d = 0; d < 4; ++d) {
            const int nc = nbr_cell[4 * cur + d];
            if (nc >= 0 && !((visited[nc >> 5] >> (nc & 31)) & 1u)) {
                cand_cell[k] = nc;
                cand_wall[k] = nbr_wall[4 * cur + d];
                ++k;
            }
        }
        if (k > 0) {
            const float u = hash01(key, (unsigned int)i);
            const int pick = min((int)floorf(u * (float)k), k - 1);
            const int nc = cand_cell[pick];
            const int wid = cand_wall[pick];
            open[wid >> 5] |= 1u << (wid & 31);
            visited[nc >> 5] |= 1u << (nc & 31);
            stack[sp] = (unsigned char)nc;
            ++sp;
        } else {
            --sp;
        }
    }
    float* out = walls + (size_t)b * Wn;
    for (int w = 0; w < Wn; ++w) out[w] = ((open[w >> 5] >> (w & 31)) & 1u) ? 1.0f : 0.0f;
}

extern "C" int mw_mazegen(
    const unsigned int* seeds, const int* nbr_cell, const int* nbr_wall,
    int B, int N, int Wn, float* walls, cudaStream_t stream)
{
    if (N < 1 || N > MAX_CELLS || Wn > MAX_WALLS) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const int threads = 128;
    mazegen_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
        seeds, nbr_cell, nbr_wall, B, N, Wn, walls);
    return (int)cudaGetLastError();
}

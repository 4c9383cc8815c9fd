// Per-reset maze generation: one recursive-backtracker maze per env,
// one lane per env's walk.
//
// Replaces: miniworld_tpu/ops/mazegen.py:gen_walls, a lax.scan of
// 2N - 1 steps whose every dynamic index is a one-hot contract (XLA-fused
// jnp in the JAX package). The plain PyTorch version is gen_walls_plain
// in miniworld_tpu_torch/ops/mazegen.py; the two agree bit for bit.
//
// Each step looks at the cell on top of the DFS stack, collects its
// unvisited grid neighbours in the order [+x, -x, +z, -z] (the host's
// neighbour tables), and either pushes candidate min(floor(u * k), k - 1)
// (from 0) of its k candidates, u the step's uniform, opening the wall
// between, or pops. After 2N - 1 steps the stack is empty (N - 1
// pushes, N pops). Step i's uniform is ops/rng.py's
// uniforms(s, 2, (2N-1,))[i] = hash01(hash_u32(s, 2), i) for the env's
// subseed s.
//
// What bounds it on an H100: neither bytes (4 W bytes out per env, 3.7 MB
// at B = 8192 on an 8x8 grid: 1.1 us at 3.35 TB/s) nor operations come
// near the card's rates; the 127 steps of an 8x8 maze are a dependent
// chain, and 8,192 envs are 62 an SM, two warps: one warp a scheduler at
// most, so nothing hides a step's latency, and the DFS warp's every
// instruction, on the chain or not, adds to it. Its time at one env an SM
// (B = 132) is that chain's floor.
//
// Design. A block takes 32 envs. Its four warps first draw the envs'
// uniforms and each step's picks min(floor(u * k), k - 1) for k = 2..4
// (they depend only on the subseed and the step) into shared memory, a
// byte a (step, env); then warp 0 runs the 32 DFS, a lane an env, and
// the four warps write the block's rows. Nothing lives in local memory
// (ptxas: a 0-byte stack frame):
// - the visited set is a register bitmask of NW 32-bit words (the
//   template parameter, N <= 32 NW), read and set through unrolled
//   selects, never a dynamic index;
// - the cell on top of the stack stays in a register; the stack itself
//   is in shared memory, [depth][env] 16-bit entries; the cell below the
//   top is loaded beside the top's neighbours at the start of each step,
//   so a pop adds nothing to the chain, and a step has no branch on push
//   or pop but the stores;
// - the neighbour tables are staged in shared memory once a block, one
//   int4 a cell ((cell | wall << 16) a direction, -1 off the grid);
// - the candidates are a 4-bit mask in direction order, built without a
//   branch, k = __popc of it, and the pick-th of them is found by clearing
//   the lowest set bit pick times (the three walks computed beside the
//   count, one selected); its direction's entry is selected by that bit;
// - the open walls are bits in shared memory, [word][env], and the block
//   writes its rows at the end, coalesced: consecutive threads store
//   consecutive floats of the block's (32 x W) span.
// 8,192 envs make 256 blocks, on every SM.

#include <cuda_runtime.h>

#include "rng.cuh"

#define MAX_CELLS 256
#define MAX_WALLS (2 * MAX_CELLS)
#define ENVS 32     // envs a block: warp 0 runs their DFS, a lane an env
#define HELPERS 4   // warps a block: all draw the steps' picks first

// The word of a visited mask that holds cell c's bit: a select, never a
// dynamic index (so the mask stays in registers).
template <int NW>
__device__ __forceinline__ unsigned visited_word(const unsigned (&vis)[NW], int c) {
    if constexpr (NW == 1) {
        return vis[0];
    } else if constexpr (NW == 2) {
        return (c & 32) ? vis[1] : vis[0];
    } else {
        unsigned w = vis[0];
#pragma unroll
        for (int j = 1; j < NW; ++j) w = (c >> 5) == j ? vis[j] : w;
        return w;
    }
}

// 1 where neighbour entry v names a cell (v >= 0) not yet visited, else 0
template <int NW>
__device__ __forceinline__ unsigned free_bit(const unsigned (&vis)[NW], int v) {
    const int c = v & 0xFFFF;
    return ((~visited_word<NW>(vis, c) >> (c & 31)) & 1u) & ((unsigned)~v >> 31);
}

template <int NW>
__device__ __forceinline__ void visit(unsigned (&vis)[NW], int c) {
#pragma unroll
    for (int j = 0; j < NW; ++j) vis[j] |= (c >> 5) == j ? 1u << (c & 31) : 0u;
}

// Step i's picks min(floor(u * k), k - 1) for k = 2, 3, 4 in bits 0-1,
// 2-3, 4-5 (k = 1 picks 0).
__device__ __forceinline__ unsigned char step_picks(const float u) {
    unsigned picks = 0u;
#pragma unroll
    for (int k = 2; k <= 4; ++k)
        picks |= (unsigned)min((int)floorf(u * (float)k), k - 1) << (2 * k - 4);
    return (unsigned char)picks;
}

template <int NW>
__global__ void __launch_bounds__(HELPERS * ENVS) mazegen_kernel(
    const unsigned int* __restrict__ seeds,  // (B,) subseeds
    const int* __restrict__ nbr_cell,        // (N, 4), -1 off-grid
    const int* __restrict__ nbr_wall,        // (N, 4)
    int B, int N, int Wn,
    float* __restrict__ walls)               // (B, Wn), 1 = open
{
    __shared__ int4 nbr[32 * NW];
    __shared__ unsigned short stack[32 * NW][ENVS];
    __shared__ unsigned char picks[64 * NW][ENVS];  // 2N - 1 steps
    __shared__ unsigned open_bits[2 * NW][ENVS];    // Wn < 2N bits
    const int tid = threadIdx.x, env = tid % ENVS;
    const int b0 = blockIdx.x * ENVS;
    const int n_env = min(ENVS, B - b0);
    for (int i = tid; i < 4 * N; i += HELPERS * ENVS) {
        const int nc = nbr_cell[i];
        reinterpret_cast<int*>(nbr)[i] = nc >= 0 ? nc | (nbr_wall[i] << 16) : -1;
    }
    if (tid < ENVS) {
#pragma unroll
        for (int j = 0; j < 2 * NW; ++j) open_bits[j][tid] = 0u;
    }
    // every warp draws picks: step i of env ``env`` on warp i % HELPERS
    if (env < n_env) {
        const unsigned int key = hash_u32(seeds[b0 + env], 2u);  // uniforms(s, 2, ...)
        for (int i = tid / ENVS; i < 2 * N - 1; i += HELPERS)
            picks[i][env] = step_picks(hash01(key, (unsigned int)i));
    }
    __syncthreads();

    if (tid < n_env) {  // warp 0: the DFS, one env a lane
        unsigned vis[NW];
#pragma unroll
        for (int j = 0; j < NW; ++j) vis[j] = 0u;
        vis[0] = 1u;
        stack[0][tid] = 0;
        int cur = 0, sp = 1;
        for (int i = 0; i < 2 * N - 1 && sp > 0; ++i) {
            const unsigned pw = (unsigned)picks[i][tid] << 4;  // k's pick in bits 2k, 2k + 1
            const int4 nb = nbr[cur];
            const int below = stack[max(sp - 2, 0)][tid];  // the top after a pop
            const unsigned cand = free_bit<NW>(vis, nb.x) | free_bit<NW>(vis, nb.y) << 1 |
                                  free_bit<NW>(vis, nb.z) << 2 | free_bit<NW>(vis, nb.w) << 3;
            const int k = __popc(cand);
            const unsigned pick = (pw >> (2 * k)) & 3u;
            // the pick-th set bit: the lowest one cleared pick times (the
            // three walks beside the count, then a select)
            const unsigned m1 = cand & (cand - 1u), m2 = m1 & (m1 - 1u), m3 = m2 & (m2 - 1u);
            const unsigned m = (pick & 2u) ? ((pick & 1u) ? m3 : m2) : ((pick & 1u) ? m1 : cand);
            const unsigned low = m & (0u - m);
            const int v = (low & 3u) ? ((low & 1u) ? nb.x : nb.y) : ((low & 4u) ? nb.z : nb.w);
            if (k > 0) {  // push: open the wall, visit the cell
                const int nc = v & 0xFFFF, wid = v >> 16;
                visit<NW>(vis, nc);
                open_bits[wid >> 5][tid] |= 1u << (wid & 31);
                stack[sp][tid] = (unsigned short)nc;
            }
            cur = k > 0 ? v & 0xFFFF : below;
            sp += k > 0 ? 1 : -1;
        }
    }
    __syncthreads();

    float* out = walls + (size_t)b0 * Wn;
    for (int j = tid; j < n_env * Wn; j += HELPERS * ENVS) {
        const int e = j / Wn, w = j - e * Wn;
        out[j] = ((open_bits[w >> 5][e] >> (w & 31)) & 1u) ? 1.0f : 0.0f;
    }
}

template <int NW>
static void launch_nw(const unsigned int* seeds, const int* nbr_cell, const int* nbr_wall,
                      int B, int N, int Wn, float* walls, cudaStream_t stream) {
    mazegen_kernel<NW><<<(B + ENVS - 1) / ENVS, HELPERS * ENVS, 0, stream>>>(
        seeds, nbr_cell, nbr_wall, B, N, Wn, walls);
}

extern "C" int mw_mazegen(
    const unsigned int* seeds, const int* nbr_cell, const int* nbr_wall,
    int B, int N, int Wn, float* walls, cudaStream_t stream)
{
    if (N < 1 || N > MAX_CELLS || Wn > MAX_WALLS || Wn >= 2 * N)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    if (N <= 32) launch_nw<1>(seeds, nbr_cell, nbr_wall, B, N, Wn, walls, stream);
    else if (N <= 64) launch_nw<2>(seeds, nbr_cell, nbr_wall, B, N, Wn, walls, stream);
    else if (N <= 128) launch_nw<4>(seeds, nbr_cell, nbr_wall, B, N, Wn, walls, stream);
    else launch_nw<8>(seeds, nbr_cell, nbr_wall, B, N, Wn, walls, stream);
    return (int)cudaGetLastError();
}

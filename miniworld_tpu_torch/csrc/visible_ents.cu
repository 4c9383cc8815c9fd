// Entity visibility query: per env, which entities' query boxes some
// pixel ray enters in front of the rooms' depth.
//
// Replaces: miniworld_tpu/render/visibility.py:visible_ents with its
// _room_depth (:38-101, the nearest room prim per ray, the dense
// tri_active kill of a procgen maze) and the query-box slab test
// (:105-141), XLA-fused jnp work in the JAX package. The plain PyTorch
// version is visible_ents_plain in miniworld_tpu_torch/render/visibility.py;
// with -fmad=false the arithmetic below matches it operation by operation:
// rays materialised as (fwd + xv right) + yv up, the unnormalised test
// max(u, v) + kind min(u, v) <= det, t = t_num * (1 / det) > NEAR, the
// slabs' IEEE divisions.
//
// What bounds it on an H100: operations. Every pixel tests every live
// room row (the 8x8 procgen maze's 832 rows, about half live in an env:
// at B = 8192, 80x60, some 2e10 row tests of about 25 operations), where
// its bytes are the rows once per env and a (B, E) flag.
//
// Design: one block of 256 threads per env. The block stages the env's
// live room rows in shared memory (g_det = e2 x e1, g_u = e2 x s, g_v = s
// x e1 with s = origin - v0, t_num = e2 . g_v, the kind: 48 bytes a row,
// compacted through a shared counter: the depth is a minimum, so their
// order does not matter), then walks the env's pixels 256 at a time:
// each thread builds its ray, takes the nearest room hit, and for each
// alive entity slab-tests the query box; a warp vote sets the entity's
// flag in shared memory, which the block writes out once.

#include <cuda_runtime.h>
#include <math.h>

#include "maze_row.cuh"

#define THREADS 256
#define MAX_E 64
#define NEAR 0.04f
#define FAR 100.0f
#define BOX_R 0.1f
#define BOX_H 0.2f
#define VIS_FIELDS 12

__global__ void __launch_bounds__(THREADS) visible_ents_kernel(
    const float* __restrict__ rows,       // (L, Sr, 12): v0, e1, e2, kind, 0, 0
    const int* __restrict__ row_code,     // (L, Sr): -2 padding, -1 always, 2w / 2w + 1
    const int* __restrict__ layout_id,    // (B,)
    const float* __restrict__ wall_open,  // (B, NW) or null
    const float* __restrict__ origin, const float* __restrict__ fwd,
    const float* __restrict__ right, const float* __restrict__ up,
    const float* __restrict__ tan_xy, const float* __restrict__ xbase,
    const float* __restrict__ ybase,
    const float* __restrict__ ent_pos,    // (B, E, 3)
    const unsigned char* __restrict__ ent_alive,  // (B, E)
    int Sr, int E, int W, int H, int NW,
    unsigned char* __restrict__ visible)  // (B, E)
{
    extern __shared__ float4 staged[];  // (n_live, 3): (g_det, t_num), (g_u, kind), (g_v, 0)
    __shared__ int n_live;
    __shared__ int vis[MAX_E];
    const int b = blockIdx.x;
    const int l = layout_id[b];
    if (threadIdx.x == 0) n_live = 0;
    for (int e = threadIdx.x; e < E; e += THREADS) vis[e] = 0;
    __syncthreads();
    const float o0 = origin[3 * b], o1 = origin[3 * b + 1], o2 = origin[3 * b + 2];
    for (int i = threadIdx.x; i < Sr; i += THREADS) {
        const size_t q = (size_t)l * Sr + i;
        if (!row_live(row_code[q], wall_open, b, NW)) continue;
        const float* r = rows + q * VIS_FIELDS;
        const float e1x = r[3], e1y = r[4], e1z = r[5];
        const float e2x = r[6], e2y = r[7], e2z = r[8];
        const float sx = o0 - r[0], sy = o1 - r[1], sz = o2 - r[2];
        // g_det = e2 x e1, g_u = e2 x s, g_v = s x e1 (jnp.cross's order)
        const float4 gd = make_float4(e2y * e1z - e2z * e1y, e2z * e1x - e2x * e1z,
                                      e2x * e1y - e2y * e1x, 0.0f);
        const float4 gu = make_float4(e2y * sz - e2z * sy, e2z * sx - e2x * sz,
                                      e2x * sy - e2y * sx, r[9]);
        const float4 gv = make_float4(sy * e1z - sz * e1y, sz * e1x - sx * e1z,
                                      sx * e1y - sy * e1x, 0.0f);
        const float t_num = (e2x * gv.x + e2y * gv.y) + e2z * gv.z;
        const int k = atomicAdd(&n_live, 1);
        staged[3 * k] = make_float4(gd.x, gd.y, gd.z, t_num);
        staged[3 * k + 1] = gu;
        staged[3 * k + 2] = gv;
    }
    __syncthreads();
    const int n = n_live;
    const int hw = W * H;
    const float tan_x = tan_xy[2 * b], tan_y = tan_xy[2 * b + 1];
    const bool lane0 = (threadIdx.x & 31) == 0;
    for (int p0 = 0; p0 < hw; p0 += THREADS) {  // uniform trip count: every lane votes
        const int p = p0 + (int)threadIdx.x;
        const bool valid = p < hw;
        float d[3] = {0.0f, 0.0f, 0.0f};
        float depth = INFINITY;
        if (valid) {
            const float xv = xbase[p % W] * tan_x;
            const float yv = ybase[p / W] * tan_y;
#pragma unroll
            for (int i = 0; i < 3; ++i)
                d[i] = (fwd[3 * b + i] + xv * right[3 * b + i]) + yv * up[3 * b + i];
            for (int j = 0; j < n; ++j) {
                const float4 gd = staged[3 * j], gu = staged[3 * j + 1], gv = staged[3 * j + 2];
                const float det = (d[0] * gd.x + d[1] * gd.y) + d[2] * gd.z;
                const float u = (d[0] * gu.x + d[1] * gu.y) + d[2] * gu.z;
                const float v = (d[0] * gv.x + d[1] * gv.y) + d[2] * gv.z;
                const float t = gd.w * (1.0f / (det > 1e-12f ? det : 1.0f));
                const float cov = fmaxf(u, v) + gu.w * fminf(u, v);
                if (det > 1e-12f && u >= 0.0f && v >= 0.0f && cov <= det && t > NEAR &&
                    t < FAR)
                    depth = fminf(depth, t);
            }
        }
        float sd[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) sd[i] = fabsf(d[i]) < 1e-12f ? 1e-12f : d[i];
        for (int e = 0; e < E; ++e) {
            const size_t k = (size_t)b * E + e;
            if (!ent_alive[k]) continue;  // uniform over the block
            bool hit = false;
            if (valid) {
                const float lo[3] = {ent_pos[3 * k] + -BOX_R, ent_pos[3 * k + 1] + 0.0f,
                                     ent_pos[3 * k + 2] + -BOX_R};
                const float hi[3] = {ent_pos[3 * k] + BOX_R, ent_pos[3 * k + 1] + BOX_H,
                                     ent_pos[3 * k + 2] + BOX_R};
                const float oo[3] = {o0, o1, o2};
                float t_in = -INFINITY, t_out = INFINITY;
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                    const float t1 = (lo[i] - oo[i]) / sd[i];
                    const float t2 = (hi[i] - oo[i]) / sd[i];
                    t_in = fmaxf(t_in, fminf(t1, t2));
                    t_out = fminf(t_out, fmaxf(t1, t2));
                }
                hit = t_in <= t_out && t_in > NEAR && t_in < FAR && t_in < depth;
            }
            if (__any_sync(0xffffffffu, hit) && lane0) vis[e] = 1;
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += THREADS) visible[(size_t)b * E + e] = (unsigned char)vis[e];
}

extern "C" int mw_visible_ents(
    const float* rows, const int* row_code, const int* layout_id, const float* wall_open,
    const float* origin, const float* fwd, const float* right, const float* up,
    const float* tan_xy, const float* xbase, const float* ybase, const float* ent_pos,
    const unsigned char* ent_alive, int B, int Sr, int E, int W, int H, int NW,
    unsigned char* visible, cudaStream_t stream)
{
    if (B < 0 || Sr <= 0 || E < 0 || E > MAX_E || W <= 0 || H <= 0 ||
        (NW > 0) != (wall_open != nullptr))
        return (int)cudaErrorInvalidValue;
    if (B == 0 || E == 0) return 0;
    const size_t smem = (size_t)Sr * 3 * sizeof(float4);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            visible_ents_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    visible_ents_kernel<<<B, THREADS, smem, stream>>>(
        rows, row_code, layout_id, wall_open, origin, fwd, right, up, tan_xy, xbase, ybase,
        ent_pos, ent_alive, Sr, E, W, H, NW, visible);
    return (int)cudaGetLastError();
}

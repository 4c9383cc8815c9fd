// Static-prim hit test: keyed-z winner and winner attributes per pixel.
//
// Replaces: miniworld_tpu/render/raycast.py:_tri_pass (single-chunk
// form, chunk_compete, and the ``init`` seed of the carry), an XLA-fused
// jnp stage in the JAX package. The plain PyTorch version is
// tri_pass_plain in miniworld_tpu_torch/render/raycast.py; the two agree
// bit for bit (the library is built with -fmad=false and the arithmetic
// below follows the plain version operation by operation).
//
// What bounds it on an H100: per (env, pixel) it reads nothing but the
// env's prim table and writes 4 bytes of t plus 32 bytes of bf16
// attributes, so at Hallway's S = 8 it is bound by those stores
// (about 36 bytes/pixel, 177 MB at B = 1024, 80x60) rather than by the
// 2 multiply-adds x 3 per (prim, pixel). At an 8x8 maze's S = 608 rows
// it is bound by operations instead: about 22 float operations per
// (row, pixel), 526 GFLOP at B = 8192, 80x60, or 7.9 ms at the card's
// 67 TFLOP/s float32 peak.
//
// Design: one thread per (env, pixel), one block row per env. The block
// first stages the env's per-prim coefficients in shared memory — the
// three basis dots of g_det, g_u and g_v (separable rays:
// g . d = g.fwd + xv * g.right + yv * g.up), the per-prim reciprocal
// 1/t_num, and the kind — so the per-pixel loop is pure register work.
// The running z-key (r's bits with the low 10 mantissa bits replaced by
// the prim row) stays in a register; ties go to the larger row through
// the integer max. The winner's attribute row is loaded once, by index,
// at the end (the JAX package used a one-hot matmul because TPU gathers
// are slow; here it is one 64-byte read from L1/L2).
//
// Seeded launch (seed_t != nullptr; scenes with mesh entities): the
// mesh-entity pass's (t, attr) starts the competition. Its key is 1/t
// with the row bits all ones, so it wins quantized-depth ties; a prim
// replaces it only with a strictly greater key, and a pixel no prim
// wins keeps the seed's attributes (zeros where the seed missed too).
//
// Paired launch (pg_wall != nullptr; procgen mazes, the paired bank of
// scene/supermaze.py and raycast.py:259-295 / 1206-1219): every row has
// a primary and an alternative variant. Row s of env b takes the primary
// where pg_wall[s] < 0 (no wall) or its wall is open in wall_open[b],
// the alternative (the wall's closed quads) otherwise. The staging loop
// picks the variant before computing the row's coefficients and keeps
// the choice as one byte per row in shared memory after the 11 float
// fields (11 x 4 + 1 bytes per row: 46,080 B at S = 1024, under the
// 48 KB default), so the winner's attributes come from its variant.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#define ATTR_DIM 16
#define IDX_MASK 0x3FF
#define PRIM_FIELDS 11

__global__ void tri_pass_kernel(
    const float* __restrict__ verts9,   // (L, 9, S) component-major
    const float* __restrict__ attr,     // (L, S, 16)
    const int* __restrict__ layout_id,  // (B,)
    const float* __restrict__ origin,   // (B, 3)
    const float* __restrict__ fwd,      // (B, 3)
    const float* __restrict__ right,    // (B, 3)
    const float* __restrict__ up,       // (B, 3)
    const float* __restrict__ tan_xy,   // (B, 2)
    const float* __restrict__ xbase,    // (W,)
    const float* __restrict__ ybase,    // (H,)
    const float* __restrict__ seed_t,   // (B, HW) or null
    const __nv_bfloat16* __restrict__ seed_attr,  // (B, HW, 16) or null
    const float* __restrict__ verts9_alt,  // (L, 9, S) or null
    const float* __restrict__ attr_alt,   // (L, S, 16) or null
    const int* __restrict__ pg_wall,      // (L, S) or null; -1 = no wall
    const float* __restrict__ wall_open,  // (B, Wn) or null; 1 = open
    int S, int W, int H, int Wn, int all_quads,
    float* __restrict__ t_out,          // (B, HW)
    __nv_bfloat16* __restrict__ attr_out)  // (B, HW, 16)
{
    extern __shared__ float prim[];  // PRIM_FIELDS x S, field-major
    unsigned char* use_alt = reinterpret_cast<unsigned char*>(prim + PRIM_FIELDS * S);
    const int b = blockIdx.y;
    const int lid = layout_id[b];
    const bool paired = pg_wall != nullptr;
    const float* v9p = verts9 + (size_t)lid * 9 * S;
    const float* atp = attr + (size_t)lid * S * ATTR_DIM;
    const float* v9a = paired ? verts9_alt + (size_t)lid * 9 * S : nullptr;
    const float* ata = paired ? attr_alt + (size_t)lid * S * ATTR_DIM : nullptr;
    const float ox = origin[3 * b], oy = origin[3 * b + 1], oz = origin[3 * b + 2];
    const float f0 = fwd[3 * b], f1 = fwd[3 * b + 1], f2 = fwd[3 * b + 2];
    const float r0 = right[3 * b], r1 = right[3 * b + 1], r2 = right[3 * b + 2];
    const float u0 = up[3 * b], u1 = up[3 * b + 1], u2 = up[3 * b + 2];

    for (int s = threadIdx.x; s < S; s += blockDim.x) {
        bool alt = false;
        if (paired) {
            const int w = pg_wall[(size_t)lid * S + s];
            alt = w >= 0 && !(wall_open[(size_t)b * Wn + w] > 0.5f);
            use_alt[s] = alt;
        }
        const float* v9 = alt ? v9a : v9p;
        const float e1x = v9[3 * S + s] - v9[s];
        const float e1y = v9[4 * S + s] - v9[S + s];
        const float e1z = v9[5 * S + s] - v9[2 * S + s];
        const float e2x = v9[6 * S + s] - v9[s];
        const float e2y = v9[7 * S + s] - v9[S + s];
        const float e2z = v9[8 * S + s] - v9[2 * S + s];
        const float sx = ox - v9[s];
        const float sy = oy - v9[S + s];
        const float sz = oz - v9[2 * S + s];
        const float gdx = e2y * e1z - e2z * e1y;
        const float gdy = e2z * e1x - e2x * e1z;
        const float gdz = e2x * e1y - e2y * e1x;
        const float gux = e2y * sz - e2z * sy;
        const float guy = e2z * sx - e2x * sz;
        const float guz = e2x * sy - e2y * sx;
        const float gvx = sy * e1z - sz * e1y;
        const float gvy = sz * e1x - sx * e1z;
        const float gvz = sx * e1y - sy * e1x;
        const float t_num = e2x * gvx + e2y * gvy + e2z * gvz;
        prim[0 * S + s] = gdx * f0 + gdy * f1 + gdz * f2;
        prim[1 * S + s] = gdx * r0 + gdy * r1 + gdz * r2;
        prim[2 * S + s] = gdx * u0 + gdy * u1 + gdz * u2;
        prim[3 * S + s] = gux * f0 + guy * f1 + guz * f2;
        prim[4 * S + s] = gux * r0 + guy * r1 + guz * r2;
        prim[5 * S + s] = gux * u0 + guy * u1 + guz * u2;
        prim[6 * S + s] = gvx * f0 + gvy * f1 + gvz * f2;
        prim[7 * S + s] = gvx * r0 + gvy * r1 + gvz * r2;
        prim[8 * S + s] = gvx * u0 + gvy * u1 + gvz * u2;
        prim[9 * S + s] = t_num > 0.0f ? 1.0f / t_num : 0.0f;
        prim[10 * S + s] = (alt ? ata : atp)[s * ATTR_DIM + 15];  // kind
    }
    __syncthreads();

    const int hw = W * H;
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= hw) return;
    const float xv = xbase[p % W] * tan_xy[2 * b];
    const float yv = ybase[p / W] * tan_xy[2 * b + 1];
    const float r_near = (float)(1.0 / 0.04);  // 1 / NEAR
    const float r_far = (float)(1.0 / 100.0);  // 1 / FAR

    int best = 0;
    for (int s = 0; s < S; ++s) {
        const float det = prim[s] + prim[S + s] * xv + prim[2 * S + s] * yv;
        const float un = prim[3 * S + s] + prim[4 * S + s] * xv + prim[5 * S + s] * yv;
        const float vn = prim[6 * S + s] + prim[7 * S + s] * xv + prim[8 * S + s] * yv;
        const float r = det * prim[9 * S + s];
        float cov = fmaxf(un, vn);
        if (!all_quads) cov = cov + prim[10 * S + s] * fminf(un, vn);
        const bool hit = det > 1e-12f && un >= 0.0f && vn >= 0.0f &&
                         cov <= det && r < r_near && r > r_far;
        const int key = hit ? ((__float_as_int(r) & ~IDX_MASK) | s) : 0;
        best = max(best, key);
    }

    const size_t q = (size_t)b * hw + p;
    if (seed_t != nullptr) {
        const float seed_r = 1.0f / seed_t[q];  // 1/inf = 0: no seed
        const int seed_key =
            seed_r > 0.0f ? ((__float_as_int(seed_r) & ~IDX_MASK) | IDX_MASK) : 0;
        if (!(best > seed_key)) {
            t_out[q] = seed_key > 0
                ? 1.0f / fmaxf(__int_as_float(seed_key & ~IDX_MASK), 1e-30f) : INFINITY;
            const uint4* s4 = reinterpret_cast<const uint4*>(seed_attr + q * ATTR_DIM);
            uint4* d4 = reinterpret_cast<uint4*>(attr_out + q * ATTR_DIM);
            d4[0] = s4[0];
            d4[1] = s4[1];
            return;
        }
    }
    t_out[q] = best > 0 ? 1.0f / fmaxf(__int_as_float(best & ~IDX_MASK), 1e-30f)
                        : INFINITY;
    // winner's row (row 0 for an unseeded miss: nothing downstream reads it)
    const int row = best & IDX_MASK;
    const float* at = (paired && use_alt[row]) ? ata : atp;
    const float4* src = reinterpret_cast<const float4*>(at + row * ATTR_DIM);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(attr_out + q * ATTR_DIM);
#pragma unroll
    for (int i = 0; i < ATTR_DIM / 4; ++i) {
        const float4 v = src[i];
        dst[2 * i] = __floats2bfloat162_rn(v.x, v.y);
        dst[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
    }
}

extern "C" const char* mw_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

extern "C" int mw_tri_pass(
    const float* verts9, const float* attr, const int* layout_id,
    const float* origin, const float* fwd, const float* right, const float* up,
    const float* tan_xy, const float* xbase, const float* ybase,
    const float* seed_t, const __nv_bfloat16* seed_attr,
    const float* verts9_alt, const float* attr_alt, const int* pg_wall,
    const float* wall_open,
    int B, int S, int W, int H, int Wn, int all_quads,
    float* t_out, __nv_bfloat16* attr_out, cudaStream_t stream)
{
    const bool paired = pg_wall != nullptr;
    if (paired && (verts9_alt == nullptr || attr_alt == nullptr || wall_open == nullptr))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const int threads = 256;
    const dim3 grid((W * H + threads - 1) / threads, B);
    const size_t smem = (size_t)PRIM_FIELDS * S * sizeof(float) + (paired ? (size_t)S : 0);
    tri_pass_kernel<<<grid, threads, smem, stream>>>(
        verts9, attr, layout_id, origin, fwd, right, up, tan_xy, xbase, ybase,
        seed_t, seed_attr, verts9_alt, attr_alt, pg_wall, wall_open,
        S, W, H, Wn, all_quads, t_out, attr_out);
    return (int)cudaGetLastError();
}

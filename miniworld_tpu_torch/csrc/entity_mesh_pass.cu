// Dynamic mesh entities: keyed-z winner over each env's own world-space
// triangle rows, and the winner's attributes, per pixel.
//
// Replaces: miniworld_tpu/render/raycast.py:_entity_mesh_pass, an
// XLA-fused jnp stage in the JAX package. The rows come from
// entity_mesh_rows (plain torch: every entity's decimated local rows
// rotated, scaled and moved to world space, inactive rows zeroed). The
// plain PyTorch version is entity_mesh_pass_plain in
// miniworld_tpu_torch/render/raycast.py; the two agree bit for bit (the
// library is built with -fmad=false and the arithmetic below follows the
// plain version operation by operation).
//
// What bounds it on an H100: per (row, pixel) about 20 float operations
// (three separable contractions, the reciprocal-depth product, the
// coverage sum and six compares) against 36 bytes of output per pixel.
// At PickupObjects' shapes (B = 4096, 80x60, E*M = 80 rows of which the
// live ones are tested) the operations bound it, not the stores.
//
// Design: tri_pass's, with the rows per env instead of per layout. One
// thread per (env, pixel), one block row per env. The block stages the
// env's per-row coefficients in shared memory (the three basis dots of
// g_det, g_u and g_v and the per-row reciprocal 1/t_num: 10 floats a
// row, 40 KB at the 1024-row limit of the z-key), then each thread runs
// the rows with its running key in a register. Every row is a triangle
// (coverage u + v <= det). A pixel no row hits gets t = inf and all-zero
// attributes (the JAX package's one-hot is masked by key > 0), which is
// what seeds tri_pass's carry there.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#define ATTR_DIM 16
#define IDX_MASK 0x3FF
#define ROW_FIELDS 10

__global__ void entity_mesh_pass_kernel(
    const float* __restrict__ verts9,   // (B, 9, N) component-major
    const float* __restrict__ attrs,    // (B, N, 16)
    const float* __restrict__ origin,   // (B, 3)
    const float* __restrict__ fwd,      // (B, 3)
    const float* __restrict__ right,    // (B, 3)
    const float* __restrict__ up,       // (B, 3)
    const float* __restrict__ tan_xy,   // (B, 2)
    const float* __restrict__ xbase,    // (W,)
    const float* __restrict__ ybase,    // (H,)
    int N, int W, int H,
    float* __restrict__ t_out,          // (B, HW)
    __nv_bfloat16* __restrict__ attr_out)  // (B, HW, 16)
{
    extern __shared__ float row[];  // ROW_FIELDS x N, field-major
    const int b = blockIdx.y;
    const float* v9 = verts9 + (size_t)b * 9 * N;
    const float* at = attrs + (size_t)b * N * ATTR_DIM;
    const float ox = origin[3 * b], oy = origin[3 * b + 1], oz = origin[3 * b + 2];
    const float f0 = fwd[3 * b], f1 = fwd[3 * b + 1], f2 = fwd[3 * b + 2];
    const float r0 = right[3 * b], r1 = right[3 * b + 1], r2 = right[3 * b + 2];
    const float u0 = up[3 * b], u1 = up[3 * b + 1], u2 = up[3 * b + 2];

    for (int s = threadIdx.x; s < N; s += blockDim.x) {
        const float e1x = v9[3 * N + s] - v9[s];
        const float e1y = v9[4 * N + s] - v9[N + s];
        const float e1z = v9[5 * N + s] - v9[2 * N + s];
        const float e2x = v9[6 * N + s] - v9[s];
        const float e2y = v9[7 * N + s] - v9[N + s];
        const float e2z = v9[8 * N + s] - v9[2 * N + s];
        const float sx = ox - v9[s];
        const float sy = oy - v9[N + s];
        const float sz = oz - v9[2 * N + s];
        // g_det = e2 x e1 ; g_u = e2 x s ; g_v = s x e1
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
        row[0 * N + s] = gdx * f0 + gdy * f1 + gdz * f2;
        row[1 * N + s] = gdx * r0 + gdy * r1 + gdz * r2;
        row[2 * N + s] = gdx * u0 + gdy * u1 + gdz * u2;
        row[3 * N + s] = gux * f0 + guy * f1 + guz * f2;
        row[4 * N + s] = gux * r0 + guy * r1 + guz * r2;
        row[5 * N + s] = gux * u0 + guy * u1 + guz * u2;
        row[6 * N + s] = gvx * f0 + gvy * f1 + gvz * f2;
        row[7 * N + s] = gvx * r0 + gvy * r1 + gvz * r2;
        row[8 * N + s] = gvx * u0 + gvy * u1 + gvz * u2;
        row[9 * N + s] = t_num > 0.0f ? 1.0f / t_num : 0.0f;
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
    for (int s = 0; s < N; ++s) {
        const float det = row[s] + row[N + s] * xv + row[2 * N + s] * yv;
        const float un = row[3 * N + s] + row[4 * N + s] * xv + row[5 * N + s] * yv;
        const float vn = row[6 * N + s] + row[7 * N + s] * xv + row[8 * N + s] * yv;
        const float r = det * row[9 * N + s];
        const bool hit = det > 1e-12f && un >= 0.0f && vn >= 0.0f &&
                         un + vn <= det && r < r_near && r > r_far;
        const int key = hit ? ((__float_as_int(r) & ~IDX_MASK) | s) : 0;
        best = max(best, key);
    }

    const size_t q = (size_t)b * hw + p;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(attr_out + q * ATTR_DIM);
    if (best == 0) {
        t_out[q] = INFINITY;
        const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
        for (int i = 0; i < ATTR_DIM / 2; ++i) dst[i] = zero;
        return;
    }
    t_out[q] = 1.0f / fmaxf(__int_as_float(best & ~IDX_MASK), 1e-30f);
    const float4* src = reinterpret_cast<const float4*>(at + (best & IDX_MASK) * ATTR_DIM);
#pragma unroll
    for (int i = 0; i < ATTR_DIM / 4; ++i) {
        const float4 v = src[i];
        dst[2 * i] = __floats2bfloat162_rn(v.x, v.y);
        dst[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
    }
}

extern "C" int mw_entity_mesh_pass(
    const float* verts9, const float* attrs,
    const float* origin, const float* fwd, const float* right, const float* up,
    const float* tan_xy, const float* xbase, const float* ybase,
    int B, int N, int W, int H,
    float* t_out, __nv_bfloat16* attr_out, cudaStream_t stream)
{
    const int threads = 256;
    const dim3 grid((W * H + threads - 1) / threads, B);
    const size_t smem = (size_t)ROW_FIELDS * N * sizeof(float);
    entity_mesh_pass_kernel<<<grid, threads, smem, stream>>>(
        verts9, attrs, origin, fwd, right, up, tan_xy, xbase, ybase,
        N, W, H, t_out, attr_out);
    return (int)cudaGetLastError();
}

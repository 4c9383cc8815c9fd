// Per-pixel epilogue: uv, Fourier texel, entity merge, lighting, u8 pack.
//
// Replaces: the pixel stage of miniworld_tpu/render/raycast.py:render_rgbd
// (affine uv and footprint, eval_fourier with _cos_sin_turns, shade, the
// sky select and the truncating u8 / depth outputs), XLA-fused jnp work
// in the JAX package. The plain PyTorch version is pixel_epilogue_plain
// in miniworld_tpu_torch/render/raycast.py; with -fmad=false the
// arithmetic below matches it operation by operation, bf16 roundings
// included (the JAX package's texture dots take bf16 cos/sin and
// amplitudes and return bf16 sums; both ports round at those points).
//
// What bounds it on an H100: per pixel it reads 4 + 32 (+ 28 with
// entities) bytes and writes 3 + 4, and evaluates K = 16 Fourier terms
// (~40 flops each: phase, turn-wrapped cos/sin polynomials, AA
// attenuation and its reciprocal, 6 amplitude products), so at K = 16
// it is closer to the FP32 rate than to the memory bound.
//
// Design: one thread per (env, pixel). The winner's atlas row is read by
// slot index straight from global memory (the atlas is a few KB and
// stays in L1/L2; the JAX package's one-hot matmuls over atlas rows
// existed only because TPU gathers are slow). The K-term sums run in
// registers in order k = 0..K-1, the same order as the plain version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define ATTR_DIM 16

__device__ __forceinline__ float bf16r(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void pixel_epilogue_kernel(
    const float* __restrict__ t_tri,           // (B, HW)
    const __nv_bfloat16* __restrict__ attr,    // (B, HW, 16)
    const float* __restrict__ t_ent,           // (B, HW) or null
    const float* __restrict__ col_ent,         // (B, HW, 3) or null
    const float* __restrict__ n_ent,           // (B, HW, 3) or null
    const float* __restrict__ atlas,           // (A, 4 + 8K)
    const float* __restrict__ lights,          // (B, 4, 3): pos, color, ambient, sky
    const float* __restrict__ origin, const float* __restrict__ fwd,
    const float* __restrict__ right, const float* __restrict__ up,
    const float* __restrict__ tan_xy, const float* __restrict__ xbase,
    const float* __restrict__ ybase,
    int W, int H, int A, int K, int has_ent,
    uint8_t* __restrict__ rgb_out,             // (B, H, W, 3)
    float* __restrict__ depth_out)             // (B, H, W, 1)
{
    const int b = blockIdx.y;
    const int hw = W * H;
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= hw) return;
    const size_t q = (size_t)b * hw + p;
    const float xv = xbase[p % W] * tan_xy[2 * b];
    const float tan_y = tan_xy[2 * b + 1];
    const float yv = ybase[p / W] * tan_y;
    float o[3], d[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        o[i] = origin[3 * b + i];
        d[i] = fwd[3 * b + i] + xv * right[3 * b + i] + yv * up[3 * b + i];
    }
    float at[ATTR_DIM];
    const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(attr + q * ATTR_DIM);
#pragma unroll
    for (int i = 0; i < ATTR_DIM / 2; ++i) {
        const float2 v = __bfloat1622float2(src[i]);
        at[2 * i] = v.x;
        at[2 * i + 1] = v.y;
    }

    // uv from the winner's affine map at the hit point; uv-space footprint
    const float tt = t_tri[q];
    const float t_uv = isfinite(tt) ? tt : 0.0f;
    const float h0 = o[0] + t_uv * d[0], h1 = o[1] + t_uv * d[1], h2 = o[2] + t_uv * d[2];
    const float uu = at[0] * h0 + at[1] * h1 + at[2] * h2 + at[6];
    const float vv = at[3] * h0 + at[4] * h1 + at[5] * h2 + at[7];
    float sq = at[0] * at[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) sq = sq + at[i] * at[i];
    const float pix_angle = tan_y * (float)(2.0 / H);
    const float fp = t_uv * pix_angle * sqrtf(sq * 0.5f);

    // Fourier texel (row layout: dc(3) | fu(K) | fv(K) | A(3K) | B(3K) | gain)
    float tex[3];
    const int slot = (int)rintf(at[14]);
    if (slot < 0) {
        tex[0] = tex[1] = tex[2] = 1.0f;  // flat white
    } else if (slot >= A) {
        tex[0] = tex[1] = tex[2] = 0.0f;  // no such row: black, as in the JAX one-hot
    } else {
        const float* row = atlas + (size_t)slot * (4 + 8 * K);
        const float* wa = row + 3 + 2 * K;
        const float* wb = wa + 3 * K;
        const double pi = 3.141592653589793;  // Python's math.pi
        const float pi2 = (float)(pi * pi);
        const float fp2 = fp * fp;
        float acc_a[3] = {0.0f, 0.0f, 0.0f}, acc_b[3] = {0.0f, 0.0f, 0.0f};
        for (int k = 0; k < K; ++k) {
            const float fu = bf16r(row[3 + k]);
            const float fv = bf16r(row[3 + K + k]);
            const float phi = fu * uu + fv * vv;
            const float t = phi - rintf(phi);
            const float x = t * t;
            float c = (((46.31062891f * x - 82.70142833f) * x + 64.7143991f) * x
                       - 19.73279735f) * x + 0.99997109f;
            float s = t * ((((33.16881029f * x - 74.67622289f) * x + 81.40014212f) * x
                            - 41.33325045f) * x + 6.2830885f);
            const float f2 = fu * fu + fv * fv;
            const float att = 1.0f / (1.0f + pi2 * f2 * fp2);
            c = bf16r(c * att);
            s = bf16r(s * att);
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
                const float pa = c * bf16r(wa[ch * K + k]);
                const float pb = s * bf16r(wb[ch * K + k]);
                acc_a[ch] = k == 0 ? pa : acc_a[ch] + pa;
                acc_b[ch] = k == 0 ? pb : acc_b[ch] + pb;
            }
        }
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            const float v = bf16r(row[ch]) + bf16r(bf16r(acc_a[ch]) + bf16r(acc_b[ch]));
            tex[ch] = fminf(fmaxf(v, 0.0f), 1.0f);
        }
    }
    float col[3] = {at[11] * tex[0], at[12] * tex[1], at[13] * tex[2]};
    float nrm[3] = {at[8], at[9], at[10]};

    // analytic entities win where they are strictly closer
    float t_hit = tt;
    if (has_ent) {
        const float te = t_ent[q];
        if (te < tt) {
            t_hit = te;
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                col[i] = col_ent[3 * q + i];
                nrm[i] = n_ent[3 * q + i];
            }
        }
    }

    const bool hit = isfinite(t_hit);
    const float t_safe = hit ? t_hit : 100.0f;  // FAR
    const float* lt = lights + (size_t)b * 12;
    float out[3];
    if (hit) {
        float l[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) l[i] = lt[i] - (o[i] + t_safe * d[i]);
        const float len = fmaxf(sqrtf(l[0] * l[0] + l[1] * l[1] + l[2] * l[2]), 1e-9f);
        const float ndotl = fmaxf(nrm[0] * (l[0] / len) + nrm[1] * (l[1] / len) +
                                  nrm[2] * (l[2] / len), 0.0f);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const float lit = (0.2f + lt[6 + i]) + lt[3 + i] * ndotl;
            out[i] = col[i] * fminf(fmaxf(lit, 0.0f), 1.0f);
        }
    } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) out[i] = lt[9 + i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        // truncating pack, as (rgb * 255).clip(0, 255).astype(uint8)
        rgb_out[3 * q + i] = (uint8_t)fminf(fmaxf(out[i] * 255.0f, 0.0f), 255.0f);
    }
    depth_out[q] = t_safe;
}

extern "C" int mw_pixel_epilogue(
    const float* t_tri, const __nv_bfloat16* attr, const float* t_ent,
    const float* col_ent, const float* n_ent, const float* atlas,
    const float* lights, const float* origin, const float* fwd,
    const float* right, const float* up, const float* tan_xy,
    const float* xbase, const float* ybase,
    int B, int W, int H, int A, int K, int has_ent,
    uint8_t* rgb_out, float* depth_out, cudaStream_t stream)
{
    const int threads = 256;
    const dim3 grid((W * H + threads - 1) / threads, B);
    pixel_epilogue_kernel<<<grid, threads, 0, stream>>>(
        t_tri, attr, t_ent, col_ent, n_ent, atlas, lights, origin, fwd, right,
        up, tan_xy, xbase, ybase, W, H, A, K, has_ent, rgb_out, depth_out);
    return (int)cudaGetLastError();
}

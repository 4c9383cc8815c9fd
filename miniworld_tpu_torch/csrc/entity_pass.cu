// Analytic sphere and box entities: keyed-z winner, its color and normal.
//
// Replaces: miniworld_tpu/render/raycast.py:_entity_pass, an XLA-fused
// jnp stage in the JAX package. The plain PyTorch version is
// entity_pass_plain in miniworld_tpu_torch/render/raycast.py; with
// -fmad=false the arithmetic below matches it operation by operation.
//
// What bounds it on an H100: with a handful of entity slots (Hallway
// has one box) the work per pixel is a few dozen flops and one
// reciprocal per slab, so it is bound by its 28 bytes of stores per
// pixel (t, color, normal: 137 MB at B = 1024, 80x60).
//
// Design: one thread per (env, pixel), one block row per env. The block
// stages each slot's per-entity constants in shared memory (box frame,
// origin in the box frame, slab offsets, sphere center offset and the
// basis dots of the separable rays), so the per-pixel loop over slots
// runs in registers: sphere hit (disc > 0 with |d|^2 = 1 + xv^2 + yv^2),
// OBB slab test, keyed-z max over slots, and the winner's normal
// (sphere: (oc + t d) / r; box: entry-slab normal, split evenly over
// tied slabs, sign(0) = 0) and color.

#include <cuda_runtime.h>
#include <math.h>

#define IDX_MASK 0x3FF
#define ENT_ACTIVE 1
#define ENT_SPHERE 2
#define ENT_BOX 4

// per-entity constants, field-major in shared memory
enum {
    F_FLAGS,
    F_AXX0, F_AXX2, F_AXZ0, F_AXZ2,  // box axes (y components are 0 / 1)
    F_DX_A, F_DX_B, F_DX_C,          // ray_dot(ax_x) = a + b xv + c yv
    F_DZ_A, F_DZ_B, F_DZ_C,          // ray_dot(ax_z)
    F_LO0, F_LO1, F_LO2,             // lo - o_l per axis
    F_HI0, F_HI1, F_HI2,             // hi - o_l per axis
    F_OC0, F_OC1, F_OC2,             // origin - sphere center
    F_OC_A, F_OC_B, F_OC_C,          // ray_dot(oc)
    F_CC,                            // |oc|^2 - r^2
    F_INV_RV,                        // 1 / max(r, 1e-9)
    F_COUNT
};

__device__ __forceinline__ float signf_(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__global__ void entity_pass_kernel(
    const float* __restrict__ ent_pos,     // (B, E, 3)
    const float* __restrict__ ent_size,    // (B, E, 3)
    const float* __restrict__ ent_dir,     // (B, E)
    const float* __restrict__ ent_height,  // (B, E)
    const float* __restrict__ ent_color,   // (B, E, 3)
    const unsigned char* __restrict__ flags,  // (B, E)
    const float* __restrict__ origin, const float* __restrict__ fwd,
    const float* __restrict__ right, const float* __restrict__ up,
    const float* __restrict__ tan_xy, const float* __restrict__ xbase,
    const float* __restrict__ ybase,
    int E, int W, int H, int has_sphere, int has_box,
    float* __restrict__ t_out, float* __restrict__ col_out,
    float* __restrict__ n_out)
{
    extern __shared__ float ent[];  // F_COUNT x E
    const int b = blockIdx.y;
    const float ox = origin[3 * b], oy = origin[3 * b + 1], oz = origin[3 * b + 2];
    const float f0 = fwd[3 * b], f1 = fwd[3 * b + 1], f2 = fwd[3 * b + 2];
    const float r0 = right[3 * b], r1 = right[3 * b + 1], r2 = right[3 * b + 2];
    const float u0 = up[3 * b], u1 = up[3 * b + 1], u2 = up[3 * b + 2];

    for (int e = threadIdx.x; e < E; e += blockDim.x) {
        const int i = b * E + e;
        const float px = ent_pos[3 * i], py = ent_pos[3 * i + 1], pz = ent_pos[3 * i + 2];
        const float h = ent_height[i];
        const float cd = cosf(ent_dir[i]), sd = sinf(ent_dir[i]);
        const float msd = -sd;
        // box frame: ax_x = (cd, 0, -sd), ax_z = (sd, 0, cd)
        const float rx = ox - px, ry = oy - py, rz = oz - pz;
        const float olx = rx * cd + ry * 0.0f + rz * msd;
        const float olz = rx * sd + ry * 0.0f + rz * cd;
        ent[F_FLAGS * E + e] = (float)flags[i];
        ent[F_AXX0 * E + e] = cd;
        ent[F_AXX2 * E + e] = msd;
        ent[F_AXZ0 * E + e] = sd;
        ent[F_AXZ2 * E + e] = cd;
        ent[F_DX_A * E + e] = cd * f0 + 0.0f * f1 + msd * f2;
        ent[F_DX_B * E + e] = cd * r0 + 0.0f * r1 + msd * r2;
        ent[F_DX_C * E + e] = cd * u0 + 0.0f * u1 + msd * u2;
        ent[F_DZ_A * E + e] = sd * f0 + 0.0f * f1 + cd * f2;
        ent[F_DZ_B * E + e] = sd * r0 + 0.0f * r1 + cd * r2;
        ent[F_DZ_C * E + e] = sd * u0 + 0.0f * u1 + cd * u2;
        const float sx = ent_size[3 * i], sy = ent_size[3 * i + 1], sz = ent_size[3 * i + 2];
        ent[F_LO0 * E + e] = -sx * 0.5f - olx;
        ent[F_LO1 * E + e] = 0.0f - ry;
        ent[F_LO2 * E + e] = -sz * 0.5f - olz;
        ent[F_HI0 * E + e] = sx * 0.5f - olx;
        ent[F_HI1 * E + e] = sy - ry;
        ent[F_HI2 * E + e] = sz * 0.5f - olz;
        // sphere: center = pos + (0, h/2, 0), radius h/2
        const float r_vis = 0.5f * h;
        const float oc0 = ox - (px + 0.0f), oc1 = oy - (py + 0.5f * h), oc2 = oz - (pz + 0.0f);
        ent[F_OC0 * E + e] = oc0;
        ent[F_OC1 * E + e] = oc1;
        ent[F_OC2 * E + e] = oc2;
        ent[F_OC_A * E + e] = oc0 * f0 + oc1 * f1 + oc2 * f2;
        ent[F_OC_B * E + e] = oc0 * r0 + oc1 * r1 + oc2 * r2;
        ent[F_OC_C * E + e] = oc0 * u0 + oc1 * u1 + oc2 * u2;
        ent[F_CC * E + e] = (oc0 * oc0 + oc1 * oc1 + oc2 * oc2) - r_vis * r_vis;
        ent[F_INV_RV * E + e] = 1.0f / fmaxf(r_vis, 1e-9f);
    }
    __syncthreads();

    const int hw = W * H;
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= hw) return;
    const float xv = xbase[p % W] * tan_xy[2 * b];
    const float yv = ybase[p / W] * tan_xy[2 * b + 1];
    const float near_ = 0.04f, far_ = 100.0f;
    const float a_px = 1.0f + xv * xv + yv * yv;
    const float d0 = f0 + xv * r0 + yv * u0;
    const float d1 = f1 + xv * r1 + yv * u1;
    const float d2 = f2 + xv * r2 + yv * u2;

    int best = 0;
    float bn0 = 0.0f, bn1 = 0.0f, bn2 = 0.0f;
    for (int e = 0; e < E; ++e) {
        const int fl = (int)ent[F_FLAGS * E + e];
        const bool sphere = (fl & ENT_SPHERE) != 0;
        float t_sph = INFINITY, t_in = INFINITY;
        bool sph_hit = false, box_hit = false;
        float dl0 = 0.0f, dl2 = 0.0f, tl0 = 0.0f, tl1 = 0.0f, tl2 = 0.0f;
        if (has_sphere) {
            const float bq = 2.0f * (ent[F_OC_A * E + e] + ent[F_OC_B * E + e] * xv +
                                     ent[F_OC_C * E + e] * yv);
            const float disc = bq * bq - (4.0f * ent[F_CC * E + e]) * a_px;
            const float sq = sqrtf(fmaxf(disc, 0.0f));
            t_sph = (-bq - sq) / (2.0f * a_px);
            sph_hit = disc > 0.0f && t_sph > near_ && t_sph < far_;
        }
        if (has_box) {
            dl0 = ent[F_DX_A * E + e] + ent[F_DX_B * E + e] * xv + ent[F_DX_C * E + e] * yv;
            dl2 = ent[F_DZ_A * E + e] + ent[F_DZ_B * E + e] * xv + ent[F_DZ_C * E + e] * yv;
            const float dls[3] = {dl0, d1, dl2};
            float tlo[3], thi[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const float dk = dls[k];
                const float inv = 1.0f / (fabsf(dk) < 1e-9f ? 1e-9f : dk);
                const float t1 = ent[(F_LO0 + k) * E + e] * inv;
                const float t2 = ent[(F_HI0 + k) * E + e] * inv;
                tlo[k] = fminf(t1, t2);
                thi[k] = fmaxf(t1, t2);
            }
            t_in = fmaxf(fmaxf(tlo[0], tlo[1]), tlo[2]);
            const float t_out_ = fminf(fminf(thi[0], thi[1]), thi[2]);
            box_hit = t_in <= t_out_ && t_in > near_ && t_in < far_;
            tl0 = tlo[0]; tl1 = tlo[1]; tl2 = tlo[2];
        }
        const float t_e = sphere ? t_sph : t_in;
        const bool hit_e = (fl & ENT_ACTIVE) &&
                           (sphere ? sph_hit : (box_hit && (fl & ENT_BOX)));
        const float r_e = hit_e ? 1.0f / fmaxf(t_e, 1e-30f) : 0.0f;
        const int key = (hit_e && r_e > 0.0f) ? ((__float_as_int(r_e) & ~IDX_MASK) | e) : 0;
        if (key > best) {  // keys are unique per slot: the max is the winner
            best = key;
            if (has_sphere && (sphere || !has_box)) {
                const float t_s = sph_hit ? t_sph : 0.0f;
                const float inv_rv = ent[F_INV_RV * E + e];
                bn0 = (ent[F_OC0 * E + e] + t_s * d0) * inv_rv;
                bn1 = (ent[F_OC1 * E + e] + t_s * d1) * inv_rv;
                bn2 = (ent[F_OC2 * E + e] + t_s * d2) * inv_rv;
            } else {
                float s0 = tl0 == t_in ? 1.0f : 0.0f;
                float s1 = tl1 == t_in ? 1.0f : 0.0f;
                float s2 = tl2 == t_in ? 1.0f : 0.0f;
                const float norm = 1.0f / fmaxf(s0 + s1 + s2, 1.0f);
                s0 = s0 * norm; s1 = s1 * norm; s2 = s2 * norm;
                const float sg = -signf_(s0 * dl0 + s1 * d1 + s2 * dl2);
                bn0 = sg * (s0 * ent[F_AXX0 * E + e] + s2 * ent[F_AXZ0 * E + e]);
                bn1 = sg * s1;
                bn2 = sg * (s0 * ent[F_AXX2 * E + e] + s2 * ent[F_AXZ2 * E + e]);
            }
        }
    }

    const size_t q = (size_t)b * hw + p;
    if (best > 0) {
        const int w = b * E + (best & IDX_MASK);
        t_out[q] = 1.0f / fmaxf(__int_as_float(best & ~IDX_MASK), 1e-30f);
        col_out[3 * q] = ent_color[3 * w];
        col_out[3 * q + 1] = ent_color[3 * w + 1];
        col_out[3 * q + 2] = ent_color[3 * w + 2];
    } else {
        t_out[q] = INFINITY;
        col_out[3 * q] = col_out[3 * q + 1] = col_out[3 * q + 2] = 0.0f;
    }
    n_out[3 * q] = bn0;
    n_out[3 * q + 1] = bn1;
    n_out[3 * q + 2] = bn2;
}

extern "C" int mw_entity_pass(
    const float* ent_pos, const float* ent_size, const float* ent_dir,
    const float* ent_height, const float* ent_color, const unsigned char* flags,
    const float* origin, const float* fwd, const float* right, const float* up,
    const float* tan_xy, const float* xbase, const float* ybase,
    int B, int E, int W, int H, int has_sphere, int has_box,
    float* t_out, float* col_out, float* n_out, cudaStream_t stream)
{
    const int threads = 256;
    const dim3 grid((W * H + threads - 1) / threads, B);
    const size_t smem = (size_t)F_COUNT * E * sizeof(float);
    entity_pass_kernel<<<grid, threads, smem, stream>>>(
        ent_pos, ent_size, ent_dir, ent_height, ent_color, flags, origin, fwd,
        right, up, tan_xy, xbase, ybase, E, W, H, has_sphere, has_box,
        t_out, col_out, n_out);
    return (int)cudaGetLastError();
}

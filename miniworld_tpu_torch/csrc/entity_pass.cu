// Analytic sphere and box entities: keyed-z winner, its color and normal.
//
// Replaces: miniworld_tpu/render/raycast.py:_entity_pass, an XLA-fused
// jnp stage in the JAX package. The plain PyTorch version is
// entity_pass_plain in miniworld_tpu_torch/render/raycast.py; with
// -fmad=false the arithmetic below matches it operation by operation.
//
// Contract. t (B, HW) is written at every sample, inf where no entity is
// hit. Colour and normal (B, HW, 3) are defined only where t is finite,
// and the kernel writes them only there: elsewhere they hold whatever
// the caller's buffer held (the wrapper allocates them with torch.empty).
// Their one reader, the pixel epilogue, reads them only where the entity
// is strictly closer than the static hit, so where t is finite.
//
// What bounds it on an H100: the bytes it must write, 4 of t at every
// sample plus 24 of colour and normal at each sample an entity covers
// (157 MB at an 8x8 maze's B = 8192, 80x60, where one goal box covers a
// few per cent of the samples: 0.05 ms at 3.35 TB/s). The operations, a
// slab or sphere test per (sample, entity) pair, are below that even if
// every pair is tested, and the cull below tests only the pairs of
// tiles the entity may cover.
//
// Design. A block owns one env. Its threads first stage, once an env,
// in shared memory: each entity slot's constants (box frame, origin in
// the box frame, slab offsets, sphere centre offset, the basis dots of
// the separable rays, and the cull's bounding sphere in camera
// coordinates), each column's xv and each row's yv, and the cull below
// split by axis: per column of TILE_W x TILE_H screen tiles a bit mask of
// the slots its two x planes keep, per row of tiles the mask its two y
// planes keep (both also drop the dead slots and those nearer than the near
// plane). A tile's survivors are its column's mask AND its row's. Then
// the block's warps loop over the env's tiles, a warp a tile. A tile
// with no survivor (most of them: a maze's one goal box is in few
// views) writes t = inf, a float4 a lane, and nothing else. Otherwise
// the warp walks the tile in passes of 16 x 2 samples, one sample a
// lane, and each sample runs the sphere and slab tests only for the
// survivors, in slot order, keeping the keyed-z maximum (bits(1/t) &
// ~0x3FF) | e and the winner's normal (sphere: (oc + t d) / r; box:
// entry-slab normal, split evenly over tied slabs, sign(0) = 0). The key
// is unique per slot, so the winner does not depend on which slots were
// skipped, as long as a skipped slot has key 0 at every sample of the
// tile. A pass stores t as two contiguous 64-byte rows; colour and
// normal, rows of 12 bytes that are only 4-byte aligned, go out as
// scalar stores at the hit samples. One sample a lane keeps few values
// live across the divisions' slow-path calls, so nothing spills.
//
// The cull. Let o be the eye, (f, r, u) the camera basis, and the ray of
// a sample D = f + xv r + yv u (xv, yv as the kernel computes them). A
// tile's rays have xv in [xlo, xhi] and yv in [ylo, yhi], the min and
// max of the computed values over its columns and rows (no order of
// xbase or ybase is assumed). A point q = o + t D with t > 0 of
// such a ray satisfies, for the orthonormal basis,
//   (q - o).r - xhi (q - o).f <= 0,   xlo (q - o).f - (q - o).r <= 0,
//   (q - o).u - yhi (q - o).f <= 0,   ylo (q - o).f - (q - o).u <= 0,
// and (q - o).f = t (D.f) = t. A slot is culled when its bounding sphere
// (centre C, radius R: the sphere itself, or the box's half-diagonal
// around its centre pos + (0, sy / 2, 0)), grown to rho = R + m, lies
// wholly outside one of those half-spaces or wholly nearer the eye than
// the plane (q - o).f = NEAR / 2:
//   Cr - xhi Cf > rho sqrt(1 + xhi^2)  (and the three others alike), or
//   Cf + rho < NEAR / 2,
// with (Cf, Cr, Cu) = (C - o) in camera coordinates; the margin is
// m = 2^-6 (|C - o| + R). Why m covers the kernel's rounding (u = 2^-24;
// the camera basis orthonormal to a few u, as camera_grid's is):
// - Sphere: the computed disc > 0 holds only where the exact one is
//   >= -E with E <= 4 |D|^2 (|oc|^2 + r^2) 60 u (the rounding of bq, cc,
//   a_px = 1 + xv^2 + yv^2 against |D|^2, and the products), so the
//   ray's line passes within sqrt(r^2 + 60 u (|oc|^2 + r^2)) <= r +
//   2^-9 (|oc| + r) of the centre. The closest point is in front: the
//   computed t_sph <= -bq / (2 a_px) (monotone rounding), so t_sph > NEAR
//   puts it at t >= NEAR (1 - 20 u) - 20 u |oc|.
// - Box: each computed slab bound t1 = (lo - o_l) (1 / d_k) is the exact
//   crossing of a plane moved by <= 6 u (|o - pos| + size) along a ray
//   whose local direction differs from D's by <= 30 u |D| (the dots
//   d_k, the 1e-9 floor of |d_k|), to a relative 3 u; a computed t_in <=
//   t_out with t_in in (NEAR, FAR) therefore puts the sample's ray, at
//   t = t_in (1 +- 3 u), within 50 u (|C - o| + R) of the box, inside
//   its bounding sphere (the frame from cosf / sinf is orthonormal to
//   4 u).
// So every slot the kernel's arithmetic hits at a sample of the tile has
// a point of that sample's ray, at t >= NEAR / 2, within R + 2^-8 (|C -
// o| + R) of C; the computed (Cf, Cr, Cu), |C - o| and the products of
// the tests are within 10 u (|C - o| + R) (1 + |x|) of the exact ones.
// Both fit with room inside m / 2 = 2^-7 (|C - o| + R), so a culled slot
// has key 0 at every sample of the tile and the output is the full
// scan's, bit for bit. A NaN fails every comparison, so it never culls.

#include <cuda_runtime.h>
#include <math.h>

#define IDX_MASK 0x3FF
#define ENT_ACTIVE 1
#define ENT_SPHERE 2
#define ENT_BOX 4
#define TILE_W 16     // a tile: 16 x 8 samples, a warp's
#define TILE_H 8
#define PASS_ROWS 2   // a pass: 16 x 2 samples, one a lane
#define WARPS 8       // most warps a block (one env a block)
#define MAX_ENTS 256  // slots a block stages (the wrapper raises above)
#define NEAR_ 0.04f
#define FAR_ 100.0f
#define CULL_MARGIN 0.015625f  // 2^-6

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
    F_CF, F_CR, F_CU,                // cull: bounding centre - origin, camera basis
    F_RHO,                           // cull: grown radius; -1 = the slot never hits
    F_COUNT
};

__device__ __forceinline__ float signf_(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Slot e at one sample, as entity_pass_plain computes it: the sphere
// and slab tests, and where its key beats ``best`` the key and normal.
__device__ __forceinline__ void test_slot(
    const float* __restrict__ ent, int E, int e, int has_sphere, int has_box,
    float xv, float yv, float a_px, float d0, float d1, float d2,
    int& best, float& bn0, float& bn1, float& bn2)
{
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
        sph_hit = disc > 0.0f && t_sph > NEAR_ && t_sph < FAR_;
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
        box_hit = t_in <= t_out_ && t_in > NEAR_ && t_in < FAR_;
        tl0 = tlo[0]; tl1 = tlo[1]; tl2 = tlo[2];
    }
    const float t_e = sphere ? t_sph : t_in;
    const bool hit_e = (fl & ENT_ACTIVE) && (sphere ? sph_hit : (box_hit && (fl & ENT_BOX)));
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

__global__ void __launch_bounds__(WARPS * 32) entity_pass_kernel(
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
    // per tile column and tile row (lo, hi, sqrt(1 + lo^2), sqrt(1 + hi^2))
    // of its xv or yv; the slots' constants (F_COUNT x E), xv per column,
    // yv per row; per tile column and row the masks of the slots it keeps
    // (ceil(E / 32) words each)
    extern __shared__ float4 lines[];
    const int ntx = (W + TILE_W - 1) / TILE_W, nty = (H + TILE_H - 1) / TILE_H;
    const int groups = (E + 31) / 32;
    float* ent = reinterpret_cast<float*>(lines + ntx + nty);
    float* xs = ent + F_COUNT * E;
    float* ys = xs + W;
    unsigned* keep = reinterpret_cast<unsigned*>(ys + H);
    const int b = blockIdx.x, tid = threadIdx.x;
    const float ox = origin[3 * b], oy = origin[3 * b + 1], oz = origin[3 * b + 2];
    const float f0 = fwd[3 * b], f1 = fwd[3 * b + 1], f2 = fwd[3 * b + 2];
    const float r0 = right[3 * b], r1 = right[3 * b + 1], r2 = right[3 * b + 2];
    const float u0 = up[3 * b], u1 = up[3 * b + 1], u2 = up[3 * b + 2];
    const float tan_x = tan_xy[2 * b], tan_y = tan_xy[2 * b + 1];

    for (int i = tid; i < W; i += blockDim.x) xs[i] = xbase[i] * tan_x;
    for (int i = tid; i < H; i += blockDim.x) ys[i] = ybase[i] * tan_y;
    for (int c = tid; c < ntx + nty; c += blockDim.x) {  // from the inputs, not xs / ys
        const bool col = c < ntx;
        const float* base = col ? xbase : ybase;
        const float tan_ = col ? tan_x : tan_y;
        const int i0 = col ? c * TILE_W : (c - ntx) * TILE_H;
        const int n = col ? min(TILE_W, W - i0) : min(TILE_H, H - i0);
        float lo = INFINITY, hi = -INFINITY;
#pragma unroll
        for (int j = 0; j < TILE_W; ++j) {
            if (j < n) {
                const float v = base[i0 + j] * tan_;
                lo = fminf(lo, v);
                hi = fmaxf(hi, v);
            }
        }
        lines[c] = make_float4(lo, hi, sqrtf(1.0f + lo * lo), sqrtf(1.0f + hi * hi));
    }
    for (int e = tid; e < E; e += blockDim.x) {
        const int i = b * E + e;
        const float px = ent_pos[3 * i], py = ent_pos[3 * i + 1], pz = ent_pos[3 * i + 2];
        const float h = ent_height[i];
        const float cd = cosf(ent_dir[i]), sd = sinf(ent_dir[i]);
        const float msd = -sd;
        // box frame: ax_x = (cd, 0, -sd), ax_z = (sd, 0, cd)
        const float rx = ox - px, ry = oy - py, rz = oz - pz;
        const float olx = rx * cd + ry * 0.0f + rz * msd;
        const float olz = rx * sd + ry * 0.0f + rz * cd;
        const int fl = flags[i];
        ent[F_FLAGS * E + e] = (float)fl;
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
        // the cull's bounding sphere of the shape this slot is tested as
        const bool sphere = (fl & ENT_SPHERE) != 0;
        const bool live = (fl & ENT_ACTIVE) &&
                          (sphere ? has_sphere != 0 : (has_box && (fl & ENT_BOX)));
        const float cy = sphere ? 0.5f * h : 0.5f * sy;
        const float rad = sphere ? fabsf(r_vis) : 0.5f * sqrtf(sx * sx + sy * sy + sz * sz);
        const float c0 = px - ox, c1 = (py + cy) - oy, c2 = pz - oz;
        ent[F_CF * E + e] = c0 * f0 + c1 * f1 + c2 * f2;
        ent[F_CR * E + e] = c0 * r0 + c1 * r1 + c2 * r2;
        ent[F_CU * E + e] = c0 * u0 + c1 * u1 + c2 * u2;
        const float dist = sqrtf(c0 * c0 + c1 * c1 + c2 * c2);
        ent[F_RHO * E + e] = live ? rad + CULL_MARGIN * (dist + rad) : -1.0f;
    }
    __syncthreads();
    // the cull's side planes split by axis: a tile keeps a slot where its
    // column and its row both keep it (each also drops the dead slots and
    // those nearer the eye than the plane NEAR / 2)
    for (int c = tid; c < ntx + nty; c += blockDim.x) {
        const bool col = c < ntx;
        const float4 line = lines[c];
        const float lo = line.x, hi = line.y, n_lo = line.z, n_hi = line.w;
        const float* side = ent + (col ? F_CR : F_CU) * E;
        for (int g = 0; g < groups; ++g) {
            unsigned m = 0u;
            for (int j = 0; j < 32 && g * 32 + j < E; ++j) {
                const int e = g * 32 + j;
                const float cf = ent[F_CF * E + e], cs = side[e], rho = ent[F_RHO * E + e];
                const bool out = (cs - hi * cf > rho * n_hi) || (lo * cf - cs > rho * n_lo) ||
                                 (cf + rho < 0.5f * NEAR_);
                m |= (!(rho < 0.0f) && !out) ? 1u << j : 0u;
            }
            keep[c * groups + g] = m;
        }
    }
    __syncthreads();

    const int warp = tid >> 5, lane = tid & 31;
    const int hw = W * H;
    float* t_env = t_out + (size_t)b * hw;
    const bool vec4 = (W & 3) == 0;
    for (int tile = warp; tile < ntx * nty; tile += blockDim.x >> 5) {
        const int ty = tile / ntx, tx = tile - ty * ntx;
        const unsigned* kx = keep + tx * groups;
        const unsigned* ky = keep + (ntx + ty) * groups;
        unsigned any = 0u;
        for (int g = 0; g < groups; ++g) any |= kx[g] & ky[g];
        if (!any) {  // no survivor: t = inf, 4 samples of a row a lane
            const int y = ty * TILE_H + (lane >> 2), x = tx * TILE_W + (lane & 3) * 4;
            if (y < H && x < W) {
                float* dst = t_env + y * W + x;
                if (vec4) {
                    *reinterpret_cast<float4*>(dst) =
                        make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
                } else {
                    for (int k = 0; k < 4 && x + k < W; ++k) dst[k] = INFINITY;
                }
            }
            continue;
        }
        const int x = tx * TILE_W + (lane & (TILE_W - 1));
        for (int pass = 0; pass < TILE_H / PASS_ROWS; ++pass) {
            const int y = ty * TILE_H + pass * PASS_ROWS + lane / TILE_W;
            if (x >= W || y >= H) continue;
            const float xv = xs[x], yv = ys[y];
            const float a_px = 1.0f + xv * xv + yv * yv;
            const float d0 = f0 + xv * r0 + yv * u0;
            const float d1 = f1 + xv * r1 + yv * u1;
            const float d2 = f2 + xv * r2 + yv * u2;
            int best = 0;
            float bn0 = 0.0f, bn1 = 0.0f, bn2 = 0.0f;
            for (int g = 0; g < groups; ++g) {
                unsigned m = kx[g] & ky[g];
                while (m) {
                    const int e = g * 32 + __ffs(m) - 1;
                    m &= m - 1;
                    test_slot(ent, E, e, has_sphere, has_box, xv, yv, a_px, d0, d1, d2,
                              best, bn0, bn1, bn2);
                }
            }
            const int p = y * W + x;
            t_env[p] = best > 0 ? 1.0f / fmaxf(__int_as_float(best & ~IDX_MASK), 1e-30f)
                                : INFINITY;
            if (best > 0) {
                const size_t q = (size_t)b * hw + p;
                const int w = b * E + (best & IDX_MASK);
                col_out[3 * q] = ent_color[3 * w];
                col_out[3 * q + 1] = ent_color[3 * w + 1];
                col_out[3 * q + 2] = ent_color[3 * w + 2];
                n_out[3 * q] = bn0;
                n_out[3 * q + 1] = bn1;
                n_out[3 * q + 2] = bn2;
            }
        }
    }
}

extern "C" int mw_entity_pass(
    const float* ent_pos, const float* ent_size, const float* ent_dir,
    const float* ent_height, const float* ent_color, const unsigned char* flags,
    const float* origin, const float* fwd, const float* right, const float* up,
    const float* tan_xy, const float* xbase, const float* ybase,
    int B, int E, int W, int H, int has_sphere, int has_box,
    float* t_out, float* col_out, float* n_out, cudaStream_t stream)
{
    if (E < 0 || E > MAX_ENTS) return (int)cudaErrorInvalidValue;
    if (B == 0 || W * H == 0) return 0;
    const int ntx = (W + TILE_W - 1) / TILE_W, nty = (H + TILE_H - 1) / TILE_H;
    const size_t smem = (ntx + nty) * sizeof(float4) +
                        ((size_t)F_COUNT * E + W + H + (ntx + nty) * ((E + 31) / 32)) * 4;
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    // an env's tiles over 4 warps below 10 tiles a warp of 8 (80x60: 40
    // tiles), over 8 above (160x120: 150)
    const int warps = ntx * nty < 10 * WARPS ? WARPS / 2 : WARPS;
    entity_pass_kernel<<<B, warps * 32, smem, stream>>>(
        ent_pos, ent_size, ent_dir, ent_height, ent_color, flags, origin, fwd,
        right, up, tan_xy, xbase, ybase, E, W, H, has_sphere, has_box,
        t_out, col_out, n_out);
    return (int)cudaGetLastError();
}

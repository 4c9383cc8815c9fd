// Top-view epilogue: entity footprints, uv, texel, lighting, sky, the
// agent marker, u8 pack and depth.
//
// Replaces: miniworld_tpu/render/topview.py:render_top_view after the
// scan (:88-151: uv from the winner's affine map, eval_fourier with no
// footprint or eval_nearest through tex_map, the entity-vs-prim select,
// shade, the sky, the red agent triangle, the u8 pack, depth t_safe) and
// its entity loop _entity_pass_ortho (:244-299), XLA-fused jnp work in
// the JAX package. The plain PyTorch versions are topview_epilogue_plain
// and entity_pass_ortho_plain in miniworld_tpu_torch/render/topview.py;
// with -fmad=false the arithmetic below matches them operation by
// operation. The texel and the lighting are texel.cuh's, which the agent
// view's pixel_epilogue.cu shares: the Fourier texel with a footprint of
// exactly 0, whose attenuation 1 / (1 + 0) is 1 and glyph width w0, is
// eval_fourier without one.
//
// What bounds it on an H100: bytes. Per pixel it reads t and the row
// index (8 bytes) and the winner's float32 row (64, from the bank: L2
// hits, since a layout's few upward rows cover every env) and writes 3 +
// 4: at the 8x8 procgen maze's B = 8192, 80x60, 0.61 GB counting each
// input once (a bank row once, not per pixel), 0.18 ms at 3.35 TB/s.
// The Fourier texel's 16 terms (about 40 operations each) put its
// operation count at 2.5e10, 0.37 ms at the float32 rate: so a textured
// pixel is bound by operations.
//
// Design: one thread per (env, pixel), 256-thread blocks over a grid
// stride. The thread loops over the env's entity slots (at most 18,
// a handful of loads each, L1-resident across the block: a block is one
// env's pixels), keeping the strictly nearest footprint at t = 10 -
// height; reads the winner's row with four 16-byte loads; computes the
// texel from the per-slot fourier_table read through L1 (it is a few KB
// for the ported envs; Sign's 181 KB K = 64 table too) or the nearest
// texel; shades; and draws the marker from its three vertices, which the
// wrapper computes once per env with the same cos and sin as the plain
// version.

#include "texel.cuh"

#define ATTR_DIM 16
#define THREADS 256
#define TOP_CAM_HEIGHT 10.0f
#define ORTHO_ACTIVE 1
#define ORTHO_SPHERE 2

template <bool NEAREST, bool GAIN>
__global__ void __launch_bounds__(THREADS) topview_epilogue_kernel(
    const float* __restrict__ t_tri,       // (B, HW)
    const int* __restrict__ row,           // (B, HW), -1 = no prim
    const float4* __restrict__ bank_attr,  // (L, S, 16) f32
    const int* __restrict__ layout_id,     // (B,)
    const float* __restrict__ xs,          // (L, W)
    const float* __restrict__ zs,          // (L, H)
    const float* __restrict__ ent_pos,     // (B, E, 3)
    const float* __restrict__ ent_size,    // (B, E, 3)
    const float* __restrict__ ent_height,  // (B, E)
    const float* __restrict__ ent_color,   // (B, E, 3)
    const float* __restrict__ ent_cs,      // (B, E, 2) cos, sin of ent_dir
    const unsigned char* __restrict__ flags,  // (B, E)
    const float* __restrict__ table,       // (A, 4 + 9K) fourier_table; null (NEAREST)
    const uint8_t* __restrict__ atlas,     // (A, R, R, 3) u8, NEAREST only
    const int* __restrict__ tex_map,       // (B, T), NEAREST only
    const float* __restrict__ lights,      // (B, 4, 3): pos, color, ambient, sky
    const float* __restrict__ marker,      // (B, 6) or null
    int B, int W, int H, int S, int E, int A, int K, int T, int R,
    uint8_t* __restrict__ rgb_out,         // (B, H, W, 3)
    float* __restrict__ depth_out)         // (B, H, W, 1)
{
    const int hw = W * H;
    const long long n = (long long)B * hw;
    for (long long q = (long long)blockIdx.x * THREADS + threadIdx.x; q < n;
         q += (long long)gridDim.x * THREADS) {
        const int b = (int)(q / hw);
        const int p = (int)(q - (long long)b * hw);
        const int l = layout_id[b];
        const float px = xs[(size_t)l * W + p % W];
        const float pz = zs[(size_t)l * H + p / W];

        // entity footprints at their top surface; the strictly nearest wins
        float te = INFINITY;
        float ecol[3] = {0.0f, 0.0f, 0.0f};
        for (int e = 0; e < E; ++e) {
            const size_t k = (size_t)b * E + e;
            const unsigned char f = flags[k];
            if (!(f & ORTHO_ACTIVE)) continue;
            const float dx = px - ent_pos[3 * k];
            const float dz = pz - ent_pos[3 * k + 2];
            const float height = ent_height[k];
            bool hit;
            if (f & ORTHO_SPHERE) {
                const float r_vis = 0.5f * height;
                hit = dx * dx + dz * dz <= r_vis * r_vis;
            } else {
                const float cd = ent_cs[2 * k], sd = ent_cs[2 * k + 1];
                const float lx = dx * cd - dz * sd;
                const float lz = dx * sd + dz * cd;
                hit = fabsf(lx) <= ent_size[3 * k] * 0.5f && fabsf(lz) <= ent_size[3 * k + 2] * 0.5f;
            }
            const float t_e = TOP_CAM_HEIGHT - height;
            if (hit && t_e < te) {
                te = t_e;
#pragma unroll
                for (int i = 0; i < 3; ++i) ecol[i] = ent_color[3 * k + i];
            }
        }

        // the winning prim's float32 row: uv at the hit point, the texel
        const float tt = t_tri[q];
        const int r = row[q];
        float col[3] = {0.0f, 0.0f, 0.0f}, nrm[3] = {0.0f, 0.0f, 0.0f};
        if (r >= 0) {
            float at[ATTR_DIM];
            const float4* src = bank_attr + ((size_t)l * S + r) * (ATTR_DIM / 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 v = src[i];
                at[4 * i] = v.x;
                at[4 * i + 1] = v.y;
                at[4 * i + 2] = v.z;
                at[4 * i + 3] = v.w;
            }
            const float t_uv = isfinite(tt) ? tt : 0.0f;
            const float h0 = px + t_uv * 0.0f, h1 = TOP_CAM_HEIGHT + t_uv * -1.0f,
                        h2 = pz + t_uv * 0.0f;
            const float uu = at[0] * h0 + at[1] * h1 + at[2] * h2 + at[6];
            const float vv = at[3] * h0 + at[4] * h1 + at[5] * h2 + at[7];
            float tex[3];
            const int slot = (int)rintf(at[14]);
            if (slot < 0) {
                tex[0] = tex[1] = tex[2] = 1.0f;  // flat white
            } else if (NEAREST) {
                nearest_texel(b, slot, uu, vv, atlas, tex_map, T, R, A, tex);
            } else if (slot >= A) {
                tex[0] = tex[1] = tex[2] = 0.0f;  // no such row: black, as in the JAX one-hot
            } else {
                fourier_texel<GAIN>(table + (size_t)slot * (4 + 9 * K), K, uu, vv, 0.0f, tex);
            }
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                col[i] = at[11 + i] * tex[i];
                nrm[i] = at[8 + i];
            }
        }

        float t_hit = tt;
        if (te < tt) {  // an entity strictly nearer
            t_hit = te;
#pragma unroll
            for (int i = 0; i < 3; ++i) col[i] = ecol[i];
            nrm[0] = 0.0f;
            nrm[1] = 1.0f;
            nrm[2] = 0.0f;
        }
        const bool hit = isfinite(t_hit);
        const float t_safe = hit ? t_hit : 100.0f;  // FAR
        const float* lt = lights + (size_t)b * 12;
        float rgb[3];
        if (hit) {
            const float hp[3] = {px + t_safe * 0.0f, TOP_CAM_HEIGHT + t_safe * -1.0f,
                                 pz + t_safe * 0.0f};
            shade_hit(lt, col, nrm, hp, rgb);
        } else {
#pragma unroll
            for (int i = 0; i < 3; ++i) rgb[i] = lt[9 + i];
        }
        if (marker != nullptr) {  // the agent triangle, either winding, edges included
            const float* m = marker + (size_t)b * 6;
            float ed[3];
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                const int a = j, c = (j + 1) % 3;
                ed[j] = (px - m[2 * a]) * (m[2 * c + 1] - m[2 * a + 1])
                        - (pz - m[2 * a + 1]) * (m[2 * c] - m[2 * a]);
            }
            if ((ed[0] >= 0.0f && ed[1] >= 0.0f && ed[2] >= 0.0f) ||
                (ed[0] <= 0.0f && ed[1] <= 0.0f && ed[2] <= 0.0f)) {
                rgb[0] = 1.0f;
                rgb[1] = rgb[2] = 0.0f;
            }
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            // truncating pack, as (rgb * 255).clip(0, 255).astype(uint8)
            rgb_out[3 * q + i] = (uint8_t)fminf(fmaxf(rgb[i] * 255.0f, 0.0f), 255.0f);
        }
        depth_out[q] = t_safe;
    }
}

extern "C" int mw_topview_epilogue(
    const float* t_tri, const int* row, const float* bank_attr, const int* layout_id,
    const float* xs, const float* zs, const float* ent_pos, const float* ent_size,
    const float* ent_height, const float* ent_color, const float* ent_cs,
    const unsigned char* flags, const float* table, const uint8_t* atlas, const int* tex_map,
    const float* lights, const float* marker, int B, int W, int H, int S, int E, int A, int K,
    int gain, int nearest, int T, int R, uint8_t* rgb_out, float* depth_out,
    cudaStream_t stream)
{
    static int n_sm = 0;
    if (nearest) {
        if (gain || atlas == nullptr || tex_map == nullptr || T <= 0 || R <= 0 || A <= 0)
            return (int)cudaErrorInvalidValue;
    } else if (table == nullptr || K <= 0 || K % 4 || A <= 0) {  // float4 table rows
        return (int)cudaErrorInvalidValue;
    }
    if (B < 0 || W <= 0 || H <= 0 || S <= 0 || E < 0) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    if (n_sm == 0) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
    }
    const long long blocks = ((long long)B * W * H + THREADS - 1) / THREADS;
    // 8 blocks of 256 threads fill an SM's 2048 threads
    const int grid = (int)(blocks < 8LL * n_sm ? blocks : 8LL * n_sm);
    const float4* attr4 = reinterpret_cast<const float4*>(bank_attr);
    auto kernel = nearest ? topview_epilogue_kernel<true, false>
                          : (gain ? topview_epilogue_kernel<false, true>
                                  : topview_epilogue_kernel<false, false>);
    kernel<<<grid, THREADS, 0, stream>>>(
        t_tri, row, attr4, layout_id, xs, zs, ent_pos, ent_size, ent_height, ent_color, ent_cs,
        flags, table, atlas, tex_map, lights, marker, B, W, H, S, E, A, K, T, R, rgb_out,
        depth_out);
    return (int)cudaGetLastError();
}

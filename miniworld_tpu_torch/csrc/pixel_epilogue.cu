// Per-pixel epilogue: uv, Fourier or nearest texel, entity merge, lighting,
// u8 pack.
//
// Replaces: the pixel stage of miniworld_tpu/render/raycast.py:render_rgbd
// (affine uv and footprint, eval_fourier with _cos_sin_turns, or
// eval_nearest, shade, the sky select and the truncating u8 / depth
// outputs), XLA-fused jnp work in the JAX package. The plain PyTorch
// version is pixel_epilogue_plain in
// miniworld_tpu_torch/render/raycast.py; with -fmad=false the
// arithmetic below matches it operation by operation, bf16 roundings
// included (the JAX package's texture dots take bf16 cos/sin and
// amplitudes and return bf16 sums; both ports round at those points).
//
// What bounds it on an H100: bytes for the byte-light instances, the
// issue rate for the Fourier ones. Per pixel it reads 4 + 32 (+ 28 with
// entities) bytes and writes 3 + 4: 71 bytes, 2.79 GB at an 8x8 maze's
// B = 8192, 80x60, or 0.83 ms at 3.35 TB/s (with SS = 2, per output pixel
// four samples' 36 (+ 28) bytes in and the same 7 out). A Fourier term
// is about 41 float operations (phase, turn-wrapped cos/sin polynomials,
// the anti-aliasing reciprocal, 6 amplitude products and sums), but the
// library is built with -fmad=false, so that each rounds as the plain
// version's, and they issue as separate instructions. In cuobjdump -sass
// of the SS = 2 instance's unrolled K = 16 loop a term is about 45
// instructions (21 FMUL, 17 FADD, 3 LDS, the paired bf16 conversion and
// its two unpacks, FRND, the reciprocal's MUFU.RCP and two FFMA, the
// denominator's max), at 64 registers and no spills (chip_smoke.py
// prints the count and the issue-rate floor it gives; PERF.md): a sample
// whose texel the result reads costs K times that in issue slots,
// whatever its bytes. The attenuation's 1 / (1 + pi2 f2 fp2) takes the
// division's fast path only (texel.cuh rcp_rn_fast, checked once a
// texel); the library's division spent ~13 more a term on its range test
// and the branch around its slow path.
//
// Design. The kernel reads the per-slot table of render/raycast.py
// fourier_table instead of the atlas: everything per (slot, term) that
// does not depend on the pixel — the bf16-rounded frequencies, DC terms
// and amplitudes and pi^2 (fu^2 + fv^2), which C's left-to-right
// pi2 * f2 * fp2 rounds first — is computed once per atlas, so the term
// loop reads two float4 and one float of the slot's row and makes no
// bf16 conversion but the paired one of c * att and s * att. The table is
// staged in shared memory once per block up to the 48 KB a block gets
// without opting in (TABLE_SMEM_MAX), and read through L1 by slot above
// it: staging Sign's 181 KB table leaves one block an SM and made its SS
// = 2 launch slower than the L1 route (PERF.md). Blocks of 256 threads
// walk their items with a grid stride, so a block stages the table once
// for many; each sample's 32-byte bf16 attribute row is two 16-byte
// loads.
//
// A sample computes its uv and texel only where the plain result reads
// its colour: a finite t_tri that no strictly closer entity beats
// (raycast.py:1246-1292). Elsewhere the colour is the entity's or the
// sky's, and the discarded texel never reached the output, so skipping
// it is exact; it saves the K terms at every sky sample (a miss carries
// zero attributes, slot 0, a valid row) and every entity sample. The
// attribute row is loaded beside t before that test, so that its latency
// does not follow t's (loaded behind the test, the SS = 1 instance was
// slower at the 8x8 maze than without the skip; PERF.md).
//
// supersample=2 (the SS = 2 kernel; raycast.py:1143-1160, 1294-1301):
// the hit passes ran on the 2W x 2H image of samples, and W, H here are
// that image's. One sample a thread: a warp takes 16 consecutive samples
// of a sample row and the 16 below them, 8 output pixels, so its loads
// are two runs. The lane of s00 (even, in the first half) adds the
// others' shaded float colours with three shuffles in row-major order,
// ((s00 + s01) + s10) + s11, the order XLA's reduce runs the JAX
// package's mean over the (2, 2) axes in, multiplies by 0.25 (its / 4,
// exact), clips, packs and writes the top-left sample's depth.
// pixel_epilogue_plain sums in the same order. K is a template parameter
// (16, 64 for Sign; other K take a runtime loop), so the term loop
// unrolls; one sample a thread keeps the body small, without the spills
// of the four-samples-a-thread design it replaces.

// Glyphs (the GAIN instances; raycast.py:656-724, Sign's K = 64 atlas):
// a table row's column 3 holds its bf16 gain. Where it is < 0 the row is
// a Fourier-SDF glyph whose channels are [sdf | ink | bg]: the edge
// half-width w0 = -1 / (2 min(gain, -1e-9)) texels, grown to (0.55 fp)
// * 256 under minification, thresholds the signed distance, s = clip(0.5
// + sdf / (2 w), 0, 1), and every channel becomes ink + (bg - ink) * s;
// where it is > 1 each channel moves away from its DC term, dc + (v -
// dc) * gain. XLA:CPU computes both multiply-adds as fused ones, so the
// kernel calls fmaf there (-fmad=false contracts nothing else) and
// raycast._fma rounds them once in the plain version. Atlases without a
// glyph row launch the instances without GAIN, whose code is the one
// they had before. Sign's K = 64 table, 78 rows of 580 floats (181 KB),
// is above TABLE_SMEM_MAX and read through L1.
//
// Nearest mode (the NEAREST instances; raycast.py:727-745, 1274-1275, the
// JAX package's bit-accurate texture path): the slot column holds the
// winner's layout-local slot id, which tex_map[b] (B, T) resolves to a row
// of the (N, R, R, 3) u8 atlas. Per pixel: the slot rounded half to even
// (rintf), one tex_map load, the fractional uv, the texel's column and its
// flipped row ((int) of frac * R, clamped to [0, R - 1]: fmaxf turns a NaN
// into 0, as XLA's conversion does), a 3-byte gather from the atlas, times
// 1/255; 1.0 where the slot is < 0. No footprint, no table. The atlas is
// 590 KB at the 8x8 maze's 3 rows and 15 MB at Sign's 78, so the gather
// hits the 50 MB L2. NEAREST excludes GAIN: the glyph branch is
// fourier-only. The F32 instances load the float32 attribute carry (the
// 8x8 procgen maze's 528 slot ids, raycast.py:512-528) with four 16-byte
// loads in place of the two of the bf16 row; fourier mode has them too
// (an atlas of more than 256 rows), at SS = 1 and 2, K = 16, 64 and a
// runtime K, with and without GAIN. A nearest pixel reads 4 + 64
// (F32) or 4 + 32 bytes of hit results and writes 7: with the F32 carry 75
// bytes, 2.95 GB at the 8x8 maze's B = 8192, 80x60, 0.88 ms at 3.35 TB/s.

#include "texel.cuh"

#define ATTR_DIM 16
#define THREADS 256
#define TABLE_SMEM_MAX (48 * 1024)

// One sample: the shaded colour (before the clip and the u8 pack) and
// the depth of sample p of env b in the W x H image of the hit passes;
// uv and texel only where the result reads them (header). KT: the Fourier
// terms, 0 for the runtime K.
template <bool GAIN, bool NEAREST, bool F32, int KT>
__device__ __forceinline__ float sample_rgb(
    const int b, const int p, const float* __restrict__ t_tri,
    const void* __restrict__ attr, const float* __restrict__ t_ent,
    const float* __restrict__ col_ent, const float* __restrict__ n_ent,
    const float* tab, const uint8_t* __restrict__ atlas, const int* __restrict__ tex_map,
    const int T, const int R, const float* __restrict__ lights,
    const float* __restrict__ origin,
    const float* __restrict__ fwd, const float* __restrict__ right,
    const float* __restrict__ up, const float* __restrict__ tan_xy,
    const float* __restrict__ xbase, const float* __restrict__ ybase, const int W,
    const int hw, const float pix_scale, const int A, const int K, const int has_ent,
    float* out)
{
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
    const float tt = t_tri[q];
    const float te = has_ent ? t_ent[q] : INFINITY;
    // the attribute row is loaded beside t, before the test that may skip
    // it: its latency overlaps t's instead of following it
    float at[ATTR_DIM];
    if (F32) {
        const float4* src = reinterpret_cast<const float4*>(attr) + q * (ATTR_DIM / 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float4 v = src[i];
            at[4 * i] = v.x;
            at[4 * i + 1] = v.y;
            at[4 * i + 2] = v.z;
            at[4 * i + 3] = v.w;
        }
    } else {
        const uint4* src = reinterpret_cast<const uint4*>(attr) + q * 2;
        unpack8(src[0], at);
        unpack8(src[1], at + 8);
    }
    const bool ent_wins = has_ent && te < tt;  // analytic entities win where strictly closer
    float col[3] = {0.0f, 0.0f, 0.0f}, nrm[3] = {0.0f, 0.0f, 0.0f};
    if (isfinite(tt) && !ent_wins) {
        // uv from the winner's affine map at the hit point; uv-space footprint
        const float t_uv = tt;  // finite here
        const float h0 = o[0] + t_uv * d[0], h1 = o[1] + t_uv * d[1], h2 = o[2] + t_uv * d[2];
        const float uu = at[0] * h0 + at[1] * h1 + at[2] * h2 + at[6];
        const float vv = at[3] * h0 + at[4] * h1 + at[5] * h2 + at[7];

        float tex[3];
        const int slot = (int)rintf(at[14]);
        if (NEAREST) {
            if (slot < 0) tex[0] = tex[1] = tex[2] = 1.0f;  // flat white
            else nearest_texel(b, slot, uu, vv, atlas, tex_map, T, R, A, tex);
        } else if (slot < 0) {
            // Fourier texel; table row: dc(3), 0 | (fu, fv, pi2 f2, A0) x K |
            // (A1, A2, B0, B1) x K | B2 x K
            tex[0] = tex[1] = tex[2] = 1.0f;  // flat white
        } else if (slot >= A) {
            tex[0] = tex[1] = tex[2] = 0.0f;  // no such row: black, as in the JAX one-hot
        } else {
            float sq = at[0] * at[0];
#pragma unroll
            for (int i = 1; i < 6; ++i) sq = sq + at[i] * at[i];
            const float pix_angle = tan_y * pix_scale;
            const float fp = t_uv * pix_angle * sqrtf(sq * 0.5f);
            if (KT > 0) fourier_texel_k<GAIN, KT>(tab + (size_t)slot * fourier_row(KT), uu, vv,
                                                  fp, tex);
            else fourier_texel<GAIN>(tab + (size_t)slot * fourier_row(K), K, uu, vv, fp, tex);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            col[i] = at[11 + i] * tex[i];
            nrm[i] = at[8 + i];
        }
    }
    float t_hit = tt;
    if (ent_wins) {
        t_hit = te;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            col[i] = col_ent[3 * q + i];
            nrm[i] = n_ent[3 * q + i];
        }
    }

    const bool hit = isfinite(t_hit);
    const float t_safe = hit ? t_hit : 100.0f;  // FAR
    const float* lt = lights + (size_t)b * 12;
    if (hit) {
        float hp[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) hp[i] = o[i] + t_safe * d[i];
        shade_hit(lt, col, nrm, hp, out);
    } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) out[i] = lt[9 + i];
    }
    return t_safe;
}

// The table to shared memory (kSmemTable), or read where it lies
template <bool kSmemTable>
__device__ __forceinline__ const float* stage_table(const float* table, const int n_floats) {
    if (!kSmemTable) return table;
    extern __shared__ float4 tab_smem[];
    const float4* src = reinterpret_cast<const float4*>(table);
    for (int i = threadIdx.x; i < n_floats / 4; i += THREADS) tab_smem[i] = src[i];
    __syncthreads();
    return reinterpret_cast<const float*>(tab_smem);
}

#define EPI_ARGS                                                                             \
    const float* __restrict__ t_tri,           /* (B, HW) */                                 \
    const void* __restrict__ attr,             /* (B, HW, 16) bf16, or f32 (F32) */          \
    const float* __restrict__ t_ent,           /* (B, HW) or null */                         \
    const float* __restrict__ col_ent,         /* (B, HW, 3) or null */                      \
    const float* __restrict__ n_ent,           /* (B, HW, 3) or null */                      \
    const float* __restrict__ table,           /* (A, fourier_row(K)); null (NEAREST) */     \
    const uint8_t* __restrict__ atlas,         /* (A, R, R, 3) u8, NEAREST only */           \
    const int* __restrict__ tex_map,           /* (B, T), NEAREST only */                    \
    const float* __restrict__ lights,          /* (B, 4, 3): pos, color, ambient, sky */     \
    const float* __restrict__ origin, const float* __restrict__ fwd,                        \
    const float* __restrict__ right, const float* __restrict__ up,                          \
    const float* __restrict__ tan_xy, const float* __restrict__ xbase,                      \
    const float* __restrict__ ybase,                                                        \
    int B, int W, int H, int A, int K, int has_ent, int T, int R,                           \
    uint8_t* __restrict__ rgb_out,             /* (B, H / SS, W / SS, 3) */                  \
    float* __restrict__ depth_out              /* (B, H / SS, W / SS, 1) */

#define SAMPLE_ARGS                                                                          \
    t_tri, attr, t_ent, col_ent, n_ent, tab, atlas, tex_map, T, R, lights, origin, fwd,     \
    right, up, tan_xy, xbase, ybase, W, W * H, (float)(2.0 / H), A, K, has_ent

// SS = 1: one thread a pixel. GAIN: the atlas has glyph rows. NEAREST:
// the nearest texel of the u8 atlas. F32: the float32 attribute carry.
template <bool kSmemTable, bool GAIN, bool NEAREST, bool F32>
__global__ void __launch_bounds__(THREADS) pixel_epilogue_kernel(EPI_ARGS)
{
    const float* tab = stage_table<kSmemTable>(table, A * fourier_row(K));
    const int hw = W * H;
    const int chunks = (hw + THREADS - 1) / THREADS;
    for (int item = blockIdx.x; item < B * chunks; item += gridDim.x) {
        const int b = item / chunks;
        const int p = (item - b * chunks) * THREADS + threadIdx.x;
        if (p >= hw) continue;
        float rgb[3];
        const float depth = sample_rgb<GAIN, NEAREST, F32, 0>(b, p, SAMPLE_ARGS, rgb);
        const size_t q = (size_t)b * hw + p;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            // truncating pack, as (rgb * 255).clip(0, 255).astype(uint8)
            rgb_out[3 * q + i] = (uint8_t)fminf(fmaxf(rgb[i] * 255.0f, 0.0f), 255.0f);
        }
        depth_out[q] = depth;
    }
}

// SS = 2: one sample a thread, a warp on 16 samples of two sample rows (8
// output pixels); W, H: the samples' image. KT as in sample_rgb.
template <bool kSmemTable, int KT, bool GAIN, bool NEAREST, bool F32>
__global__ void __launch_bounds__(THREADS) pixel_epilogue_ss2_kernel(EPI_ARGS)
{
    const float* tab = stage_table<kSmemTable>(table, A * fourier_row(K));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wo = W / 2, hwo = wo * (H / 2);
    const int runs_x = (W + 15) / 16;        // 16-sample runs of a sample row
    const int n_runs = (H / 2) * runs_x;     // (run, sample row pair) items of an env
    constexpr int WARPS = THREADS / 32;
    const int chunks = (n_runs + WARPS - 1) / WARPS;
    for (int item = blockIdx.x; item < B * chunks; item += gridDim.x) {
        const int b = item / chunks;
        const int run = (item - b * chunks) * WARPS + warp;
        if (run >= n_runs) continue;  // warp-uniform
        const int yo = run / runs_x;
        const int sx = (run - yo * runs_x) * 16 + (lane & 15);
        const int sy = 2 * yo + (lane >> 4);
        const bool valid = sx < W;  // W is even: a pixel's four lanes agree
        float rgb[3] = {0.0f, 0.0f, 0.0f};
        float depth = 0.0f;
        if (valid) depth = sample_rgb<GAIN, NEAREST, F32, KT>(b, sy * W + sx, SAMPLE_ARGS, rgb);
        // ((s00 + s01) + s10) + s11 at the lane of s00, then the mean's / 4
        float mean[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            float v = rgb[i] + __shfl_sync(0xffffffffu, rgb[i], (lane + 1) & 31);
            v = v + __shfl_sync(0xffffffffu, rgb[i], (lane + 16) & 31);
            v = v + __shfl_sync(0xffffffffu, rgb[i], (lane + 17) & 31);
            mean[i] = v * 0.25f;
        }
        if (valid && lane < 16 && (lane & 1) == 0) {
            const size_t qo = (size_t)b * hwo + (size_t)yo * wo + (sx >> 1);
#pragma unroll
            for (int i = 0; i < 3; ++i)
                rgb_out[3 * qo + i] = (uint8_t)fminf(fmaxf(mean[i] * 255.0f, 0.0f), 255.0f);
            depth_out[qo] = depth;
        }
    }
}

#define LAUNCH_ARGS                                                                          \
    t_tri, attr, t_ent, col_ent, n_ent, table, atlas, tex_map, lights, origin, fwd, right,  \
    up, tan_xy, xbase, ybase, B, W, H, A, K, has_ent, T, R, rgb_out, depth_out

template <bool kSmemTable, int SS, int KT, bool GAIN, bool NEAREST, bool F32>
static int launch_one(const int grid, const size_t smem, cudaStream_t stream, EPI_ARGS) {
    if constexpr (SS == 2)
        pixel_epilogue_ss2_kernel<kSmemTable, KT, GAIN, NEAREST, F32>
            <<<grid, THREADS, smem, stream>>>(LAUNCH_ARGS);
    else
        pixel_epilogue_kernel<kSmemTable, GAIN, NEAREST, F32>
            <<<grid, THREADS, smem, stream>>>(LAUNCH_ARGS);
    return (int)cudaGetLastError();
}

// Fourier mode: the table in shared memory up to TABLE_SMEM_MAX, read
// through L1 above; SS = 2 with K = 16 or 64 unrolled; F32: the float32
// attribute carry (an atlas of more than 256 rows, raycast.py:512-528),
// four 16-byte loads a sample in place of two, the texel the same code
template <int SS, bool GAIN, bool F32>
static int launch_fourier(const int grid, const size_t smem, cudaStream_t stream, EPI_ARGS) {
    const bool in_smem = smem <= (size_t)TABLE_SMEM_MAX;
    if constexpr (SS == 1)
        return in_smem ? launch_one<true, 1, 0, GAIN, false, F32>(grid, smem, stream, LAUNCH_ARGS)
                       : launch_one<false, 1, 0, GAIN, false, F32>(grid, 0, stream, LAUNCH_ARGS);
    if (K == 16)
        return in_smem ? launch_one<true, 2, 16, GAIN, false, F32>(grid, smem, stream, LAUNCH_ARGS)
                       : launch_one<false, 2, 16, GAIN, false, F32>(grid, 0, stream, LAUNCH_ARGS);
    if (K == 64)
        return in_smem ? launch_one<true, 2, 64, GAIN, false, F32>(grid, smem, stream, LAUNCH_ARGS)
                       : launch_one<false, 2, 64, GAIN, false, F32>(grid, 0, stream, LAUNCH_ARGS);
    return in_smem ? launch_one<true, 2, 0, GAIN, false, F32>(grid, smem, stream, LAUNCH_ARGS)
                   : launch_one<false, 2, 0, GAIN, false, F32>(grid, 0, stream, LAUNCH_ARGS);
}

template <int SS>
static int launch_fourier_any(const bool gain, const bool f32, const int grid, const size_t smem,
                              cudaStream_t stream, EPI_ARGS) {
    if (gain)
        return f32 ? launch_fourier<SS, true, true>(grid, smem, stream, LAUNCH_ARGS)
                   : launch_fourier<SS, true, false>(grid, smem, stream, LAUNCH_ARGS);
    return f32 ? launch_fourier<SS, false, true>(grid, smem, stream, LAUNCH_ARGS)
               : launch_fourier<SS, false, false>(grid, smem, stream, LAUNCH_ARGS);
}

extern "C" int mw_pixel_epilogue(
    const float* t_tri, const void* attr, const float* t_ent,
    const float* col_ent, const float* n_ent, const float* table,
    const uint8_t* atlas, const int* tex_map,
    const float* lights, const float* origin, const float* fwd,
    const float* right, const float* up, const float* tan_xy,
    const float* xbase, const float* ybase,
    int B, int W, int H, int A, int K, int has_ent, int ss, int gain, int nearest, int f32,
    int T, int R, uint8_t* rgb_out, float* depth_out, cudaStream_t stream)
{
    static int n_sm = 0;
    if (nearest) {  // the u8 atlas and tex_map; no glyph branch
        if (gain || atlas == nullptr || tex_map == nullptr || T <= 0 || R <= 0 || A <= 0)
            return (int)cudaErrorInvalidValue;
    } else if (table == nullptr || K <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    if ((ss != 1 && ss != 2) || W % ss || H % ss) return (int)cudaErrorInvalidValue;
    if (B == 0 || W == 0 || H == 0) return 0;
    if (n_sm == 0) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
    }
    // items: 256-pixel chunks (SS = 1) or 8 warps' 16-sample runs (SS = 2)
    const long long per_env = ss == 2 ? ((long long)(H / 2) * ((W + 15) / 16) + 7) / 8
                                      : ((long long)W * H + THREADS - 1) / THREADS;
    const long long items = (long long)B * per_env;
    // 8 blocks of 256 threads fill an SM's 2048 threads
    const int grid = (int)(items < 8LL * n_sm ? items : 8LL * n_sm);
    if (nearest) {
        return ss == 2
            ? (f32 ? launch_one<false, 2, 0, false, true, true>(grid, 0, stream, LAUNCH_ARGS)
                   : launch_one<false, 2, 0, false, true, false>(grid, 0, stream, LAUNCH_ARGS))
            : (f32 ? launch_one<false, 1, 0, false, true, true>(grid, 0, stream, LAUNCH_ARGS)
                   : launch_one<false, 1, 0, false, true, false>(grid, 0, stream, LAUNCH_ARGS));
    }
    const size_t smem = (size_t)A * fourier_row(K) * sizeof(float);
    return ss == 2 ? launch_fourier_any<2>(gain, f32, grid, smem, stream, LAUNCH_ARGS)
                   : launch_fourier_any<1>(gain, f32, grid, smem, stream, LAUNCH_ARGS);
}

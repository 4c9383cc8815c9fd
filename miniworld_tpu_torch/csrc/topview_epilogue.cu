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
// view's pixel_epilogue.cu shares: the Fourier texel without a footprint
// (fourier_texel_nofp) is eval_fourier without one.
//
// What bounds it on an H100: per pixel it reads t and the row index (8
// bytes) and the winner's float32 row (64, from the bank: L2 hits, since
// a layout's few upward rows cover every env) and writes 3 + 4: at the
// 8x8 procgen maze's B = 8192, 80x60, 0.61 GB counting each input once
// (a bank row once, not per pixel), 0.18 ms at 3.35 TB/s. The Fourier
// texel's 16 terms put its operation count at 0.26 ms at the card's
// float32 rate. Built with -fmad=false, so that each product and sum
// rounds as the plain version's, a term without a footprint issues as
// 37.7 instructions (cuobjdump -sass), 0.46 ms of issue at the maze's
// 25.7 M texels; the rest of a pixel (loads, footprints, uv, the queue,
// the lighting's square root and three IEEE divisions, the marker, the
// pack) is a few hundred more. kernel_ab.py --unequal, on copies with the
// texel or the lighting taken out, gives their shares of the launch
// (PERF.md).
//
// Design. A block is one env at a time (a grid of as many blocks as the
// card holds at once, walking the envs with a stride), 256 pixels a pass,
// one a thread:
//   1. per env, the block stages in shared memory what every pixel reads:
//      each entity slot's footprint (position, yaw's cos and sin, half
//      sizes, squared sphere radius, t = 10 - height, colour, flags), the
//      lights and the marker's vertices with its edge vectors; the env's
//      layout needs no division (its row of xs and zs, read through L1).
//      The Fourier table is staged once a block, up to TABLE_SMEM_MAX.
//   2. A pass: each thread takes its pixel's t and row, finds the
//      strictly nearest footprint, and where the result reads the texel
//      (a prim hit, no strictly nearer entity, a valid slot) computes uv
//      and queues (u, v, slot, pixel); elsewhere the texel is not read,
//      and skipping it is exact. The queue is compacted with one ballot
//      and one shared atomic a warp, so that the queued texels run one a
//      thread on the first ceil(n / 32) warps: the block's other warps
//      issue nothing, where a warp of pixels with one textured lane would
//      pay the K terms for all 32. K is a template parameter (16, 64 for
//      Sign's GAIN instance, others a runtime loop), so the terms unroll.
//   3. each thread shades its pixel with its queued texel, draws the
//      marker, packs and stores.
// The NEAREST instance computes its texel in 2. (a tex_map load and a u8
// gather; no queue). Measured at the maze with kernel_ab.py and not kept
// (PERF.md): t and row loaded a pass ahead (+2%), 128 threads a block
// (+6%), 512 (no gain), the pixel centres in shared memory (+2%).

#include "texel.cuh"

#define ATTR_DIM 16
#define THREADS 256
#define TOP_CAM_HEIGHT 10.0f
#define ORTHO_ACTIVE 1
#define ORTHO_SPHERE 2
#define MAX_ENTS 64
#define TABLE_SMEM_MAX (48 * 1024)

struct OrthoEnt {  // an entity slot's footprint, as every pixel's test reads it
    float x, z;    // ent_pos[0], ent_pos[2]
    float cd, sd;  // cos, sin of its yaw
    float hx, hz;  // ent_size[0] * 0.5, ent_size[2] * 0.5
    float r2;      // (0.5 * height)^2: a sphere's disc
    float t;       // TOP_CAM_HEIGHT - height
    float col[3];
    int flags;
};

// KT: the Fourier terms, 0 for the runtime K. SMEM_TABLE: the table is
// staged in shared memory (Fourier only).
template <bool SMEM_TABLE, int KT, bool GAIN, bool NEAREST>
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
    const float* __restrict__ table,       // (A, fourier_row(K)) fourier_table; null (NEAREST)
    const uint8_t* __restrict__ atlas,     // (A, R, R, 3) u8, NEAREST only
    const int* __restrict__ tex_map,       // (B, T), NEAREST only
    const float* __restrict__ lights,      // (B, 4, 3): pos, color, ambient, sky
    const float* __restrict__ marker,      // (B, 6) or null
    int B, int W, int H, int S, int E, int A, int K, int T, int R,
    uint8_t* __restrict__ rgb_out,         // (B, H, W, 3)
    float* __restrict__ depth_out)         // (B, H, W, 1)
{
    __shared__ OrthoEnt s_ent[MAX_ENTS];
    __shared__ float s_lt[12];
    __shared__ float s_mk[12];               // vertex a's (x, z), then edge a -> c's (dx, dz)
    __shared__ float2 s_quv[THREADS];        // the texel queue: (u, v),
    __shared__ int s_qkey[THREADS];          // slot << 8 | the pixel's thread
    __shared__ float s_tex[3 * THREADS];     // the texel of each thread's pixel
    __shared__ int s_qn[2];                  // queue lengths, by the pass's parity
    extern __shared__ float4 s_table[];
    const int tid = threadIdx.x, lane = tid & 31;
    const int kt = KT > 0 ? KT : K;
    const float* tab = table;
    if (SMEM_TABLE) {
        const float4* src = reinterpret_cast<const float4*>(table);
        for (int i = tid; i < A * fourier_row(kt) / 4; i += THREADS) s_table[i] = src[i];
        tab = reinterpret_cast<const float*>(s_table);
    }
    if (tid < 2) s_qn[tid] = 0;
    const int hw = W * H;
    const int x_step = THREADS % W, y_step = THREADS / W;
    int parity = 0;
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        __syncthreads();  // the previous env's staging is read
        if (tid < E) {
            const size_t k = (size_t)b * E + tid;
            const float height = ent_height[k];
            const float r_vis = 0.5f * height;
            OrthoEnt en;
            en.x = ent_pos[3 * k];
            en.z = ent_pos[3 * k + 2];
            en.cd = ent_cs[2 * k];
            en.sd = ent_cs[2 * k + 1];
            en.hx = ent_size[3 * k] * 0.5f;
            en.hz = ent_size[3 * k + 2] * 0.5f;
            en.r2 = r_vis * r_vis;
            en.t = TOP_CAM_HEIGHT - height;
#pragma unroll
            for (int i = 0; i < 3; ++i) en.col[i] = ent_color[3 * k + i];
            en.flags = flags[k];
            s_ent[tid] = en;
        } else if (tid >= 64 && tid < 76) {
            s_lt[tid - 64] = lights[(size_t)b * 12 + tid - 64];
        } else if (tid >= 96 && tid < 99 && marker != nullptr) {
            const int j = tid - 96, c = (j + 1) % 3;
            const float* m = marker + (size_t)b * 6;
            s_mk[2 * j] = m[2 * j];
            s_mk[2 * j + 1] = m[2 * j + 1];
            s_mk[6 + 2 * j] = m[2 * c] - m[2 * j];
            s_mk[7 + 2 * j] = m[2 * c + 1] - m[2 * j + 1];
        }
        __syncthreads();
        const int l = layout_id[b];
        const float* xl = xs + (size_t)l * W;
        const float* zl = zs + (size_t)l * H;
        const float4* attr_l = bank_attr + (size_t)l * S * (ATTR_DIM / 4);
        int x = tid % W, y = tid / W;
        for (int p0 = 0; p0 < hw; p0 += THREADS, parity ^= 1) {
            const int p = p0 + tid;
            const bool valid = p < hw;
            const size_t q = (size_t)b * hw + p;
            const float px = valid ? xl[x] : 0.0f, pz = valid ? zl[y] : 0.0f;
            const float tt = valid ? t_tri[q] : INFINITY;
            const int r = valid ? row[q] : -1;
            float at[ATTR_DIM];
            if (r >= 0) {
                const float4* src = attr_l + (size_t)r * (ATTR_DIM / 4);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float4 v = src[i];
                    at[4 * i] = v.x;
                    at[4 * i + 1] = v.y;
                    at[4 * i + 2] = v.z;
                    at[4 * i + 3] = v.w;
                }
            }

            // entity footprints at their top surface; the strictly nearest wins
            float te = INFINITY;
            int ewin = -1;
            for (int e = 0; e < E; ++e) {
                const OrthoEnt& en = s_ent[e];
                if (!(en.flags & ORTHO_ACTIVE)) continue;  // block-uniform
                const float dx = px - en.x;
                const float dz = pz - en.z;
                bool hit;
                if (en.flags & ORTHO_SPHERE) {
                    hit = dx * dx + dz * dz <= en.r2;
                } else {
                    const float lx = dx * en.cd - dz * en.sd;
                    const float lz = dx * en.sd + dz * en.cd;
                    hit = fabsf(lx) <= en.hx && fabsf(lz) <= en.hz;
                }
                if (hit && en.t < te) {
                    te = en.t;
                    ewin = e;
                }
            }

            // the winning prim's texel, where the result reads it
            const bool ent_wins = te < tt;
            const bool reads = r >= 0 && !ent_wins;
            float tex[3] = {1.0f, 1.0f, 1.0f};  // flat white (slot < 0)
            float uu = 0.0f, vv = 0.0f;
            int slot = -1;
            if (reads) {
                const float t_uv = tt;  // finite: a prim was hit
                const float h0 = px + t_uv * 0.0f, h1 = TOP_CAM_HEIGHT + t_uv * -1.0f,
                            h2 = pz + t_uv * 0.0f;
                uu = at[0] * h0 + at[1] * h1 + at[2] * h2 + at[6];
                vv = at[3] * h0 + at[4] * h1 + at[5] * h2 + at[7];
                slot = (int)rintf(at[14]);
                if (slot < 0) {
                } else if (NEAREST) {
                    nearest_texel(b, slot, uu, vv, atlas, tex_map, T, R, A, tex);
                } else if (slot >= A) {
                    tex[0] = tex[1] = tex[2] = 0.0f;  // no such row: black, as in the JAX one-hot
                }
            }
            const bool queued = !NEAREST && reads && slot >= 0 && slot < A;
            if constexpr (!NEAREST) {
                const unsigned m = __ballot_sync(0xffffffffu, queued);
                if (m) {  // one shared atomic a warp
                    const int leader = __ffs(m) - 1;
                    int base = 0;
                    if (lane == leader) base = atomicAdd(&s_qn[parity], __popc(m));
                    base = __shfl_sync(0xffffffffu, base, leader);
                    if (queued) {
                        const int i = base + __popc(m & ((1u << lane) - 1u));
                        s_quv[i] = make_float2(uu, vv);
                        s_qkey[i] = (slot << 8) | tid;
                    }
                }
                __syncthreads();  // the queue is complete
                const int nq = s_qn[parity];
                if (tid == 0) s_qn[parity ^ 1] = 0;  // the next pass's, read two barriers ago
                if (tid < nq) {
                    const float2 uv = s_quv[tid];
                    const int key = s_qkey[tid];
                    float tq[3];
                    fourier_texel_nofp<GAIN, KT>(tab + (size_t)(key >> 8) * fourier_row(kt), kt,
                                                 uv.x, uv.y, tq);
                    const int px_tid = key & 0xFF;
#pragma unroll
                    for (int i = 0; i < 3; ++i) s_tex[3 * px_tid + i] = tq[i];
                }
                __syncthreads();  // the texels are in
                if (queued) {
#pragma unroll
                    for (int i = 0; i < 3; ++i) tex[i] = s_tex[3 * tid + i];
                }
            }

            if (valid) {
                float col[3] = {0.0f, 0.0f, 0.0f}, nrm[3] = {0.0f, 0.0f, 0.0f};
                float t_hit = tt;
                if (ent_wins) {
                    t_hit = te;
#pragma unroll
                    for (int i = 0; i < 3; ++i) col[i] = s_ent[ewin].col[i];
                    nrm[1] = 1.0f;
                } else if (r >= 0) {
#pragma unroll
                    for (int i = 0; i < 3; ++i) {
                        col[i] = at[11 + i] * tex[i];
                        nrm[i] = at[8 + i];
                    }
                }
                const bool hit = isfinite(t_hit);
                const float t_safe = hit ? t_hit : 100.0f;  // FAR
                float rgb[3];
                if (hit) {
                    const float hp[3] = {px + t_safe * 0.0f, TOP_CAM_HEIGHT + t_safe * -1.0f,
                                         pz + t_safe * 0.0f};
                    shade_hit(s_lt, col, nrm, hp, rgb);
                } else {
#pragma unroll
                    for (int i = 0; i < 3; ++i) rgb[i] = s_lt[9 + i];
                }
                if (marker != nullptr) {  // the agent triangle, either winding, edges included
                    float ed[3];
#pragma unroll
                    for (int j = 0; j < 3; ++j)
                        ed[j] = (px - s_mk[2 * j]) * s_mk[7 + 2 * j]
                                - (pz - s_mk[2 * j + 1]) * s_mk[6 + 2 * j];
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
            x += x_step;
            y += y_step;
            if (x >= W) {
                x -= W;
                ++y;
            }
        }
    }
}

#define TOP_ARGS                                                                             \
    t_tri, row, attr4, layout_id, xs, zs, ent_pos, ent_size, ent_height, ent_color, ent_cs, \
    flags, table, atlas, tex_map, lights, marker, B, W, H, S, E, A, K, T, R, rgb_out, depth_out

// One instance, on as many blocks as the card holds at once (at most B)
template <bool SMEM_TABLE, int KT, bool GAIN, bool NEAREST>
static int launch_top(const size_t smem, cudaStream_t stream, const float* t_tri,
                      const int* row, const float4* attr4, const int* layout_id,
                      const float* xs, const float* zs, const float* ent_pos,
                      const float* ent_size, const float* ent_height, const float* ent_color,
                      const float* ent_cs, const unsigned char* flags, const float* table,
                      const uint8_t* atlas, const int* tex_map, const float* lights,
                      const float* marker, int B, int W, int H, int S, int E, int A, int K,
                      int T, int R, uint8_t* rgb_out, float* depth_out) {
    static int n_sm = 0;
    auto kernel = topview_epilogue_kernel<SMEM_TABLE, KT, GAIN, NEAREST>;
    int per_sm = 0;
    cudaError_t err = cudaSuccess;
    if (n_sm == 0) {
        int dev = 0;
        err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    const long long fill = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
    const int grid = (int)(B < fill ? B : fill);
    kernel<<<grid, THREADS, smem, stream>>>(TOP_ARGS);
    return (int)cudaGetLastError();
}

// Fourier mode: K = 16 and 64 unrolled; the table in shared memory up to
// TABLE_SMEM_MAX, read through L1 above
template <bool GAIN, int KT>
static int launch_fourier(const size_t smem, cudaStream_t stream, const float* t_tri,
                          const int* row, const float4* attr4, const int* layout_id,
                          const float* xs, const float* zs, const float* ent_pos,
                          const float* ent_size, const float* ent_height,
                          const float* ent_color, const float* ent_cs,
                          const unsigned char* flags, const float* table, const uint8_t* atlas,
                          const int* tex_map, const float* lights, const float* marker, int B,
                          int W, int H, int S, int E, int A, int K, int T, int R,
                          uint8_t* rgb_out, float* depth_out) {
    return smem <= (size_t)TABLE_SMEM_MAX
        ? launch_top<true, KT, GAIN, false>(smem, stream, TOP_ARGS)
        : launch_top<false, KT, GAIN, false>(0, stream, TOP_ARGS);
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
    if (nearest) {
        if (gain || atlas == nullptr || tex_map == nullptr || T <= 0 || R <= 0 || A <= 0)
            return (int)cudaErrorInvalidValue;
    } else if (table == nullptr || K <= 0 || A <= 0 || A >= (1 << 23)) {
        return (int)cudaErrorInvalidValue;  // the queue's slot << 8
    }
    if (B < 0 || W <= 0 || H <= 0 || S <= 0 || E < 0 || E > MAX_ENTS)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const float4* attr4 = reinterpret_cast<const float4*>(bank_attr);
    if (nearest) return launch_top<false, 0, false, true>(0, stream, TOP_ARGS);
    const size_t smem = (size_t)A * fourier_row(K) * sizeof(float);
    if (gain)
        return K == 64 ? launch_fourier<true, 64>(smem, stream, TOP_ARGS)
                       : launch_fourier<true, 0>(smem, stream, TOP_ARGS);
    return K == 16 ? launch_fourier<false, 16>(smem, stream, TOP_ARGS)
                   : launch_fourier<false, 0>(smem, stream, TOP_ARGS);
}

// Orthographic scan of the static prims for the top view: nearest t and
// the winner's bank row per pixel.
//
// Replaces: miniworld_tpu/render/topview.py:_tri_pass_ortho, an XLA-fused
// jnp scan in the JAX package (parallel rays d = (0, -1, 0) from
// per-pixel origins at height 10, chunks of min(128, S), argmin within a
// chunk and a strict < across chunks, the float32 attribute row carried
// as a one-hot product), with its per-env kill (topview.py:77-84). The
// plain PyTorch version is tri_pass_ortho_plain in
// miniworld_tpu_torch/render/topview.py; with -fmad=false the arithmetic
// below matches it operation by operation.
//
// What bounds it on an H100: bytes. It writes t and the row index, 8
// bytes a pixel (0.31 GB at the 8x8 procgen maze's B = 8192, 80x60: 0.09
// ms at 3.35 TB/s), and reads the statics once. A full scan of the
// maze's 832 rows would be 3.3e10 row tests (about 30 operations each,
// 15 ms at the card's float32 rate). What the kernel adds on top is the
// rows each pixel scans: with -fmad=false a row test is about 24
// instructions a pixel, so rows a pixel, not bytes, set its time.
//
// Host side. The ortho camera is the same for every env of a layout and
// under d = (0, -1, 0) only upward-facing prims (det > 1e-12) can hit:
// topview.top_statics keeps those rows, stages per row the constants of
// the hit test (d x e2, e1 x d, n = e1 x e2, their offsets at v0, 1/det,
// 1/(n . d), kind), and lists for every TILE_W x TILE_H pixel tile the
// rows whose x-z bounding box, grown by a margin far above float32
// rounding, meets the tile, in bank order. At 8x8 a maze pixel scans
// 3.8 live rows (chip_smoke.py's [topview-stages] lines count them).
//
// Design. A warp is one tile of one env, PIX pixels a lane (a column, so
// the row's x terms are shared), and scans the envs ENVS_PER_WARP in turn;
// a block is WARPS warps on one tile. For an env the warp
//   1. stages its tile's listed rows in its own shared memory, 32 at a
//      time, one lane a row: the row's four float4 with the y terms
//      premultiplied by the camera height (TOP_CAM_HEIGHT * y, the product
//      the plain version rounds) and the bank row in the last field; the
//      lane keeps the row's kill code. The next env of the same layout
//      reuses a list of up to 32 rows as staged;
//   2. tests each row's liveness in this env once, one lane a row (on a
//      procgen super bank a row's code names the wall that kills it: the
//      dense tri_active = base + sign * wall_open[w] > 0.5), and compacts
//      the live rows with a ballot, in list order;
//   3. scans the live rows from the lowest bit up, in ascending bank order,
//      with a strict <: JAX's rule, the first row at the smallest t (a row
//      of its clamped last chunk was read by the chunk before too).
// The scan makes no global load. The epilogue reads the winner's float32
// row from the bank, the row JAX's one-hot product selects.

#include <cuda_runtime.h>
#include <math.h>

#include "maze_row.cuh"

#define TILE_W 8
#define TILE_H 8
#define PIX 2             // pixels a lane, a column: TILE_W x (32 / TILE_W) lanes x PIX
#define WARPS 8
#define ENVS_PER_WARP 8
#define TOP_CAM_HEIGHT 10.0f
#define FAR 100.0f

static_assert(TILE_W * (TILE_H / PIX) == 32, "a warp covers its tile");

__global__ void __launch_bounds__(WARPS * 32) tri_pass_ortho_kernel(
    const float4* __restrict__ rows,    // (L, Sc, 4) float4: staged rows
    const int* __restrict__ row_id,     // (L, Sc)
    const int* __restrict__ row_code,   // (L, Sc)
    const int* __restrict__ tile_off,   // (L, T + 1)
    const int* __restrict__ tile_rows,  // (N,)
    const float* __restrict__ xs,       // (L, W)
    const float* __restrict__ zs,       // (L, H)
    const int* __restrict__ layout_id,  // (B,)
    const float* __restrict__ wall_open,  // (B, NW) or null
    int B, int Sc, int W, int H, int NW, int n_tx, int n_tiles,
    float* __restrict__ t_out,          // (B, HW)
    int* __restrict__ row_out)          // (B, HW)
{
    __shared__ float4 staged[WARPS][32][4];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tile = blockIdx.x % n_tiles;
    const int b0 = (blockIdx.x / n_tiles * WARPS + warp) * ENVS_PER_WARP;
    const int x = (tile % n_tx) * TILE_W + lane % TILE_W;
    const int y0 = (tile / n_tx) * TILE_H + lane / TILE_W * PIX;
    const int xc = min(x, W - 1);
    float4(&st)[32][4] = staged[warp];
    int staged_l = -1;  // the layout whose list (of up to 32 rows) the warp holds
    int code = -2;      // lane j: the kill code of staged row j
    for (int e = 0; e < ENVS_PER_WARP; ++e) {
        const int b = b0 + e;
        if (b >= B) break;  // warp-uniform
        const int l = layout_id[b];
        const int* off = tile_off + (size_t)l * (n_tiles + 1) + tile;
        const int k0 = off[0], k1 = off[1];
        const float px = xs[(size_t)l * W + xc];
        float pz[PIX], best[PIX];
        int win[PIX];
#pragma unroll
        for (int i = 0; i < PIX; ++i) {
            pz[i] = zs[(size_t)l * H + min(y0 + i, H - 1)];
            best[i] = INFINITY;
            win[i] = -1;
        }
        for (int c0 = k0; c0 < k1; c0 += 32) {
            const int n = min(32, k1 - c0);
            if (l != staged_l || k1 - k0 > 32) {  // warp-uniform
                __syncwarp();  // the rows staged before are read
                if (lane < n) {
                    const size_t q = (size_t)l * Sc + tile_rows[c0 + lane];
                    float4 cu = rows[4 * q], cv = rows[4 * q + 1], ct = rows[4 * q + 2];
                    float4 m = rows[4 * q + 3];  // 1/det, 1/(n . d), kind, 0
                    cu.y = TOP_CAM_HEIGHT * cu.y;
                    cv.y = TOP_CAM_HEIGHT * cv.y;
                    ct.y = TOP_CAM_HEIGHT * ct.y;
                    m.w = __int_as_float(row_id[q]);
                    st[lane][0] = cu;
                    st[lane][1] = cv;
                    st[lane][2] = ct;
                    st[lane][3] = m;
                    code = row_code[q];
                }
                __syncwarp();
                staged_l = k1 - k0 > 32 ? -1 : l;
            }
            unsigned live = __ballot_sync(0xffffffffu,
                                          lane < n && row_live(code, wall_open, b, NW));
            while (live) {  // ascending list order
                const int j = __ffs(live) - 1;
                live &= live - 1;
                const float4 cu = st[j][0], cv = st[j][1], ct = st[j][2], m = st[j][3];
                const float au = px * cu.x + cu.y;
                const float av = px * cv.x + cv.y;
                const float at = px * ct.x + ct.y;
#pragma unroll
                for (int i = 0; i < PIX; ++i) {
                    const float u_num = (au + pz[i] * cu.z) - cu.w;
                    const float v_num = (av + pz[i] * cv.z) - cv.w;
                    const float t_num = ct.w - (at + pz[i] * ct.z);
                    const float t = t_num * m.y;
                    const float u = u_num * m.x;
                    const float v = v_num * m.x;
                    const float cov = fmaxf(u, v) + m.z * fminf(u, v);
                    if (u >= 0.0f && v >= 0.0f && cov <= 1.0f && t > 0.0f && t < FAR &&
                        t < best[i]) {
                        best[i] = t;
                        win[i] = __float_as_int(m.w);
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < PIX; ++i) {
            const int y = y0 + i;
            if (x >= W || y >= H) continue;
            const size_t p = (size_t)b * W * H + (size_t)y * W + x;
            t_out[p] = best[i];
            row_out[p] = win[i];
        }
    }
}

extern "C" int mw_tri_pass_ortho(
    const float* rows, const int* row_id, const int* row_code, const int* tile_off,
    const int* tile_rows, const float* xs, const float* zs, const int* layout_id,
    const float* wall_open, int B, int Sc, int W, int H, int NW, float* t_out, int* row_out,
    cudaStream_t stream)
{
    if (B < 0 || Sc <= 0 || W <= 0 || H <= 0 || (NW > 0) != (wall_open != nullptr))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const int n_tx = (W + TILE_W - 1) / TILE_W;
    const int n_tiles = n_tx * ((H + TILE_H - 1) / TILE_H);
    const long long per_block = (long long)WARPS * ENVS_PER_WARP;
    const long long blocks = (long long)n_tiles * ((B + per_block - 1) / per_block);
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    tri_pass_ortho_kernel<<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
        reinterpret_cast<const float4*>(rows), row_id, row_code, tile_off, tile_rows, xs, zs,
        layout_id, wall_open, B, Sc, W, H, NW, n_tx, n_tiles, t_out, row_out);
    return (int)cudaGetLastError();
}

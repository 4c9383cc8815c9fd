// Orthographic scan of the static prims for the top view: nearest t and
// the winner's bank row per pixel.
//
// Replaces: miniworld_tpu/render/topview.py:_tri_pass_ortho, an XLA-fused
// jnp scan in the JAX package (parallel rays d = (0, -1, 0) from
// per-pixel origins at height 10, chunks of min(128, S), argmin within a
// chunk and a strict < across chunks, the float32 attribute row carried
// as a one-hot product). The plain PyTorch version is
// tri_pass_ortho_plain in miniworld_tpu_torch/render/topview.py; with
// -fmad=false the arithmetic below matches it operation by operation.
//
// What bounds it on an H100: bytes. It writes t and the row index, 8
// bytes a pixel (0.31 GB at the 8x8 procgen maze's B = 8192, 80x60: 0.09
// ms at 3.35 TB/s), and reads the statics once. A full scan of the
// maze's 832 rows would be 3.3e10 row tests (about 30 operations each,
// 15 ms at the card's float32 rate).
//
// Design. The ortho camera is the same for every env of a layout and
// under d = (0, -1, 0) only upward-facing prims (det > 1e-12) can hit:
// the host (topview.top_statics) keeps those rows, stages per row the
// constants of the hit test (d x e2, e1 x d, n = e1 x e2, their offsets
// at v0, 1/det, 1/(n . d), kind), and lists for every 16x16 pixel tile
// the rows whose x-z bounding box, grown by a margin far above float32
// rounding, meets the tile, in bank order. One block of 256 threads is
// one (env, tile); each thread one pixel, scanning the tile's list in
// ascending order with a strict <, which is JAX's rule: the first row at
// the smallest t (a row of its clamped last chunk was read by the chunk
// before too). On a procgen super bank a row's code names the wall that
// kills it in this env (the dense tri_active = base + sign *
// wall_open[w] > 0.5). The epilogue reads the winner's float32 row from
// the bank, the row JAX's one-hot product selects.

#include <cuda_runtime.h>
#include <math.h>

#include "maze_row.cuh"

#define TILE_W 16
#define TILE_H 16
#define TOP_CAM_HEIGHT 10.0f
#define FAR 100.0f

__global__ void __launch_bounds__(TILE_W * TILE_H) tri_pass_ortho_kernel(
    const float4* __restrict__ rows,    // (L, Sc, 4) float4: staged rows
    const int* __restrict__ row_id,     // (L, Sc)
    const int* __restrict__ row_code,   // (L, Sc)
    const int* __restrict__ tile_off,   // (L, T + 1)
    const int* __restrict__ tile_rows,  // (N,)
    const float* __restrict__ xs,       // (L, W)
    const float* __restrict__ zs,       // (L, H)
    const int* __restrict__ layout_id,  // (B,)
    const float* __restrict__ wall_open,  // (B, NW) or null
    int Sc, int W, int H, int NW, int n_tx, int n_tiles,
    float* __restrict__ t_out,          // (B, HW)
    int* __restrict__ row_out)          // (B, HW)
{
    const int b = blockIdx.x / n_tiles;
    const int tile = blockIdx.x - b * n_tiles;
    const int x = (tile % n_tx) * TILE_W + (int)(threadIdx.x % TILE_W);
    const int y = (tile / n_tx) * TILE_H + (int)(threadIdx.x / TILE_W);
    if (x >= W || y >= H) return;
    const int l = layout_id[b];
    const float px = xs[(size_t)l * W + x];
    const float pz = zs[(size_t)l * H + y];
    const int* lst = tile_off + (size_t)l * (n_tiles + 1) + tile;
    float best = INFINITY;
    int win = -1;
    for (int k = lst[0]; k < lst[1]; ++k) {
        const size_t q = (size_t)l * Sc + tile_rows[k];
        if (!row_live(row_code[q], wall_open, b, NW)) continue;
        const float4 cu = rows[4 * q], cv = rows[4 * q + 1], ct = rows[4 * q + 2];
        const float4 m = rows[4 * q + 3];  // 1/det, 1/(n . d), kind, 0
        const float u_num = ((px * cu.x + TOP_CAM_HEIGHT * cu.y) + pz * cu.z) - cu.w;
        const float v_num = ((px * cv.x + TOP_CAM_HEIGHT * cv.y) + pz * cv.z) - cv.w;
        const float t_num = ct.w - ((px * ct.x + TOP_CAM_HEIGHT * ct.y) + pz * ct.z);
        const float t = t_num * m.y;
        const float u = u_num * m.x;
        const float v = v_num * m.x;
        const float cov = fmaxf(u, v) + m.z * fminf(u, v);
        if (u >= 0.0f && v >= 0.0f && cov <= 1.0f && t > 0.0f && t < FAR && t < best) {
            best = t;
            win = row_id[q];
        }
    }
    const size_t p = (size_t)b * W * H + (size_t)y * W + x;
    t_out[p] = best;
    row_out[p] = win;
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
    const long long blocks = (long long)B * n_tiles;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    tri_pass_ortho_kernel<<<(unsigned)blocks, TILE_W * TILE_H, 0, stream>>>(
        reinterpret_cast<const float4*>(rows), row_id, row_code, tile_off, tile_rows, xs, zs,
        layout_id, wall_open, Sc, W, H, NW, n_tx, n_tiles, t_out, row_out);
    return (int)cudaGetLastError();
}

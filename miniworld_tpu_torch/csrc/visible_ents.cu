// Entity visibility query: per env, which entities' query boxes some
// pixel ray enters in front of the rooms' depth.
//
// Replaces: miniworld_tpu/render/visibility.py:visible_ents with its
// _room_depth (:38-101, the nearest room prim per ray, the dense
// tri_active kill of a procgen maze) and the query-box slab test
// (:105-141), XLA-fused jnp work in the JAX package. The plain PyTorch
// version is visible_ents_plain in miniworld_tpu_torch/render/visibility.py;
// with -fmad=false the arithmetic below matches it operation by operation:
// rays materialised as (fwd + xv right) + yv up, the unnormalised test
// max(u, v) + kind min(u, v) <= det, t = t_num * (1 / det) > NEAR, the
// slabs' IEEE divisions.
//
// Contract. Entity e of env b is visible iff it is alive and some
// pixel's ray enters its query box pos + ([-0.1, 0.1], [0, 0.2], [-0.1,
// 0.1]) at t_in <= t_out with NEAR < t_in < FAR, in front of the nearest
// live room-row hit of that ray (inf where none).
//
// What bounds it on an H100: the bytes it must move, the layouts' rows
// and codes once, each env's camera, entities, walls and layout id, and
// the (B, E) flags (a few MB at the 8x8 procgen Maze's B = 8192). The
// full scan, every pixel against every live room row and every alive
// box, is some 1e11 operations there (7.5 ms at the card's float32
// rate), but the result reads the room depth only at the pixels where a
// box is hit, and the box of a maze is in few views.
//
// Design. A block of 128 threads owns one env and goes through four
// steps, each only where the one before left work:
// 1. Cull, once an env: each alive entity's bounding sphere against each
//    tile column's two side planes and each tile row's two (tiles of 16 x
//    8 pixels), and the plane NEAR / 2 in front of the eye, as 64-bit
//    masks a column and a row. A tile's survivors are its column's mask
//    AND its row's. An env with no surviving (tile, entity) pair writes
//    its flags 0 and ends: it stages nothing.
// 2. Rows: the env's live room rows (the maze kill ``row_live`` of
//    maze_row.cuh) are staged in shared memory in bank order (a ballot
//    a warp of rows and a prefix over the warps' counts): g_det = e2 x
//    e1, g_u = e2 x s, g_v = s x e1 with s = origin - v0, t_num = e2 .
//    g_v and the kind, 48 bytes a row.
// 3. Slabs: a warp a tile, in passes of 16 x 2 pixels, one a lane (few
//    values live across the divisions' slow path, so nothing spills).
//    Each pass slab-tests the tile's survivors that no pass has flagged
//    yet: a flag, a bit in shared memory, takes the entity out of every
//    later pass of every warp.
// 4. Occlusion, only at the lanes whose slab test hit: rows in turn, the
//    row test of the plain version, until the first hit row with t <=
//    t_in (the entity is hidden there). First the block's last 8 rows
//    that hid a box (a wall hides a box from many pixels, but is made of
//    several rows); where none does, every live row, the warp's lanes in
//    lockstep from the row before the warp's last find, so that they read
//    one row at a time (a broadcast). A lane whose full scan finds no
//    such row sets the entity's flag: it is visible.
//
// The early exit is exact. The plain version compares t_in < depth,
// depth = min over H of t_j, H the live rows whose computed test passes
// (det > 1e-12, u >= 0, v >= 0, cov <= det, NEAR < t_j < FAR: each t_j
// in H is finite and not NaN), inf where H is empty. Since the minimum
// of finitely many floats is one of them, t_in < depth iff t_in < t_j
// for every j in H, iff no j in H has t_j <= t_in; where H is empty both
// sides hold (t_in < FAR < inf). The scan computes each row's det, u, v,
// cov and t_j by the plain version's operations (t_j = t_num * (1 /
// det) where det > 1e-12, as the plain version's t where its test
// passes), applies the same gates, and stops at the first j in H with
// t_j <= t_in: a row with t_j outside (NEAR, FAR) is not in H and does
// not stop it, as it does not enter the plain minimum. The answer is
// the existence of such a j, so it does not depend on the order of the
// rows, on where the scan starts or on rows tested twice (the recent
// occluders first: any stop there is a j in H, and where there is none
// the full scan decides); t_in is not NaN (NEAR < t_in).
//
// The cull is exact. Let o be the eye, (f, r, u) the camera basis
// (orthonormal to a few u = 2^-24, as camera_grid's), and the computed
// ray of a pixel D' = (f + xv r) + yv u, sd its components with |D'_k| <
// 1e-12 taken as 1e-12; D = f + xv r + yv u in exact arithmetic on the
// same f, r, u, xv, yv. Then |D' - D| <= 11 u |D| (|D|^2 = 1 + xv^2 +
// yv^2 to a few u), |sd - D'| <= 4e-12, and D.f = 1 + e with |e| <=
// 12 u (1 + |xv| + |yv|)^2. The pixels divide the slab numerators
// n_lo = (pos + lo) - o and n_hi = (pos + hi) - o; the cull takes its
// sphere from the same computed values: centre c = (n_lo + n_hi) / 2 and
// radius R = |n_hi - n_lo| / 2 about the eye, so the world's coordinates
// never enter its errors. Let L = |c| + R.
// - A computed hit at t = t_in (NEAR < t < FAR) lies, on each axis,
//   between t1 = n_lo_k / sd_k (1 + d1) and t2 = n_hi_k / sd_k (1 + d2),
//   |d| <= u: so t sd_k lies in [n_lo_k, n_hi_k] widened by u (|n_lo_k|
//   + |n_hi_k|), and t sd within R + 4 u L of c. The exact ray's point
//   Q = t D is within t |sd - D| <= t (11 u |D| + 4e-12) of it, where t
//   |D| <= 1.0001 L + 4e-10 (t < FAR); as |t sd| >= 0.99 NEAR, L >= 0.99
//   NEAR, so |Q - c| <= R + 16 u L + 5e-10 <= R + 17 u L.
// - Q lies on the tile's side of each of its planes up to t |e_k|: for
//   xv in [xlo, xhi], Q.r - xhi Q.f = t (xv - xhi) + t e_x <= t e_x with
//   |e_x| <= 12 u (1 + |xv| + |yv|)^2 <= 36 u |D|^2, so t |e_x| <= 37 u
//   |D| L; and Q.f = t (1 + e) > NEAR / 2.
// - Hence the exact c satisfies c.r - xhi c.f <= (R + 17 u L) |r - xhi
//   f| + 37 u |D| L, with |r - xhi f| <= sqrt(1 + xhi^2) (1 + 4 u), and
//   c.f + R + 17 u L > NEAR / 2. The kernel computes Cf, Cr, Cu, R, |c|
//   and the two sides of its tests from the computed c within 20 u (1 +
//   |xhi|) (L + rho) of the exact values, and culls where Cr - xhi Cf >
//   rho sqrt(1 + xhi^2) (or the other three planes alike), or where Cf
//   + rho < NEAR / 2, with rho = R + m and the margin m = 2^-6 L. For
//   |xv|, |yv| <= 2^6 (a fov below 176 degrees) all those terms stay
//   below 2^-10 (1 + |xhi|) L, inside m sqrt(1 + xhi^2) >= 2^-6.5 (1 +
//   |xhi|) L: no tile at which the plain slab test hits the box is culled,
//   and the flags are the full scan's, bit for bit.
// - A box that straddles the eye or the NEAR plane is covered by the same
//   argument: nothing above assumes c in front of the eye. A NaN fails
//   every comparison of the tests (and rho < 0, the dead slot's mark), so
//   it never culls.

#include <cuda_runtime.h>
#include <math.h>

#include "maze_row.cuh"

#define THREADS 128
#define WARPS (THREADS / 32)
#define MAX_E 64
#define TILE_W 16     // a tile: 16 x 8 pixels, a warp's
#define TILE_H 8
#define PASS_ROWS 2   // a pass: 16 x 2 pixels, one a lane
#define NEAR 0.04f
#define FAR 100.0f
#define BOX_R 0.1f
#define BOX_H 0.2f
#define VIS_FIELDS 12
#define CULL_MARGIN 0.015625f  // 2^-6
#define N_STATS 6
#define OCC_CACHE 8   // the block's recent occluders, tested first

// per-entity constants, field-major in shared memory
enum { F_LO0, F_LO1, F_LO2, F_HI0, F_HI1, F_HI2, F_CF, F_CR, F_CU, F_RHO, F_COUNT };

// stats (optional): envs that staged rows, (tile, entity) pairs the cull
// kept, slab tests, occlusion scans, rows those scans tested, rows staged
enum { S_ENVS, S_PAIRS, S_SLABS, S_SCANS, S_ROWS, S_STAGED };

// Whether staged row j hides a box entered at t_in along the ray d: the
// plain version's row test (det > 1e-12, u >= 0, v >= 0, cov <= det, t =
// t_num * (1 / det) in (t_lo, FAR); t_lo = NEAR for a pixel) and t <= t_in.
__device__ __forceinline__ bool occludes(const float4* __restrict__ staged, int j, float d0,
                                         float d1, float d2, float t_in,
                                         float t_lo = NEAR) {
    const float4 gd = staged[3 * j];
    const float4 gu = staged[3 * j + 1];
    const float4 gv = staged[3 * j + 2];
    const float det = (d0 * gd.x + d1 * gd.y) + d2 * gd.z;
    const float u = (d0 * gu.x + d1 * gu.y) + d2 * gu.z;
    const float v = (d0 * gv.x + d1 * gv.y) + d2 * gv.z;
    const float cov = fmaxf(u, v) + gu.w * fminf(u, v);
    if (!(det > 1e-12f && u >= 0.0f && v >= 0.0f && cov <= det)) return false;
    const float t = gd.w * (1.0f / det);
    return t > t_lo && t < FAR && t <= t_in;
}

__global__ void __launch_bounds__(THREADS) visible_ents_kernel(
    const float* __restrict__ rows,       // (L, Sr, 12): v0, e1, e2, kind, 0, 0
    const int* __restrict__ row_code,     // (L, Sr): -2 padding, -1 always, 2w / 2w + 1
    const int* __restrict__ layout_id,    // (B,)
    const float* __restrict__ wall_open,  // (B, NW) or null
    const float* __restrict__ origin, const float* __restrict__ fwd,
    const float* __restrict__ right, const float* __restrict__ up,
    const float* __restrict__ tan_xy, const float* __restrict__ xbase,
    const float* __restrict__ ybase,
    const float* __restrict__ ent_pos,    // (B, E, 3)
    const unsigned char* __restrict__ ent_alive,  // (B, E)
    int Sr, int E, int W, int H, int NW,
    unsigned char* __restrict__ visible,  // (B, E)
    unsigned long long* __restrict__ stats)  // (N_STATS,) or null
{
    // staged rows (Sr x 3: (g_det, t_num), (g_u, kind), (g_v, 0)); per
    // tile column and row (lo, hi, sqrt(1 + lo^2), sqrt(1 + hi^2)) of its
    // xv or yv; xv per column, yv per row; per tile column and row the
    // mask of the entities it keeps (2 words); per warp of rows its live
    // ballot and its offset
    extern __shared__ float4 smem[];
    __shared__ float ent[F_COUNT * MAX_E];
    __shared__ unsigned vis[2], any_col[2], any_row[2];
    __shared__ int n_live, occ_cache[OCC_CACHE];
    __shared__ unsigned occ_next;
    __shared__ unsigned long long s_stats[N_STATS];
    const int ntx = (W + TILE_W - 1) / TILE_W, nty = (H + TILE_H - 1) / TILE_H;
    const int n_chunks = (Sr + 31) / 32;
    float4* staged = smem;
    float4* lines = staged + 3 * Sr;
    float* xs = reinterpret_cast<float*>(lines + ntx + nty);
    float* ys = xs + W;
    unsigned* keep = reinterpret_cast<unsigned*>(ys + H);
    unsigned* chunk = keep + 2 * (ntx + nty);  // (n_chunks, 2): ballot, offset
    const int b = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const float o0 = origin[3 * b], o1 = origin[3 * b + 1], o2 = origin[3 * b + 2];
    const float f0 = fwd[3 * b], f1 = fwd[3 * b + 1], f2 = fwd[3 * b + 2];
    const float r0 = right[3 * b], r1 = right[3 * b + 1], r2 = right[3 * b + 2];
    const float u0 = up[3 * b], u1 = up[3 * b + 1], u2 = up[3 * b + 2];
    const float tan_x = tan_xy[2 * b], tan_y = tan_xy[2 * b + 1];

    if (tid < 2) {
        vis[tid] = 0u;
        any_col[tid] = 0u;
        any_row[tid] = 0u;
    }
    if (tid < OCC_CACHE) occ_cache[tid] = -1;
    if (tid == 0) occ_next = 0u;
    if (stats != nullptr && tid < N_STATS) s_stats[tid] = 0ull;
    for (int c = tid; c < ntx + nty; c += THREADS) {  // from the inputs, as xs / ys
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
    for (int e = tid; e < E; e += THREADS) {
        const size_t k = (size_t)b * E + e;
        const float p0 = ent_pos[3 * k], p1 = ent_pos[3 * k + 1], p2 = ent_pos[3 * k + 2];
        // the slab numerators, as every pixel divides them
        const float lo0 = (p0 + -BOX_R) - o0, lo1 = (p1 + 0.0f) - o1, lo2 = (p2 + -BOX_R) - o2;
        const float hi0 = (p0 + BOX_R) - o0, hi1 = (p1 + BOX_H) - o1, hi2 = (p2 + BOX_R) - o2;
        ent[F_LO0 * MAX_E + e] = lo0;
        ent[F_LO1 * MAX_E + e] = lo1;
        ent[F_LO2 * MAX_E + e] = lo2;
        ent[F_HI0 * MAX_E + e] = hi0;
        ent[F_HI1 * MAX_E + e] = hi1;
        ent[F_HI2 * MAX_E + e] = hi2;
        // the cull's sphere, from the same numerators
        const float c0 = 0.5f * (lo0 + hi0), c1 = 0.5f * (lo1 + hi1), c2 = 0.5f * (lo2 + hi2);
        const float h0 = 0.5f * (hi0 - lo0), h1 = 0.5f * (hi1 - lo1), h2 = 0.5f * (hi2 - lo2);
        const float rad = sqrtf(h0 * h0 + h1 * h1 + h2 * h2);
        const float dist = sqrtf(c0 * c0 + c1 * c1 + c2 * c2);
        ent[F_CF * MAX_E + e] = c0 * f0 + c1 * f1 + c2 * f2;
        ent[F_CR * MAX_E + e] = c0 * r0 + c1 * r1 + c2 * r2;
        ent[F_CU * MAX_E + e] = c0 * u0 + c1 * u1 + c2 * u2;
        ent[F_RHO * MAX_E + e] = ent_alive[k] ? rad + CULL_MARGIN * (dist + rad) : -1.0f;
    }
    __syncthreads();
    // 1. the cull's side planes split by axis; each line also drops the
    // dead entities and those nearer the eye than the plane NEAR / 2
    for (int c = tid; c < ntx + nty; c += THREADS) {
        const bool col = c < ntx;
        const float4 line = lines[c];
        const float lo = line.x, hi = line.y, n_lo = line.z, n_hi = line.w;
        const float* side = ent + (col ? F_CR : F_CU) * MAX_E;
        unsigned m[2] = {0u, 0u};
        for (int e = 0; e < E; ++e) {
            const float cf = ent[F_CF * MAX_E + e], cs = side[e], rho = ent[F_RHO * MAX_E + e];
            const bool out = (cs - hi * cf > rho * n_hi) || (lo * cf - cs > rho * n_lo) ||
                             (cf + rho < 0.5f * NEAR);
            if (!(rho < 0.0f) && !out) m[e >> 5] |= 1u << (e & 31);
        }
        keep[2 * c] = m[0];
        keep[2 * c + 1] = m[1];
        unsigned* any = col ? any_col : any_row;
        if (m[0]) atomicOr(&any[0], m[0]);
        if (m[1]) atomicOr(&any[1], m[1]);
    }
    __syncthreads();
    // an entity kept by some column and some row is kept by their tile
    if (!((any_col[0] & any_row[0]) | (any_col[1] & any_row[1]))) {
        for (int e = tid; e < E; e += THREADS) visible[(size_t)b * E + e] = 0;
        return;
    }
    // 2. the live rows, staged in bank order
    const int l = layout_id[b];
    for (int i = tid; i < W; i += THREADS) xs[i] = xbase[i] * tan_x;
    for (int i = tid; i < H; i += THREADS) ys[i] = ybase[i] * tan_y;
    for (int c = warp; c < n_chunks; c += WARPS) {
        const int i = 32 * c + lane;
        const bool live =
            i < Sr && row_live(row_code[(size_t)l * Sr + i], wall_open, b, NW);
        const unsigned bal = __ballot_sync(0xffffffffu, live);
        if (lane == 0) chunk[2 * c] = bal;
    }
    __syncthreads();
    if (tid == 0) {
        int off = 0;
        for (int c = 0; c < n_chunks; ++c) {
            chunk[2 * c + 1] = (unsigned)off;
            off += __popc(chunk[2 * c]);
        }
        n_live = off;
    }
    __syncthreads();
    for (int c = warp; c < n_chunks; c += WARPS) {
        const unsigned bal = chunk[2 * c];
        if (!((bal >> lane) & 1u)) continue;
        const int k = (int)chunk[2 * c + 1] + __popc(bal & ((1u << lane) - 1u));
        const float* r = rows + ((size_t)l * Sr + 32 * c + lane) * VIS_FIELDS;
        const float e1x = r[3], e1y = r[4], e1z = r[5];
        const float e2x = r[6], e2y = r[7], e2z = r[8];
        const float sx = o0 - r[0], sy = o1 - r[1], sz = o2 - r[2];
        // g_det = e2 x e1, g_u = e2 x s, g_v = s x e1 (jnp.cross's order)
        const float4 gd = make_float4(e2y * e1z - e2z * e1y, e2z * e1x - e2x * e1z,
                                      e2x * e1y - e2y * e1x, 0.0f);
        const float4 gu = make_float4(e2y * sz - e2z * sy, e2z * sx - e2x * sz,
                                      e2x * sy - e2y * sx, r[9]);
        const float4 gv = make_float4(sy * e1z - sz * e1y, sz * e1x - sx * e1z,
                                      sx * e1y - sy * e1x, 0.0f);
        const float t_num = (e2x * gv.x + e2y * gv.y) + e2z * gv.z;
        staged[3 * k] = make_float4(gd.x, gd.y, gd.z, t_num);
        staged[3 * k + 1] = gu;
        staged[3 * k + 2] = gv;
    }
    __syncthreads();
    const int n = n_live;
    // the recent occluders start as the rows that hit the segment from the
    // eye to a kept box's centre (a guess: any rows would keep the result);
    // below 4 OCC_CACHE rows a full scan costs no more than the cache
    if (n > 4 * OCC_CACHE) {
        const unsigned kept0 = any_col[0] & any_row[0], kept1 = any_col[1] & any_row[1];
        for (int e = 0; e < E; ++e) {
            if (!(((e < 32 ? kept0 : kept1) >> (e & 31)) & 1u)) continue;
            const float c0 = 0.5f * (ent[F_LO0 * MAX_E + e] + ent[F_HI0 * MAX_E + e]);
            const float c1 = 0.5f * (ent[F_LO1 * MAX_E + e] + ent[F_HI1 * MAX_E + e]);
            const float c2 = 0.5f * (ent[F_LO2 * MAX_E + e] + ent[F_HI2 * MAX_E + e]);
            for (int j = tid; j < n; j += THREADS) {
                if (occludes(staged, j, c0, c1, c2, 1.0f, 0.0f)) {
                    const unsigned k = atomicAdd(&occ_next, 1u);
                    if (k < OCC_CACHE) occ_cache[k] = j;
                }
            }
        }
        __syncthreads();
    }
    // 3 and 4: a warp a tile, one pixel a lane
    unsigned n_pairs = 0, n_slabs = 0, n_scans = 0, n_rows = 0;
    int hint = max(occ_cache[0], 0);  // the warp's last occluder found by a full scan
    for (int tile = warp; tile < ntx * nty; tile += WARPS) {
        const int ty = tile / ntx, tx = tile - ty * ntx;
        const unsigned k0 = keep[2 * tx] & keep[2 * (ntx + ty)];
        const unsigned k1 = keep[2 * tx + 1] & keep[2 * (ntx + ty) + 1];
        if (!(k0 | k1)) continue;
        n_pairs += __popc(k0) + __popc(k1);
        const int x = tx * TILE_W + (lane & (TILE_W - 1));
        for (int pass = 0; pass < TILE_H / PASS_ROWS; ++pass) {
            const int y = ty * TILE_H + pass * PASS_ROWS + lane / TILE_W;
            // the tile's survivors no pass has flagged, one value a warp
            const unsigned m0 = __shfl_sync(0xffffffffu, k0 & ~*(volatile unsigned*)&vis[0], 0);
            const unsigned m1 = __shfl_sync(0xffffffffu, k1 & ~*(volatile unsigned*)&vis[1], 0);
            if (!(m0 | m1)) break;
            const bool valid = x < W && y < H;
            float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
            if (valid) {
                const float xv = xs[x], yv = ys[y];
                d0 = (f0 + xv * r0) + yv * u0;
                d1 = (f1 + xv * r1) + yv * u1;
                d2 = (f2 + xv * r2) + yv * u2;
            }
            const float s0 = fabsf(d0) < 1e-12f ? 1e-12f : d0;
            const float s1 = fabsf(d1) < 1e-12f ? 1e-12f : d1;
            const float s2 = fabsf(d2) < 1e-12f ? 1e-12f : d2;
            for (int g = 0; g < 2; ++g) {
                unsigned m = g ? m1 : m0;
                while (m) {
                    const int e = 32 * g + __ffs(m) - 1;
                    m &= m - 1;
                    const float t1x = ent[F_LO0 * MAX_E + e] / s0;
                    const float t2x = ent[F_HI0 * MAX_E + e] / s0;
                    const float t1y = ent[F_LO1 * MAX_E + e] / s1;
                    const float t2y = ent[F_HI1 * MAX_E + e] / s1;
                    const float t1z = ent[F_LO2 * MAX_E + e] / s2;
                    const float t2z = ent[F_HI2 * MAX_E + e] / s2;
                    const float t_in =
                        fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
                    const float t_out =
                        fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
                    const bool hit = valid && t_in <= t_out && t_in > NEAR && t_in < FAR;
                    n_slabs += valid;
                    const unsigned hits = __ballot_sync(0xffffffffu, hit);
                    if (!hits) continue;
                    // 4. the occlusion scan: the block's recent occluders,
                    // then (where none hides the box) every row, the warp's
                    // lanes in lockstep from the row before its last find
                    int found = -1;
                    bool fresh = false;
                    if (hit) {
                        n_scans += 1;
                        const int n_cached = (int)min(*(volatile unsigned*)&occ_next, (unsigned)OCC_CACHE);
                        for (int q = 0; q < n_cached && found < 0; ++q) {
                            const int j = *(volatile int*)&occ_cache[q];
                            if (j < 0) continue;
                            n_rows += 1;
                            if (occludes(staged, j, d0, d1, d2, t_in)) found = j;
                        }
                        if (found < 0) {
                            int j = hint == 0 ? max(n - 1, 0) : hint - 1;
                            for (int c = 0; c < n; ++c) {
                                n_rows += 1;
                                if (occludes(staged, j, d0, d1, d2, t_in)) {
                                    found = j;
                                    fresh = true;
                                    break;
                                }
                                j = j + 1 == n ? 0 : j + 1;
                            }
                        }
                    }
                    const unsigned occ = __ballot_sync(0xffffffffu, found >= 0);
                    const unsigned new_occ = __ballot_sync(0xffffffffu, fresh);
                    if (new_occ) {  // the first lane's find joins the recent occluders
                        hint = __shfl_sync(0xffffffffu, found, __ffs(new_occ) - 1);
                        if (lane == 0 && n > 4 * OCC_CACHE)
                            occ_cache[atomicAdd(&occ_next, 1u) % OCC_CACHE] = hint;
                    }
                    if ((hits & ~occ) && lane == 0) atomicOr(&vis[g], 1u << (e & 31));
                }
            }
        }
    }
    if (stats != nullptr) {
        if (lane == 0) atomicAdd(&s_stats[S_PAIRS], (unsigned long long)n_pairs);
        atomicAdd(&s_stats[S_SLABS], (unsigned long long)n_slabs);
        atomicAdd(&s_stats[S_SCANS], (unsigned long long)n_scans);
        atomicAdd(&s_stats[S_ROWS], (unsigned long long)n_rows);
    }
    __syncthreads();
    for (int e = tid; e < E; e += THREADS)
        visible[(size_t)b * E + e] = (unsigned char)((vis[e >> 5] >> (e & 31)) & 1u);
    if (stats != nullptr && tid == 0) {
        atomicAdd(&stats[S_ENVS], 1ull);
        atomicAdd(&stats[S_STAGED], (unsigned long long)n);
        for (int s = S_PAIRS; s <= S_ROWS; ++s) atomicAdd(&stats[s], s_stats[s]);
    }
}

static int launch_visible_ents(
    const float* rows, const int* row_code, const int* layout_id, const float* wall_open,
    const float* origin, const float* fwd, const float* right, const float* up,
    const float* tan_xy, const float* xbase, const float* ybase, const float* ent_pos,
    const unsigned char* ent_alive, int B, int Sr, int E, int W, int H, int NW,
    unsigned char* visible, unsigned long long* stats, cudaStream_t stream)
{
    if (B < 0 || Sr <= 0 || E < 0 || E > MAX_E || W <= 0 || H <= 0 ||
        (NW > 0) != (wall_open != nullptr))
        return (int)cudaErrorInvalidValue;
    if (B == 0 || E == 0) return 0;
    const int ntx = (W + TILE_W - 1) / TILE_W, nty = (H + TILE_H - 1) / TILE_H;
    const size_t smem = ((size_t)3 * Sr + ntx + nty) * sizeof(float4) +
                        ((size_t)W + H + 2 * (ntx + nty) + 2 * ((Sr + 31) / 32)) * 4;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            visible_ents_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    visible_ents_kernel<<<B, THREADS, smem, stream>>>(
        rows, row_code, layout_id, wall_open, origin, fwd, right, up, tan_xy, xbase, ybase,
        ent_pos, ent_alive, Sr, E, W, H, NW, visible, stats);
    return (int)cudaGetLastError();
}

extern "C" int mw_visible_ents(
    const float* rows, const int* row_code, const int* layout_id, const float* wall_open,
    const float* origin, const float* fwd, const float* right, const float* up,
    const float* tan_xy, const float* xbase, const float* ybase, const float* ent_pos,
    const unsigned char* ent_alive, int B, int Sr, int E, int W, int H, int NW,
    unsigned char* visible, cudaStream_t stream)
{
    return launch_visible_ents(rows, row_code, layout_id, wall_open, origin, fwd, right, up,
                               tan_xy, xbase, ybase, ent_pos, ent_alive, B, Sr, E, W, H, NW,
                               visible, nullptr, stream);
}

// The same launch, also adding its counts to ``stats`` (N_STATS u64, in
// the order of S_ENVS ... S_STAGED; the caller zeroes it).
extern "C" int mw_visible_ents_stats(
    const float* rows, const int* row_code, const int* layout_id, const float* wall_open,
    const float* origin, const float* fwd, const float* right, const float* up,
    const float* tan_xy, const float* xbase, const float* ybase, const float* ent_pos,
    const unsigned char* ent_alive, int B, int Sr, int E, int W, int H, int NW,
    unsigned char* visible, unsigned long long* stats, cudaStream_t stream)
{
    return launch_visible_ents(rows, row_code, layout_id, wall_open, origin, fwd, right, up,
                               tan_xy, xbase, ybase, ent_pos, ent_alive, B, Sr, E, W, H, NW,
                               visible, stats, stream);
}

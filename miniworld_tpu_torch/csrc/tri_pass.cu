// Static-prim hit test, with the mesh-entity pass folded in: keyed-z
// winner and winner attributes per pixel.
//
// Replaces: miniworld_tpu/render/raycast.py:_tri_pass (single-chunk
// form, chunk_compete, the ``init`` seed of the carry, the multi-chunk
// scan with its carry, and the scan over a per-env ``chunk_sched``) and
// _entity_mesh_pass, XLA-fused jnp stages in the JAX package. The plain
// PyTorch versions are tri_pass_plain in miniworld_tpu_torch/render/
// raycast.py (with mesh=, entity_mesh_pass_plain seeding it), for more
// than one chunk tri_pass_chunked, and for a schedule tri_pass_scheduled;
// they agree bit for bit (the library is built with
// -fmad=false and the per-(row, pixel) arithmetic below follows the
// plain version operation by operation). The row culling has its own
// plain version, tile_cull_plain.
//
// What bounds it on an H100: per (env, pixel) it writes 4 bytes of t
// and 32 bytes of bf16 attributes (1.42 GB at an 8x8 maze's B = 8192,
// 80x60: 0.42 ms at 3.35 TB/s). A pixel passes the hit test for about 2
// of the maze's S = 608 paired rows, so the operations the data needs
// (22 per passing (row, pixel) pair) are far below the bytes; what the
// kernel adds on top is the cull pass (about 100 operations per (row,
// tile) survivor of the image test) and the scan of each tile's
// survivors (about 19 rows per 16x12 tile of a maze view). With mesh
// rows (PickupObjects' E*M = 80 per env) the output is the same 36 bytes
// a pixel; the mesh pass's seed no longer goes through device memory. A
// schedule (the 8x8 Maze's layout bank at B = 1024, 320x240 samples, 2
// chunks of 96 an env) writes the same 36 bytes a sample: 2.83 GB, 0.85
// ms at 3.35 TB/s.
//
// Design. A block owns one env and loops over screen tiles of TILE_W x
// TILE_H pixels (the last ones cut at the image's edge); at small B an
// env's tiles are spread over several blocks. The block
//   1. stages the env's rows once in shared memory, 12 floats each (three
//      float4: the camera-basis dots of g_det, g_u and g_v — separable
//      rays, g . d = g.fwd + xv * g.right + yv * g.up — then 1/t_num,
//      the kind and a pad), and keeps the rows that may hit the image
//      (the cull below, against the whole image) in a list;
//   2. per tile, culls that list against the tile's (xv, yv) box and
//      compacts the survivors with warp ballots (order does not matter:
//      the integer max of the keys is the same in any order);
//   3. scans only the survivors per pixel, PIX_PER_THREAD pixels of one
//      column per thread (their b * xv products are shared), with the
//      running z-key (r's bits with the low 10 mantissa bits replaced by
//      the row) in registers; ties go to the larger row through the
//      integer max. The winner's attribute row is loaded once, by index,
//      at the end (the JAX package used a one-hot matmul because TPU
//      gathers are slow; here it is one 64-byte read from L1/L2).
//
// The cull. A row can hit a pixel only where u >= 0, v >= 0, u <= det
// and v <= det (coverage max(u, v) + kind * min(u, v) >= max(u, v) for
// kind >= 0), det > 1e-12, and 1/FAR < r = det / t_num < 1/NEAR. Each of
// det, u, v is f = a + b xv + c yv, affine in the pixel's (xv, yv); the
// box's corners (the min and max of xv over the tile's columns and of yv
// over its rows) bound every pixel's exact value. The kernel computes
// f = (a + b xv) + c yv in three rounded operations, within
// ((1 + u)^3 - 1) M <= 3.01 u M of the exact value, u = 2^-24,
// M = |a| + |b| X + |c| Y, X and Y the largest |xv| and |yv| of the box.
// So a pixel's computed value lies within 6.02 u M of the corners'
// computed values (another 1.01 u (M_det + M_u) for the rounded
// difference det - u). The margin m = 2^-20 M + 1e-30 (16 u M, and a
// floor for subnormal rows) covers both, and a row is culled when, at
// all four corners, one of these holds:
//   u < -m_u;  v < -m_v;  det < -m_det (det <= 0 < 1e-12 everywhere);
//   det - u < -(m_det + m_u) or det - v < -(m_det + m_v)  (kind >= 0 or
//   all_quads);  1/t_num = 0 (r = 0 everywhere);
// or, the corners' det being finite, with D_hi = max det + m_det and
// D_lo = min det - m_det (r is det * (1/t_num), monotone in det):
//   D_hi / t_num <= 1/FAR,  or  D_lo / t_num >= 1/NEAR.
// A NaN fails every comparison, so it never culls. A culled row has
// z-key 0 on every pixel of the tile, and the per-pixel max over the
// survivors equals the max over all rows: the output is the full scan's,
// bit for bit.
//
// Mesh launch (mesh_v9 != nullptr; scenes with mesh entities, the MESH
// instance of the kernel): each env also has its own N world-space
// triangle rows (render/raycast.entity_mesh_rows). The block stages them
// once beside the static rows (kind 1.0, a triangle: coverage u + v <=
// det, which is max(u, v) + 1 * min(u, v) bit for bit, so the cull above
// holds for them unchanged), culls them against the image and per tile
// into lists of their own, and runs two competitions per pixel, as the
// JAX package does: first the mesh survivors give the mesh key, which is
// turned in registers into the seed the static rows start from, exactly
// as the mesh pass's t round trip did (t = 1/max(r, 1e-30), inf on a
// miss; seed key = the bits of 1/t with the row bits all ones, so the
// seed wins quantized-depth ties). A static row replaces it only with a
// strictly greater key; a pixel the seed keeps gets the bf16 of the mesh
// winner's attribute row, zeros where the mesh missed too. One merged
// max over both row sets would break that tie rule, so the two stay
// apart. The unmeshed instance compiles without any of it.
//
// Paired launch (pg_wall != nullptr; procgen mazes, the paired bank of
// scene/supermaze.py and raycast.py:259-295 / 1206-1219): every row has
// a primary and an alternative variant. Row s of env b takes the primary
// where pg_wall[s] < 0 (no wall) or its wall is open in wall_open[b],
// the alternative (the wall's closed quads) otherwise. The staging loop
// picks the variant before computing the row's coefficients and keeps
// the choice as one byte per row, so the winner's attributes come from
// its variant.
//
// Multi-chunk launch (S > tri_chunk, tri_pass_multi_kernel; dense banks
// wider than one chunk, e.g. Sidewalk's S = 3,072 in chunks of 1,024, and
// the paired bank of an 8x8 procgen maze, Sp = 608 in chunks of 496): the
// JAX package scans chunks of tri_chunk rows, keys each row by its index
// WITHIN its chunk, and carries a chunk's winner only on a strictly
// greater key. So of two rows at the same key (equal quantized depth,
// same chunk-local index) the earlier chunk wins. Chunk c starts at row
// c * tri_chunk, the last one clamped to S - tri_chunk (dynamic_slice
// clamps its start; raycast.py:252-269): with Sp = 608, chunk 1 reads
// rows 112-607 at local indices 0-495, so rows 112-495 compete in both
// chunks. A row read by two chunks takes the first one only: its second
// occurrence has the same depth bits and a smaller local index (s - (S -
// tri_chunk) < s - (n - 2) tri_chunk, as S > (n - 1) tri_chunk for n
// chunks), so its key is below the first's and it never wins the chunk
// loop. Each row s is staged once, keyed by its first chunk's local
// index, with s itself beside it.
//
// What bounded the one-block-per-env design here: it staged all S rows
// of its env in shared memory, 52 bytes a row (160 KB at Sidewalk's S =
// 3,072: one 3-warp block an SM), and every 16x12 tile culled the whole
// image list (~900 rows on a Sidewalk view, ~260 on a Maze view at
// 160x120 samples, where a tile keeps ~5) with three barriers a tile. So
// the launch waited on latency with a few warps an SM, and on the Maze
// at 160x120 samples it spent as much on the per-tile culls as on the
// scan.
//
// Design. A block of GROUP_X x GROUP_Y tiles in flight (3 warps a tile)
// streams its env's rows through a fixed window of WINDOW_ROWS staged
// rows (48 bytes each), so its shared memory does not depend on S:
//   1. each thread stages one row in registers, culls it against the
//      image's box and, if it survives, appends it to the window in row
//      order (an ordered compaction: one ballot a warp, the warps' counts
//      summed in warp order after one barrier; the count stays in a
//      register of every thread). When a batch would overflow the window,
//      the window is scanned first (2-4) and emptied, and the batch
//      restaged into it.
//   2. For each group of tiles the block owns: the window's rows culled
//      against the group's box (the union of its tiles' boxes: any box is
//      sound for the corner test below), again with an ordered compaction,
//      into a list of window slots;
//   3. each tile culls the group's list against its own box into a bit
//      mask (one ballot a warp, no atomics), in the list's order;
//   4. each pixel scans its tile's mask in order with a 32-bit z-key and a
//      strict >: rows arrive in ascending s, so in ascending first chunk,
//      and of equal keys the first, the earlier chunk's, stays; two rows
//      of one chunk never share a key (the local index is in its low
//      bits). This is the chunk loop's winner: the lexicographic max of
//      (key, -chunk), without the 64-bit key of the one-block design.
// Windows are scanned in row order too, so an env with more survivors
// than WINDOW_ROWS gets the same winner: a pixel's (key, row) carry goes
// from one window to the next through the first 8 bytes of its own
// attribute row in attr_out (the block owns its tiles' pixels; nothing
// else touches them until the last window stores the winner there), and
// the next window starts its scan from it. A pixel no row hits gets t =
// inf and zero attributes. On a paired bank the staging picks each row's
// variant, and the store picks the winner's again from its wall (the
// same expression). S <= 4096 and tri_chunk >= 16 (the wrapper).
//
// What bounds the windowed kernel (PERF.md): on a Sidewalk view each
// pixel still scans the ~65 rows its 16x12 tile keeps (a Sidewalk view
// keeps ~850 rows of 3,072, a fifth of the views more than one window),
// far above the bytes (36 a pixel); at the 8x8 maze's 160x120 samples a
// tile keeps ~5 rows and the time is twice the bytes' bound, with 71
// registers leaving two 12-warp blocks an SM and five barriers a group.
//
// The single-chunk launches without mesh rows could run the same kernel
// with tri_chunk = S (every key's local index is its row); measured, it
// was slower than the one-block kernel at the 8x8 maze's B = 8192
// (PERF.md), so the single-chunk, MESH and SCHED launches keep that
// kernel.

// Scheduled launch (n_sched > 0, the SCHED instances; raycast.py:133-145,
// 234-259, 1166-1172): the bank is one-chunk rows, (C, 9, S) and (C, S,
// 16), and layout_id is each env's (B, n_sched) schedule, the chunk rows
// it scans in order (render/raycast.chunk_schedule: packed PVS, chunk_vis,
// or a dense scan seeded by mesh rows). The block stages all n_sched * S
// rows of its schedule, each ranked by its position j in the schedule and
// its index in the chunk, (254 - j) << 10 | local, so that the unsigned
// max of the 64-bit (key << 8) | (254 - j) gives the chunk loop's winner
// in any scan order: the larger key, then the earlier position. A chunk the schedule repeats
// (a clamped or padded slot) has the same keys at a later position, so it
// can never win: its rows are staged but not listed. With mesh rows the
// seed ranks (seed key << 8) | 255, above every position at an equal key,
// as JAX's carry keeps its init against a chunk's equal key. The winner's
// row is chunk row sched[j] * S + local. n_sched <= 255 and n_sched * S
// <= 4096.

// Texture-variant override (slot_key != nullptr, the OVERRIDE instances;
// domain randomization, raycast.py:277-310): the JAX package replaces
// every scanned row's slot column by base + min(floor(hash01(key, id) *
// count), count - 1), -1 where base < 0, before its competition. The
// competition reads only the vertices and the kind column, and the
// override is a function of the row alone, so the kernel selects first
// and overrides only the winner, at its attribute store: one hash and one
// 16-byte load of the row's (id, base, count, 0) per pixel, not per
// (row, pixel). slot_key[b] is the
// env's u32 key (EnvState.tri_slots); slot_tex is indexed like attr, by
// the global row (the packed-PVS plan's chunk rows arrive as a bank of
// one-chunk layouts);
// on a paired bank slot_tex_alt holds the alternative variants' rows,
// picked by use_alt as the attributes are. A mesh winner keeps its own
// slot, as the JAX package's seed does.
//
// Float32 carry (f32 != 0, the F32 instances; raycast.py:512-528): the
// JAX package carries the winner's attribute row in float32 where its
// slot column can hold ids above 256, which bf16 would round: in nearest
// mode more than 256 layout-local slot ids (the 8x8 procgen maze's 528),
// in fourier mode an atlas of more than 256 rows. The F32 instances store
// the row's 16 floats as they are, 64 bytes in place of the 32 bytes of
// bf16, at every store site (the mesh winner's and the override's
// included); the competition is the same code. Every launch has them:
// with and without MESH, SCHED and OVERRIDE, and the multi-chunk kernel
// with and without OVERRIDE.
//
// Winner store. Written straight from each thread, a pixel's row leaves
// as four 16-byte stores (two in bf16) at the row's stride: one warp store
// instruction then scatters 32 pieces over 2 KB of attr_out (64-byte rows),
// and the F32 launches that the store dominates ran at 2-2.5x their bf16
// twins (a schedule at 320x240 samples, mesh rows at B = 1024; PERF.md).
// The staged store (F32 instances, block_staged()) goes through shared
// memory instead. A warp's 32 lanes hold one pixel each of 32 / TILE_W whole tile
// rows, and each tile row's TILE_W pixels are contiguous in attr_out
// (TILE_W * 64 bytes in F32). So each warp writes its pixels' rows into a
// buffer of its own laid out as the output (2 KB in F32), lane l's row at
// row slot l, its 16-byte chunks in an order rotated by (l * chunks) / 8
// so that the 8 lanes of a quarter-warp write 8 distinct bank quads (no
// conflict); then, after a warp barrier, the buffer leaves in stores of
// 512 contiguous bytes an instruction. A miss stages a zero row; the
// override's slot column is hashed once a pixel and written into the
// buffer with the rest. The multi-chunk kernel's (key, row) carry between
// windows stays in the pixel's first 8 bytes of attr_out; only the last
// window's store is staged. Bulk copies by the TMA engine
// (cp.async.bulk, a tile row each) in place of the warp's stores were
// exact and never faster (PERF.md).
//
// Dense super-bank kill (row_code != nullptr, the ACTIVE instances; a
// procgen maze rendered from its dense rows, without the paired ones,
// raycast.py:321-356, 483-485, 1220-1227): the JAX package multiplies each
// row's 1/t_num by the env's tri_active = tri_active_base + wall_open @
// tri_wall_onehot, exact 0/1, so that a killed row's r is 0 and fails the
// r > 1/FAR gate on every pixel: its key is 0 everywhere. The kernels read
// the row's code (render/raycast.wall_codes) and the env's wall_open
// (maze_row.cuh row_live, the test the top view's and visible_ents' scans
// make) and drop a killed row at staging. A row that never hits changes
// no pixel's max, in one chunk or over several. The one-block kernel
// reads the codes first and compacts the live rows in two passes: every
// code of the thread's rows and the env's walls they name read at once,
// the live rows listed; then only those staged (no vertex is read for a
// killed row), their image survivors compacted into at most n_live slots,
// the bank's largest live count (render/raycast.live_row_bound, which the
// wrapper takes from these codes, so no env exceeds it), each with its
// row index s in the pad of its third float4
// (as SCHED keeps its rank there): the z-key's low bits and the winner's
// store use s, so every tie resolves as in the dense scan. Built without
// MESH and SCHED (JAX asserts a dense scan; no procgen id has mesh
// entities): the single-chunk and the multi-chunk kernel, each with and
// without OVERRIDE and F32.
//
// Shared memory of the one-block-per-env kernel (single chunk, MESH,
// SCHED): 48 bytes per staged row, two 2-byte row lists and (paired) the
// variant byte (SCHED: 4 bytes per schedule slot), and 52 bytes per mesh
// row, and the warps' store buffers (where staged: 3 x 2 KB): 53,248 B
// at S = 1024, 106,496 B with N = 1024 mesh
// rows besides, above the 48 KB default, so the launch raises the
// kernel's dynamic limit when it needs more (up to 212,992 B at n_sched *
// S = 4,096, and the buffers). The multi-chunk kernel takes WINDOW_ROWS *
// 50 bytes and a bit per window row a tile, 51,712 B at 1,024 rows and 2 x
// 2 tiles whatever S is, and its 12 warps' store buffers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "maze_row.cuh"
#include "rng.cuh"

#ifndef TILE_W
#define TILE_W 16
#endif
#ifndef TILE_H
#define TILE_H 12
#endif
#ifndef PIX_PER_THREAD
#define PIX_PER_THREAD 2
#endif
// 16x12 tiles of 2 pixels per thread (96 threads) came out fastest at an
// 8x8 maze's B = 8192 and PickupObjects' B = 4096 among the builds
// chip_smoke.py's tile sweep times (PERF.md).
#define THREADS (TILE_W * TILE_H / PIX_PER_THREAD)
#define ROWS_PER_THREAD_Y (TILE_H / PIX_PER_THREAD)
static_assert(TILE_H % PIX_PER_THREAD == 0, "a thread's pixels share one tile column");
static_assert(THREADS % 32 == 0 && THREADS >= 64, "whole warps, two for the box");
static_assert(TILE_W <= 32 && TILE_H <= 32, "one warp reduces a tile's columns / rows");
static_assert(32 % TILE_W == 0, "a warp holds whole tile rows (the staged store)");

#define ATTR_DIM 16
#define IDX_MASK 0x3FF
// blocks a launch aims for: at small B an env's tiles spread over blocks
#define BLOCK_TARGET 1024

struct Box {
    float xlo, xhi, ylo, yhi;
};

__device__ __forceinline__ float lin(float a, float b, float c, float x, float y) {
    return (a + b * x) + c * y;
}

// True when the row (three float4 of staged fields) provably misses
// every pixel whose (xv, yv) lies in the box; see the header.
__device__ __forceinline__ bool row_culled(const float4 r0, const float4 r1, const float4 r2,
                                           const Box bx, const bool all_quads) {
    const float rel = 9.5367431640625e-07f;  // 2^-20
    const float floor_abs = 1e-30f;
    const float xm = fmaxf(fabsf(bx.xlo), fabsf(bx.xhi));
    const float ym = fmaxf(fabsf(bx.ylo), fabsf(bx.yhi));
    const float md = ((fabsf(r0.x) + fabsf(r0.y) * xm) + fabsf(r0.z) * ym) * rel + floor_abs;
    const float mu = ((fabsf(r0.w) + fabsf(r1.x) * xm) + fabsf(r1.y) * ym) * rel + floor_abs;
    const float mv = ((fabsf(r1.z) + fabsf(r1.w) * xm) + fabsf(r2.x) * ym) * rel + floor_abs;
    const float mdu = md + mu, mdv = md + mv;
    const float inv = r2.y;
    const bool cov_ok = all_quads || r2.z >= 0.0f;
    bool u_out = true, v_out = true, d_out = true, du_out = true, dv_out = true, finite = true;
    float d_hi = -INFINITY, d_lo = INFINITY;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const float x = (c & 2) ? bx.xhi : bx.xlo;
        const float y = (c & 1) ? bx.yhi : bx.ylo;
        const float d = lin(r0.x, r0.y, r0.z, x, y);
        const float u = lin(r0.w, r1.x, r1.y, x, y);
        const float v = lin(r1.z, r1.w, r2.x, x, y);
        u_out = u_out && u < -mu;
        v_out = v_out && v < -mv;
        d_out = d_out && d < -md;
        du_out = du_out && (d - u) < -mdu;
        dv_out = dv_out && (d - v) < -mdv;
        finite = finite && isfinite(d);
        d_hi = fmaxf(d_hi, d);
        d_lo = fminf(d_lo, d);
    }
    const float r_near = (float)(1.0 / 0.04);  // 1 / NEAR
    const float r_far = (float)(1.0 / 100.0);  // 1 / FAR
    bool cull = u_out || v_out || d_out || !(inv > 0.0f) || (cov_ok && (du_out || dv_out));
    cull = cull || (finite && ((d_hi + md) * inv <= r_far || (d_lo - md) * inv >= r_near));
    return cull;
}

// A slot among the lanes with keep (valid where keep holds): one ballot
// and one shared atomic on count per warp. Every lane of the warp calls it.
__device__ __forceinline__ int claim(const bool keep, int* count) {
    const int lane = threadIdx.x & 31;
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(count, __popc(m));
    base = __shfl_sync(0xffffffffu, base, 0);
    return base + __popc(m & ((1u << lane) - 1u));
}

// Appends s to list where keep holds. Every lane of the warp calls it.
__device__ __forceinline__ void append(const bool keep, const int s, unsigned short* list,
                                       int* count) {
    const int at = claim(keep, count);
    if (keep) list[at] = (unsigned short)s;
}

struct CamBasis {
    float ox, oy, oz, f0, f1, f2, r0, r1, r2, u0, u1, u2;
};

// The staged fields of row s of v9 ((9, n) component-major) for the
// camera: the basis dots of g_det, g_u and g_v, 1/t_num (0 where t_num
// <= 0), the kind and a pad (0; the caller's row rank), as three float4.
__device__ __forceinline__ void stage_row(const float* v9, const int n, const int s,
                                          const CamBasis& c, const float kind, float4& q0,
                                          float4& q1, float4& q2) {
    const float e1x = v9[3 * n + s] - v9[s];
    const float e1y = v9[4 * n + s] - v9[n + s];
    const float e1z = v9[5 * n + s] - v9[2 * n + s];
    const float e2x = v9[6 * n + s] - v9[s];
    const float e2y = v9[7 * n + s] - v9[n + s];
    const float e2z = v9[8 * n + s] - v9[2 * n + s];
    const float sx = c.ox - v9[s];
    const float sy = c.oy - v9[n + s];
    const float sz = c.oz - v9[2 * n + s];
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
    q0 = make_float4(gdx * c.f0 + gdy * c.f1 + gdz * c.f2, gdx * c.r0 + gdy * c.r1 + gdz * c.r2,
                     gdx * c.u0 + gdy * c.u1 + gdz * c.u2, gux * c.f0 + guy * c.f1 + guz * c.f2);
    q1 = make_float4(gux * c.r0 + guy * c.r1 + guz * c.r2, gux * c.u0 + guy * c.u1 + guz * c.u2,
                     gvx * c.f0 + gvy * c.f1 + gvz * c.f2, gvx * c.r0 + gvy * c.r1 + gvz * c.r2);
    q2 = make_float4(gvx * c.u0 + gvy * c.u1 + gvz * c.u2, t_num > 0.0f ? 1.0f / t_num : 0.0f,
                     kind, 0.0f);
}

// t of a z-key: 1/r of its depth bits, inf for 0 (no hit)
__device__ __forceinline__ float t_of_key(const int key) {
    return key > 0 ? 1.0f / fmaxf(__int_as_float(key & ~IDX_MASK), 1e-30f) : INFINITY;
}

// two floats rounded to bf16 (nearest even), a first, as 32 bits
__device__ __forceinline__ unsigned bf16x2(const float a, const float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&h);
}

// min / max over the warp's lanes
__device__ __forceinline__ void warp_span(float& lo, float& hi) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
}

// The atlas row of a prim's texture variant under the env's key, from
// its (slot id, atlas base, variant count, 0): raycast.variant_slots.
__device__ __forceinline__ float variant_slot(const float4 t, const unsigned key) {
    if (!(t.y >= 0.0f)) return -1.0f;  // no texture
    const float u = hash01(key, (unsigned)(int)t.x);
    return t.y + fminf(floorf(u * t.z), t.z - 1.0f);
}

// 16 floats of an attribute row, rounded to bf16, to 32 bytes at dst;
// with tex != nullptr the slot column (14) is the row's texture variant
// under key
__device__ __forceinline__ void store_attr_bf16(const float* src_row, __nv_bfloat16* dst,
                                                const float4* tex = nullptr,
                                                const unsigned key = 0u) {
    const float4* src = reinterpret_cast<const float4*>(src_row);
    const float4 a0 = src[0], a1 = src[1], a2 = src[2], a3 = src[3];
    const float slot = tex != nullptr ? variant_slot(*tex, key) : a3.z;
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    d4[0] = make_uint4(bf16x2(a0.x, a0.y), bf16x2(a0.z, a0.w),
                       bf16x2(a1.x, a1.y), bf16x2(a1.z, a1.w));
    d4[1] = make_uint4(bf16x2(a2.x, a2.y), bf16x2(a2.z, a2.w),
                       bf16x2(a3.x, a3.y), bf16x2(slot, a3.w));
}

// 16 floats of an attribute row as they are, to 64 bytes at dst; the
// slot column as in store_attr_bf16
__device__ __forceinline__ void store_attr_f32(const float* src_row, float* dst,
                                               const float4* tex = nullptr,
                                               const unsigned key = 0u) {
    const float4* src = reinterpret_cast<const float4*>(src_row);
    float4 a3 = src[3];
    if (tex != nullptr) a3.z = variant_slot(*tex, key);
    float4* d4 = reinterpret_cast<float4*>(dst);
    d4[0] = src[0];
    d4[1] = src[1];
    d4[2] = src[2];
    d4[3] = a3;
}

// 16-byte chunks of an attribute row in the carry dtype: 4 of floats, or
// 2 of floats rounded to bf16
template <bool F32>
struct Carry {
    static constexpr int CHUNKS = F32 ? 4 : 2;
};

// The staged store (header: "Winner store"): the lane's row (src_row;
// nullptr: a zero row) into slot ``lane`` of the warp's buffer of 32 rows,
// laid out as the output, in 16-byte chunks rotated by the lane, so that
// the 8 lanes of a quarter-warp write 8 distinct bank quads. The slot
// column's variant is hashed once, ahead of the rotated loop (inside it,
// the lanes would each take the hash at another iteration).
template <bool F32>
__device__ __forceinline__ void stage_attr(uint4* wbuf, const int lane, const float* src_row,
                                           const float4* tex, const unsigned key) {
    constexpr int CH = Carry<F32>::CHUNKS;
    const float4* src = reinterpret_cast<const float4*>(src_row);
    const float slot = src != nullptr && tex != nullptr ? variant_slot(*tex, key) : 0.0f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
        const int c = (i + ((lane * CH) >> 3)) & (CH - 1);  // the chunk this lane writes now
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (src != nullptr) {
            if (F32) {
                float4 a = src[c];
                if (tex != nullptr && c == CH - 1) a.z = slot;
                v = make_uint4(__float_as_uint(a.x), __float_as_uint(a.y), __float_as_uint(a.z),
                               __float_as_uint(a.w));
            } else {
                const float4 a0 = src[2 * c], a1 = src[2 * c + 1];
                const float s14 = tex != nullptr && c == CH - 1 ? slot : a1.z;
                v = make_uint4(bf16x2(a0.x, a0.y), bf16x2(a0.z, a0.w), bf16x2(a1.x, a1.y),
                               bf16x2(s14, a1.w));
            }
        }
        wbuf[lane * CH + c] = v;
    }
}

// The winner's row of pixel q (src_row): staged (STAGED, the lane's slot
// of the warp's buffer wbuf) or straight to attr_out, in the instance's
// carry dtype
template <bool F32, bool STAGED>
__device__ __forceinline__ void put_attr(const float* src_row, void* attr_out, const size_t q,
                                         uint4* wbuf, const int lane,
                                         const float4* tex = nullptr, const unsigned key = 0u) {
    if (STAGED) stage_attr<F32>(wbuf, lane, src_row, tex, key);
    else if (F32) store_attr_f32(src_row, static_cast<float*>(attr_out) + q * ATTR_DIM, tex, key);
    else store_attr_bf16(src_row, static_cast<__nv_bfloat16*>(attr_out) + q * ATTR_DIM, tex, key);
}

// All-zero attributes for pixel q, a miss of a seeded, scheduled or
// multi-chunk scan, as put_attr puts a row
template <bool F32, bool STAGED>
__device__ __forceinline__ void put_zero(void* attr_out, const size_t q, uint4* wbuf,
                                         const int lane) {
    if (STAGED) {
        stage_attr<F32>(wbuf, lane, nullptr, nullptr, 0u);
    } else {
        uint4* d4 = reinterpret_cast<uint4*>(attr_out) + q * Carry<F32>::CHUNKS;
#pragma unroll
        for (int i = 0; i < Carry<F32>::CHUNKS; ++i) d4[i] = make_uint4(0u, 0u, 0u, 0u);
    }
}

// The warp's staged rows to attr_out: nrows tile rows of ncols pixels, the
// first at pixel q0 of attr_out, the next ones W pixels on; each tile row
// is contiguous there, so each store instruction writes 512 contiguous
// bytes. Every lane of the warp calls it, after its stage_attr (or none,
// for a pixel outside the image).
template <bool F32>
__device__ __forceinline__ void rows_out(const uint4* wbuf, void* attr_out, const size_t q0,
                                         const int W, const int ncols, const int nrows,
                                         const int lane) {
    constexpr int CH = Carry<F32>::CHUNKS;
    constexpr int PER_ROW = TILE_W * CH;  // 16-byte units a tile row
    uint4* out = reinterpret_cast<uint4*>(attr_out);
    __syncwarp();
#pragma unroll
    for (int u = lane; u < 32 * CH; u += 32) {
        const int r = u / PER_ROW, v = u - r * PER_ROW;
        if (r < nrows && v < ncols * CH) out[(q0 + (size_t)r * W) * CH + v] = wbuf[u];
    }
    __syncwarp();  // the buffer may be rewritten
}

// The one-block kernel's instances that stage their winners (header:
// "Winner store"): the float32 carry's with mesh rows, a schedule or the
// kill. Its plain and paired F32 scans keep the direct store: staged, the
// paired launch ran 3-5% slower at the Maze B = 8192, as did every bf16
// instance, by 1-13% (PERF.md). The multi-chunk kernel stages every F32
// instance.
template <bool MESH, bool SCHED, bool F32, bool ACTIVE>
__host__ __device__ constexpr bool block_staged() {
    return F32 && (MESH || SCHED || ACTIVE);
}

// Bytes of a warp's store buffer: 32 rows of the carry, where it stages
template <bool F32, bool STAGED>
__host__ __device__ constexpr size_t warp_buf_bytes() {
    return STAGED ? (size_t)32 * 16 * Carry<F32>::CHUNKS : 0;
}

template <bool MESH, bool SCHED, bool OVERRIDE, bool F32, bool ACTIVE>
__global__ void __launch_bounds__(THREADS) tri_pass_kernel(
    const float* __restrict__ verts9,   // (L, 9, S) component-major; SCHED (C, 9, S)
    const float* __restrict__ attr,     // (L, S, 16); SCHED (C, S, 16)
    const int* __restrict__ layout_id,  // (B,); SCHED (B, n_sched) chunk rows
    const float* __restrict__ origin,   // (B, 3)
    const float* __restrict__ fwd,      // (B, 3)
    const float* __restrict__ right,    // (B, 3)
    const float* __restrict__ up,       // (B, 3)
    const float* __restrict__ tan_xy,   // (B, 2)
    const float* __restrict__ xbase,    // (W,)
    const float* __restrict__ ybase,    // (H,)
    const float* __restrict__ mesh_v9,    // (B, 9, N), MESH only
    const float* __restrict__ mesh_attr,  // (B, N, 16), MESH only
    const float* __restrict__ verts9_alt,  // (L, 9, S) or null
    const float* __restrict__ attr_alt,   // (L, S, 16) or null
    const int* __restrict__ pg_wall,      // (L, S) or null; -1 = no wall
    const float* __restrict__ wall_open,  // (B, Wn) or null; 1 = open
    const unsigned* __restrict__ slot_key,   // (B,) or null: no override
    const float4* __restrict__ slot_tex,     // (L, S) (id, base, count, 0)
    const float4* __restrict__ slot_tex_alt,  // (L, S), paired only
    const int* __restrict__ row_code,     // (L, S), ACTIVE only (wall_codes)
    int S, int N, int W, int H, int Wn, int all_quads,
    int n_sched,                        // SCHED only: chunks a schedule
    int n_live,                         // ACTIVE only: slots for staged rows
    float* __restrict__ t_out,          // (B, HW)
    void* __restrict__ attr_out)        // (B, HW, 16) bf16, or f32 (F32)
{
    constexpr bool RANKED = SCHED;  // hits ranked by (key, -position)
    constexpr bool STAGED = block_staged<MESH, SCHED, F32, ACTIVE>();
    const int n_scan = SCHED ? n_sched * S : S;  // rows read
    const int n_rows = ACTIVE ? n_live : n_scan;  // rows staged
    // the warps' store buffers (STAGED), then 3 x n_rows float4 and (MESH)
    // 3 x N, then the lists
    extern __shared__ float4 smem[];
    uint4* wbufs = reinterpret_cast<uint4*>(smem);
    float4* rows = smem + (THREADS / 32) * warp_buf_bytes<F32, STAGED>() / sizeof(float4);
    float4* mrows = rows + 3 * n_rows;
    unsigned short* env_list = reinterpret_cast<unsigned short*>(mrows + (MESH ? 3 * N : 0));
    unsigned short* tile_list = env_list + n_rows;
    unsigned short* menv_list = tile_list + n_rows;
    unsigned short* mtile_list = menv_list + (MESH ? N : 0);
    unsigned char* use_alt = reinterpret_cast<unsigned char*>(mtile_list + (MESH ? N : 0));
    int* sched_s = reinterpret_cast<int*>(use_alt);  // SCHED (never paired): the schedule
    __shared__ Box box;
    __shared__ int n_env, n_tile, m_env, m_tile;

    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int lid = SCHED ? 0 : layout_id[b];  // SCHED: rows are indexed by chunk row
    const bool paired = pg_wall != nullptr;
    const bool quads = all_quads != 0;
    const float* v9p = verts9 + (size_t)lid * 9 * S;
    const float* atp = attr + (size_t)lid * S * ATTR_DIM;
    const float* v9a = paired ? verts9_alt + (size_t)lid * 9 * S : nullptr;
    const float* ata = paired ? attr_alt + (size_t)lid * S * ATTR_DIM : nullptr;
    const float tan_x = tan_xy[2 * b], tan_y = tan_xy[2 * b + 1];
    const unsigned env_key = OVERRIDE ? slot_key[b] : 0u;
    const float4* txp = OVERRIDE ? slot_tex + (size_t)lid * S : nullptr;
    const float4* txa = OVERRIDE && paired ? slot_tex_alt + (size_t)lid * S : nullptr;

    // the whole image's box: warp 0 over the columns, warp 1 over the rows
    if (warp < 2) {
        const int n = warp == 0 ? W : H;
        const float* base = warp == 0 ? xbase : ybase;
        const float tn = warp == 0 ? tan_x : tan_y;
        float lo = INFINITY, hi = -INFINITY;
        for (int i = lane; i < n; i += 32) {
            const float v = base[i] * tn;
            lo = fminf(lo, v);
            hi = fmaxf(hi, v);
        }
        warp_span(lo, hi);
        if (lane == 0) {
            if (warp == 0) { box.xlo = lo; box.xhi = hi; }
            else { box.ylo = lo; box.yhi = hi; }
        }
    }
    if (tid == 0) {
        n_env = 0;
        m_env = 0;
    }
    if (SCHED)
        for (int j = tid; j < n_sched; j += THREADS) sched_s[j] = layout_id[(size_t)b * n_sched + j];
    __syncthreads();
    const Box image = box;

    // 1. stage every row; list the ones that may hit the image
    {
        const CamBasis cb{origin[3 * b], origin[3 * b + 1], origin[3 * b + 2],
                          fwd[3 * b], fwd[3 * b + 1], fwd[3 * b + 2],
                          right[3 * b], right[3 * b + 1], right[3 * b + 2],
                          up[3 * b], up[3 * b + 1], up[3 * b + 2]};
        if (ACTIVE) {
            // the rows live in the env, from their codes alone: every code and
            // wall of the thread's rows read at once, the live ones listed
            // (the tile list is free until the tiles)
            constexpr int PER_THREAD = (IDX_MASK + THREADS) / THREADS;  // S <= 1024
            int code[PER_THREAD];
#pragma unroll
            for (int j = 0; j < PER_THREAD; ++j) {
                const int s = j * THREADS + tid;
                code[j] = s < S ? row_code[(size_t)lid * S + s] : -2;
            }
            bool live[PER_THREAD];
#pragma unroll
            for (int j = 0; j < PER_THREAD; ++j) live[j] = row_live(code[j], wall_open, b, Wn);
#pragma unroll
            for (int j = 0; j < PER_THREAD; ++j) {
                const int at = claim(live[j], &m_env);  // m_env: ACTIVE has no mesh rows
                if (live[j]) {
                    // never true: n_live is the codes' own bound (the wrapper's)
                    if (at >= n_rows) __trap();
                    tile_list[at] = (unsigned short)(j * THREADS + tid);
                }
            }
            __syncthreads();
            // only the live rows staged: their image survivors compacted, each
            // with its row in the pad
            const int n_alive = m_env;
            for (int i0 = 0; i0 < n_alive; i0 += THREADS) {
                const int i = i0 + tid;
                float4 q0, q1, q2;
                bool keep = false;
                if (i < n_alive) {
                    const int s = tile_list[i];
                    stage_row(v9p, S, s, cb, atp[s * ATTR_DIM + 15], q0, q1, q2);
                    q2.w = __int_as_float(s);
                    keep = !row_culled(q0, q1, q2, image, quads);
                }
                const int at = claim(keep, &n_env);
                if (keep) {
                    rows[3 * at] = q0;
                    rows[3 * at + 1] = q1;
                    rows[3 * at + 2] = q2;
                    env_list[at] = (unsigned short)at;
                }
            }
        }
        for (int s0 = 0; !ACTIVE && s0 < n_scan; s0 += THREADS) {  // every row read
            const int s = s0 + tid;
            bool keep = false;
            if (s < n_scan) {
                float4 q0, q1, q2;
                bool first = true;  // SCHED: the row's chunk not read at an earlier position
                if (SCHED) {  // row `local` of the chunk at position j, ranked by both
                    const int j = s / S, local = s - j * S, cid = sched_s[j];
                    stage_row(verts9 + (size_t)cid * 9 * S, S, local, cb,
                              attr[((size_t)cid * S + local) * ATTR_DIM + 15], q0, q1, q2);
                    q2.w = __int_as_float(((254 - j) << 10) | local);
                    for (int i = 0; i < j; ++i) first = first && sched_s[i] != cid;
                } else {
                    bool alt = false;
                    if (paired) {
                        const int w = pg_wall[(size_t)lid * S + s];
                        alt = w >= 0 && !(wall_open[(size_t)b * Wn + w] > 0.5f);
                        use_alt[s] = alt;
                    }
                    stage_row(alt ? v9a : v9p, S, s, cb, (alt ? ata : atp)[s * ATTR_DIM + 15],
                              q0, q1, q2);
                }
                rows[3 * s] = q0;
                rows[3 * s + 1] = q1;
                rows[3 * s + 2] = q2;
                keep = first && !row_culled(q0, q1, q2, image, quads);
            }
            append(keep, s, env_list, &n_env);
        }
        if (MESH) {  // the env's own triangle rows
            const float* mv9 = mesh_v9 + (size_t)b * 9 * N;
            for (int s0 = 0; s0 < N; s0 += THREADS) {
                const int s = s0 + tid;
                bool keep = false;
                if (s < N) {
                    float4 q0, q1, q2;
                    stage_row(mv9, N, s, cb, 1.0f, q0, q1, q2);
                    mrows[3 * s] = q0;
                    mrows[3 * s + 1] = q1;
                    mrows[3 * s + 2] = q2;
                    keep = !row_culled(q0, q1, q2, image, false);
                }
                append(keep, s, menv_list, &m_env);
            }
        }
    }
    __syncthreads();
    const int ne = n_env;
    const int nme = MESH ? m_env : 0;

    const int hw = W * H;
    const int n_tx = (W + TILE_W - 1) / TILE_W;
    const int n_tiles = n_tx * ((H + TILE_H - 1) / TILE_H);
    const int col = tid % TILE_W, row0 = tid / TILE_W;
    const float r_near = (float)(1.0 / 0.04);  // 1 / NEAR
    const float r_far = (float)(1.0 / 100.0);  // 1 / FAR

    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int x0 = (t % n_tx) * TILE_W, y0 = (t / n_tx) * TILE_H;
        // 2. the tile's box (warp 0: its columns, warp 1: its rows), then
        // the survivors of the image list
        if (warp < 2) {
            const int i = (warp == 0 ? x0 : y0) + lane;
            const bool in = warp == 0 ? (lane < TILE_W && i < W) : (lane < TILE_H && i < H);
            const float v = in ? (warp == 0 ? xbase[i] * tan_x : ybase[i] * tan_y) : 0.0f;
            float lo = in ? v : INFINITY, hi = in ? v : -INFINITY;
            warp_span(lo, hi);
            if (lane == 0) {
                if (warp == 0) { box.xlo = lo; box.xhi = hi; }
                else { box.ylo = lo; box.yhi = hi; }
            }
        }
        if (tid == 0) {
            n_tile = 0;
            m_tile = 0;
        }
        __syncthreads();
        const Box tb = box;
        for (int i0 = 0; i0 < ne; i0 += THREADS) {
            const int i = i0 + tid;
            bool keep = false;
            int s = 0;
            if (i < ne) {
                s = env_list[i];
                keep = !row_culled(rows[3 * s], rows[3 * s + 1], rows[3 * s + 2], tb, quads);
            }
            append(keep, s, tile_list, &n_tile);
        }
        for (int i0 = 0; i0 < nme; i0 += THREADS) {
            const int i = i0 + tid;
            bool keep = false;
            int s = 0;
            if (i < nme) {
                s = menv_list[i];
                keep = !row_culled(mrows[3 * s], mrows[3 * s + 1], mrows[3 * s + 2], tb, false);
            }
            append(keep, s, mtile_list, &m_tile);
        }
        __syncthreads();
        const int nt = n_tile;
        const int nmt = MESH ? m_tile : 0;

        // 3. each pixel scans the tile's survivors
        const int x = x0 + col;
        const float xv = xbase[min(x, W - 1)] * tan_x;
        float yv[PIX_PER_THREAD];
        int best[PIX_PER_THREAD], mbest[PIX_PER_THREAD];
        unsigned long long cbest[PIX_PER_THREAD];  // RANKED: (key << 8) | its position's rank
#pragma unroll
        for (int k = 0; k < PIX_PER_THREAD; ++k) {
            const int y = y0 + row0 + k * ROWS_PER_THREAD_Y;
            yv[k] = ybase[min(y, H - 1)] * tan_y;
            best[k] = 0;
            mbest[k] = 0;
            cbest[k] = 0ull;
        }
        // the mesh competition first (triangles: coverage u + v)
        for (int i = 0; i < nmt; ++i) {
            const int s = mtile_list[i];
            const float4 q0 = mrows[3 * s], q1 = mrows[3 * s + 1], q2 = mrows[3 * s + 2];
            const float dx = q0.x + q0.y * xv;
            const float ux = q0.w + q1.x * xv;
            const float vx = q1.z + q1.w * xv;
#pragma unroll
            for (int k = 0; k < PIX_PER_THREAD; ++k) {
                const float det = dx + q0.z * yv[k];
                const float un = ux + q1.y * yv[k];
                const float vn = vx + q2.x * yv[k];
                const float r = det * q2.y;
                const bool hit = det > 1e-12f && un >= 0.0f && vn >= 0.0f &&
                                 un + vn <= det && r < r_near && r > r_far;
                const int key = hit ? ((__float_as_int(r) & ~IDX_MASK) | s) : 0;
                mbest[k] = max(mbest[k], key);
            }
        }
        for (int i = 0; i < nt; ++i) {
            const int s = tile_list[i];
            const float4 q0 = rows[3 * s], q1 = rows[3 * s + 1], q2 = rows[3 * s + 2];
            // RANKED: position rank << 10 | local; ACTIVE: the row (s is its slot)
            const int rank = __float_as_int(q2.w);
            const int idx = ACTIVE ? rank : s;
            const float dx = q0.x + q0.y * xv;
            const float ux = q0.w + q1.x * xv;
            const float vx = q1.z + q1.w * xv;
#pragma unroll
            for (int k = 0; k < PIX_PER_THREAD; ++k) {
                const float det = dx + q0.z * yv[k];
                const float un = ux + q1.y * yv[k];
                const float vn = vx + q2.x * yv[k];
                const float r = det * q2.y;
                float cov = fmaxf(un, vn);
                if (!quads) cov = cov + q2.z * fminf(un, vn);
                const bool hit = det > 1e-12f && un >= 0.0f && vn >= 0.0f &&
                                 cov <= det && r < r_near && r > r_far;
                if (RANKED) {
                    const int key = (__float_as_int(r) & ~IDX_MASK) | (rank & IDX_MASK);
                    const unsigned long long v =
                        hit ? (((unsigned long long)key << 8) | (unsigned)(rank >> 10)) : 0ull;
                    cbest[k] = cbest[k] > v ? cbest[k] : v;
                } else {
                    const int key = hit ? ((__float_as_int(r) & ~IDX_MASK) | idx) : 0;
                    best[k] = max(best[k], key);
                }
            }
        }

        // 4. t and the winner's row of each pixel (staged: then the warp's
        // 32 / TILE_W tile rows of it, whole)
        uint4* wbuf = wbufs + (size_t)warp * warp_buf_bytes<F32, STAGED>() / sizeof(uint4);
#pragma unroll
        for (int k = 0; k < PIX_PER_THREAD; ++k) {
            [&] {
                const int y = y0 + row0 + k * ROWS_PER_THREAD_Y;
                if (x >= W || y >= H) return;
                const size_t q = (size_t)b * hw + (size_t)y * W + x;
                if (MESH) {
                    // the mesh winner as the seed, through t-space as the JAX
                    // carry takes it: 1/inf = 0, no seed
                    const float seed_r = 1.0f / t_of_key(mbest[k]);
                    const int seed_key =
                        seed_r > 0.0f ? ((__float_as_int(seed_r) & ~IDX_MASK) | IDX_MASK) : 0;
                    // ranked: the seed above every chunk position at an equal key
                    const bool seed_wins =
                        RANKED ? !(cbest[k] > (seed_key > 0 ? ((unsigned long long)seed_key << 8) | 255ull
                                                             : 0ull))
                               : !(best[k] > seed_key);
                    if (seed_wins) {
                        t_out[q] = t_of_key(seed_key);
                        if (mbest[k] > 0)
                            put_attr<F32, STAGED>(
                                mesh_attr + ((size_t)b * N + (mbest[k] & IDX_MASK)) * ATTR_DIM,
                                attr_out, q, wbuf, lane);
                        else
                            put_zero<F32, STAGED>(attr_out, q, wbuf, lane);
                        return;
                    }
                }
                if (RANKED) {
                    const int key = (int)(cbest[k] >> 8);
                    t_out[q] = t_of_key(key);
                    if (key > 0) {
                        const int r8 = (int)(cbest[k] & 0xFFu);
                        const int row = sched_s[254 - r8] * S + (key & IDX_MASK);
                        put_attr<F32, STAGED>(atp + (size_t)row * ATTR_DIM, attr_out, q, wbuf, lane,
                                              OVERRIDE ? txp + row : nullptr, env_key);
                    } else {
                        put_zero<F32, STAGED>(attr_out, q, wbuf, lane);
                    }
                    return;
                }
                t_out[q] = t_of_key(best[k]);
                // winner's row (row 0 for an unmeshed miss: nothing downstream reads it)
                const int row = best[k] & IDX_MASK;
                const bool alt = paired && use_alt[row];
                put_attr<F32, STAGED>((alt ? ata : atp) + row * ATTR_DIM, attr_out, q, wbuf, lane,
                                      OVERRIDE ? (alt ? txa : txp) + row : nullptr, env_key);
            }();
            if (STAGED) {
                const int wy = y0 + warp * (32 / TILE_W) + k * ROWS_PER_THREAD_Y;
                rows_out<F32>(wbuf, attr_out, (size_t)b * hw + (size_t)wy * W + x0, W,
                              min(TILE_W, W - x0), min(32 / TILE_W, H - wy), lane);
            }
        }
        __syncthreads();  // the next tile rewrites box, n_tile and tile_list
    }
}

// ---------------------------------------------------------------------------
// The multi-chunk kernel (header: "Multi-chunk launch")

// 2 x 2 tiles of 96 threads and a window of 1,024 rows: measured against
// other groups and windows at Sidewalk's B = 1024 and the 8x8 maze's ss=2
// B = 8192 (PERF.md). Bounding the registers for three blocks an SM (56)
// was faster at the maze but spilled 8 bytes, so the compiler keeps its
// own choice (71 registers, two blocks).
#define GROUP_X 2
#define GROUP_Y 2
#define WINDOW_ROWS 1024
#define GROUP_TILES (GROUP_X * GROUP_Y)
#define M_THREADS (GROUP_TILES * THREADS)
#define M_WARPS (M_THREADS / 32)
#define ROW_WORDS (WINDOW_ROWS / 32)
static_assert(WINDOW_ROWS % 32 == 0 && WINDOW_ROWS >= M_THREADS, "a batch fits the window");
static_assert(WINDOW_ROWS <= 65536, "2-byte window slots");
static_assert(GROUP_X + GROUP_Y <= M_WARPS, "one warp a tile column or row");

// Ordered compaction of a batch of the block's threads: the slot of this
// thread among those with ``keep`` (in thread order), and their number in
// ``total``. One ballot a warp and one barrier; ``cnt`` is one of two
// alternating buffers of M_WARPS counts (a buffer is rewritten two calls
// later, after every thread has passed the barrier between). Every thread
// of the block calls it.
__device__ __forceinline__ int ordered_slot(const bool keep, int* cnt, int& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) cnt[warp] = __popc(m);
    __syncthreads();
    int before = 0;
    total = 0;
#pragma unroll
    for (int w = 0; w < M_WARPS; ++w) {
        const int c = cnt[w];
        before += w < warp ? c : 0;
        total += c;
    }
    return before + __popc(m & ((1u << lane) - 1u));
}

// Bytes of dynamic shared memory of the multi-chunk kernel: the window's
// rows (3 float4), its slot list (2 bytes) and a bit a row for each tile.
#define MULTI_SMEM ((size_t)WINDOW_ROWS * (3 * sizeof(float4) + sizeof(unsigned short)) + \
                    (size_t)GROUP_TILES * ROW_WORDS * sizeof(unsigned))

template <bool OVERRIDE, bool F32, bool ACTIVE>
__global__ void __launch_bounds__(M_THREADS) tri_pass_multi_kernel(
    const float* __restrict__ verts9,   // (L, 9, S) component-major
    const float* __restrict__ attr,     // (L, S, 16)
    const int* __restrict__ layout_id,  // (B,)
    const float* __restrict__ origin, const float* __restrict__ fwd,
    const float* __restrict__ right, const float* __restrict__ up,
    const float* __restrict__ tan_xy, const float* __restrict__ xbase,
    const float* __restrict__ ybase,
    const float* __restrict__ verts9_alt,  // (L, 9, S) or null
    const float* __restrict__ attr_alt,    // (L, S, 16) or null
    const int* __restrict__ pg_wall,       // (L, S) or null; -1 = no wall
    const float* __restrict__ wall_open,   // (B, Wn) or null; 1 = open
    const unsigned* __restrict__ slot_key,    // (B,), OVERRIDE only
    const float4* __restrict__ slot_tex,      // (L, S) (id, base, count, 0)
    const float4* __restrict__ slot_tex_alt,  // (L, S), paired only
    const int* __restrict__ row_code,         // (L, S), ACTIVE only (wall_codes)
    int S, int W, int H, int Wn, int all_quads,
    int tri_chunk,                      // rows per chunk
    float* __restrict__ t_out,          // (B, HW)
    void* __restrict__ attr_out)        // (B, HW, 16) bf16, or f32 (F32)
{
    constexpr size_t ROW_BYTES = ATTR_DIM * (F32 ? 4 : 2);
    constexpr bool STAGED = F32;
    // the warps' store buffers (STAGED), then 3 x WINDOW_ROWS float4, then the lists
    extern __shared__ float4 smem[];
    uint4* wbufs = reinterpret_cast<uint4*>(smem);
    float4* wrows = smem + M_WARPS * warp_buf_bytes<F32, STAGED>() / sizeof(float4);
    unsigned short* glist = reinterpret_cast<unsigned short*>(wrows + 3 * WINDOW_ROWS);
    unsigned* tmask = reinterpret_cast<unsigned*>(glist + WINDOW_ROWS);  // [tile][word]
    __shared__ int cnt[2][M_WARPS];
    __shared__ float span_lo[GROUP_X + GROUP_Y], span_hi[GROUP_X + GROUP_Y];
    __shared__ Box box;

    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int lid = layout_id[b];
    const bool paired = pg_wall != nullptr;
    const bool quads = all_quads != 0;
    const float* v9p = verts9 + (size_t)lid * 9 * S;
    const float* atp = attr + (size_t)lid * S * ATTR_DIM;
    const float* v9a = paired ? verts9_alt + (size_t)lid * 9 * S : nullptr;
    const float* ata = paired ? attr_alt + (size_t)lid * S * ATTR_DIM : nullptr;
    const int* pgw = paired ? pg_wall + (size_t)lid * S : nullptr;
    const float* wo = paired ? wall_open + (size_t)b * Wn : nullptr;
    const float tan_x = tan_xy[2 * b], tan_y = tan_xy[2 * b + 1];

    // the whole image's box: warp 0 over the columns, warp 1 over the rows
    if (warp < 2) {
        const int n = warp == 0 ? W : H;
        const float* base = warp == 0 ? xbase : ybase;
        const float tn = warp == 0 ? tan_x : tan_y;
        float lo = INFINITY, hi = -INFINITY;
        for (int i = lane; i < n; i += 32) {
            const float v = base[i] * tn;
            lo = fminf(lo, v);
            hi = fmaxf(hi, v);
        }
        warp_span(lo, hi);
        if (lane == 0) {
            if (warp == 0) { box.xlo = lo; box.xhi = hi; }
            else { box.ylo = lo; box.yhi = hi; }
        }
    }
    __syncthreads();

    const int hw = W * H;
    const int n_tx = (W + TILE_W - 1) / TILE_W, n_ty = (H + TILE_H - 1) / TILE_H;
    const int n_gx = (n_tx + GROUP_X - 1) / GROUP_X;
    const int n_groups = n_gx * ((n_ty + GROUP_Y - 1) / GROUP_Y);
    // this thread's tile of a group, and its place there
    const int k = tid / THREADS, ktid = tid - k * THREADS;
    const int kx = k % GROUP_X, ky = k / GROUP_X;
    const int col = ktid % TILE_W, row0 = ktid / TILE_W;
    const int kwarp = ktid >> 5;
    const float r_near = (float)(1.0 / 0.04);  // 1 / NEAR
    const float r_far = (float)(1.0 / 100.0);  // 1 / FAR
    int par = 0;  // which cnt buffer the next ordered_slot takes

    // the variant of row s (paired): the alternative where its wall is closed
    auto use_alt = [&](const int s) {
        if (!paired) return false;
        const int w = pgw[s];
        return w >= 0 && !(wo[w] > 0.5f);
    };
    // row s's staged fields; the pad holds s << 10 | its first chunk's local
    // index (the camera is read again at every call rather than held in
    // registers through the window scans)
    auto stage = [&](const int s, float4& q0, float4& q1, float4& q2) {
        const CamBasis cb{origin[3 * b], origin[3 * b + 1], origin[3 * b + 2],
                          fwd[3 * b], fwd[3 * b + 1], fwd[3 * b + 2],
                          right[3 * b], right[3 * b + 1], right[3 * b + 2],
                          up[3 * b], up[3 * b + 1], up[3 * b + 2]};
        const bool alt = use_alt(s);
        stage_row(alt ? v9a : v9p, S, s, cb, (alt ? ata : atp)[(size_t)s * ATTR_DIM + 15], q0, q1,
                  q2);
        const int c = s / tri_chunk;
        q2.w = __int_as_float((s << 10) | (s - min(c * tri_chunk, S - tri_chunk)));
    };

    // 2-4: the window's rows (n_win of them) against the block's groups of
    // tiles; ``first``: no carry to read, ``last``: store the winners
    auto scan_window = [&](const int n_win, const bool first, const bool last) {
        for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
            const int tx0 = (g % n_gx) * GROUP_X, ty0 = (g / n_gx) * GROUP_Y;
            __syncthreads();  // the window is written; the last group's lists are read
            if (warp < GROUP_X + GROUP_Y) {  // a tile column's or a tile row's span
                const bool cw = warp < GROUP_X;
                const int i = cw ? (tx0 + warp) * TILE_W + lane
                                 : (ty0 + warp - GROUP_X) * TILE_H + lane;
                const bool in = cw ? (lane < TILE_W && i < W) : (lane < TILE_H && i < H);
                const float v = in ? (cw ? xbase[i] * tan_x : ybase[i] * tan_y) : 0.0f;
                float lo = in ? v : INFINITY, hi = in ? v : -INFINITY;
                warp_span(lo, hi);
                if (lane == 0) {
                    span_lo[warp] = lo;
                    span_hi[warp] = hi;
                }
            }
            __syncthreads();
            Box gb{INFINITY, -INFINITY, INFINITY, -INFINITY};  // the group's: the union
#pragma unroll
            for (int i = 0; i < GROUP_X; ++i) {
                gb.xlo = fminf(gb.xlo, span_lo[i]);
                gb.xhi = fmaxf(gb.xhi, span_hi[i]);
            }
#pragma unroll
            for (int i = 0; i < GROUP_Y; ++i) {
                gb.ylo = fminf(gb.ylo, span_lo[GROUP_X + i]);
                gb.yhi = fmaxf(gb.yhi, span_hi[GROUP_X + i]);
            }
            const Box tb{span_lo[kx], span_hi[kx], span_lo[GROUP_X + ky],
                         span_hi[GROUP_X + ky]};
            // 2. the window's rows that may hit the group, in row order
            int ng = 0;
            for (int i0 = 0; i0 < n_win; i0 += M_THREADS) {
                const int i = i0 + tid;
                const int j = i < n_win ? i : 0;
                const bool keep =
                    i < n_win && !row_culled(wrows[3 * j], wrows[3 * j + 1], wrows[3 * j + 2],
                                             gb, quads);
                int total;
                const int at = ordered_slot(keep, cnt[par], total);
                par ^= 1;
                if (keep) glist[ng + at] = (unsigned short)i;
                ng += total;
            }
            __syncthreads();
            // 3. each tile's bits over the group's list
            const int tx = tx0 + kx, ty = ty0 + ky;
            const bool tile_in = tx < n_tx && ty < n_ty;
            for (int i0 = kwarp * 32; i0 < ng; i0 += THREADS) {
                const int i = i0 + lane;
                const int j = i < ng ? glist[i] : 0;
                const bool keep = tile_in && i < ng &&
                                  !row_culled(wrows[3 * j], wrows[3 * j + 1], wrows[3 * j + 2],
                                              tb, quads);
                const unsigned m = __ballot_sync(0xffffffffu, keep);
                if (lane == 0) tmask[k * ROW_WORDS + (i0 >> 5)] = m;
            }
            __syncthreads();
            // 4. each pixel scans its tile's rows in row order, from the carry
            const int x = tx * TILE_W + col;
            const float xv = xbase[min(x, W - 1)] * tan_x;
            float yv[PIX_PER_THREAD];
            int best[PIX_PER_THREAD], bpad[PIX_PER_THREAD];
#pragma unroll
            for (int p = 0; p < PIX_PER_THREAD; ++p) {
                const int y = ty * TILE_H + row0 + p * ROWS_PER_THREAD_Y;
                yv[p] = ybase[min(y, H - 1)] * tan_y;
                best[p] = 0;
                bpad[p] = 0;
                if (!first && tile_in && x < W && y < H) {
                    const int2 c = *reinterpret_cast<const int2*>(
                        static_cast<const char*>(attr_out) +
                        ((size_t)b * hw + (size_t)y * W + x) * ROW_BYTES);
                    best[p] = c.x;
                    bpad[p] = c.y;
                }
            }
            const int n_words = tile_in ? (ng + 31) >> 5 : 0;
            for (int w = 0; w < n_words; ++w) {
                unsigned m = tmask[k * ROW_WORDS + w];
                while (m) {
                    const int j = glist[(w << 5) + __ffs(m) - 1];
                    m &= m - 1u;
                    const float4 q0 = wrows[3 * j], q1 = wrows[3 * j + 1], q2 = wrows[3 * j + 2];
                    const int pad = __float_as_int(q2.w);
                    const float dx = q0.x + q0.y * xv;
                    const float ux = q0.w + q1.x * xv;
                    const float vx = q1.z + q1.w * xv;
#pragma unroll
                    for (int p = 0; p < PIX_PER_THREAD; ++p) {
                        const float det = dx + q0.z * yv[p];
                        const float un = ux + q1.y * yv[p];
                        const float vn = vx + q2.x * yv[p];
                        const float r = det * q2.y;
                        float cov = fmaxf(un, vn);
                        if (!quads) cov = cov + q2.z * fminf(un, vn);
                        const int key = (__float_as_int(r) & ~IDX_MASK) | (pad & IDX_MASK);
                        const bool win = det > 1e-12f && un >= 0.0f && vn >= 0.0f &&
                                         cov <= det && r < r_near && r > r_far && key > best[p];
                        best[p] = win ? key : best[p];
                        bpad[p] = win ? pad : bpad[p];
                    }
                }
            }
            uint4* wbuf = wbufs + (size_t)warp * warp_buf_bytes<F32, STAGED>() / sizeof(uint4);
#pragma unroll
            for (int p = 0; p < PIX_PER_THREAD; ++p) {
                [&] {
                    const int y = ty * TILE_H + row0 + p * ROWS_PER_THREAD_Y;
                    if (!tile_in || x >= W || y >= H) return;
                    const size_t q = (size_t)b * hw + (size_t)y * W + x;
                    if (!last) {  // the carry, in the pixel's own attribute row
                        *reinterpret_cast<int2*>(static_cast<char*>(attr_out) + q * ROW_BYTES) =
                            make_int2(best[p], bpad[p]);
                        return;
                    }
                    t_out[q] = t_of_key(best[p]);
                    if (best[p] > 0) {
                        const int row = bpad[p] >> 10;
                        const bool alt = use_alt(row);
                        put_attr<F32, STAGED>(
                            (alt ? ata : atp) + (size_t)row * ATTR_DIM, attr_out, q, wbuf, lane,
                            OVERRIDE ? (alt ? slot_tex_alt : slot_tex) + (size_t)lid * S + row
                                     : nullptr,
                            OVERRIDE ? slot_key[b] : 0u);
                    } else {
                        put_zero<F32, STAGED>(attr_out, q, wbuf, lane);
                    }
                }();
                if (STAGED && last) {  // the warp's 32 / TILE_W tile rows of this pixel, whole
                    const int x0 = tx * TILE_W;
                    const int wy = ty * TILE_H + kwarp * (32 / TILE_W) + p * ROWS_PER_THREAD_Y;
                    rows_out<F32>(wbuf, attr_out, (size_t)b * hw + (size_t)wy * W + x0, W,
                                  tile_in ? min(TILE_W, W - x0) : 0, min(32 / TILE_W, H - wy),
                                  lane);
                }
            }
        }
        __syncthreads();  // the window may be refilled
    };

    // 1. stream the rows through the window, in row order
    int n_win = 0;
    bool first = true;
    for (int s0 = 0; s0 < S; s0 += M_THREADS) {
        const int s = s0 + tid;
        float4 q0, q1, q2;
        bool keep = false;
        // ACTIVE: the row's loads are issued before its liveness is known,
        // so that they overlap the row_code -> wall_open chain (testing it
        // first was slower on an H100, PERF.md)
        if (s < S) {
            stage(s, q0, q1, q2);
            keep = (!ACTIVE || row_live(row_code[(size_t)lid * S + s], wall_open, b, Wn)) &&
                   !row_culled(q0, q1, q2, box, quads);  // the image's box
        }
        int total;
        const int at = ordered_slot(keep, cnt[par], total);
        par ^= 1;
        if (n_win + total > WINDOW_ROWS) {  // block-uniform: scan the full window first
            scan_window(n_win, first, false);
            first = false;
            n_win = 0;
            if (keep) stage(s, q0, q1, q2);
        }
        if (keep) {
            const int i = n_win + at;
            wrows[3 * i] = q0;
            wrows[3 * i + 1] = q1;
            wrows[3 * i + 2] = q2;
        }
        n_win += total;
    }
    scan_window(n_win, first, true);
}

extern "C" const char* mw_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// The kernel's tile and pixels per thread, then the multi-chunk kernel's
// group of tiles and window rows, for reports.
extern "C" int mw_tri_pass_config(int* out) {
    out[0] = TILE_W;
    out[1] = TILE_H;
    out[2] = PIX_PER_THREAD;
    out[3] = GROUP_X;
    out[4] = GROUP_Y;
    out[5] = WINDOW_ROWS;
    return 0;
}

// The launch's arguments, as the kernels take them
#define TRI_PARAMS                                                                           \
    const float *verts9, const float *attr, const int *layout_id, const float *origin,      \
        const float *fwd, const float *right, const float *up, const float *tan_xy,         \
        const float *xbase, const float *ybase, const float *mesh_v9,                       \
        const float *mesh_attr, const float *verts9_alt, const float *attr_alt,             \
        const int *pg_wall, const float *wall_open, const unsigned *slot_key,               \
        const float4 *slot_tex, const float4 *slot_tex_alt, const int *row_code, int S,     \
        int N, int W, int H, int Wn, int all_quads, int n_sched, int n_live, float *t_out,      \
        void *attr_out
#define TRI_ARGS                                                                             \
    verts9, attr, layout_id, origin, fwd, right, up, tan_xy, xbase, ybase, mesh_v9,         \
        mesh_attr, verts9_alt, attr_alt, pg_wall, wall_open, slot_key, slot_tex,            \
        slot_tex_alt, row_code, S, N, W, H, Wn, all_quads, n_sched, n_live, t_out, attr_out

// ``rows_smem``: the bytes of the staged rows and lists; the warps' store
// buffers come on top
template <bool MESH, bool SCHED, bool OVERRIDE, bool F32, bool ACTIVE>
static int launch_instance(const dim3 grid, const size_t rows_smem, cudaStream_t stream,
                           TRI_PARAMS) {
    static size_t smem_opted = 48 * 1024;  // the dynamic limit set so far
    constexpr size_t bufs = warp_buf_bytes<F32, block_staged<MESH, SCHED, F32, ACTIVE>()>();
    const size_t smem = rows_smem + (THREADS / 32) * bufs;
    if (smem > smem_opted) {
        const cudaError_t err = cudaFuncSetAttribute(
            tri_pass_kernel<MESH, SCHED, OVERRIDE, F32, ACTIVE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_opted = smem;
    }
    tri_pass_kernel<MESH, SCHED, OVERRIDE, F32, ACTIVE><<<grid, THREADS, smem, stream>>>(TRI_ARGS);
    return (int)cudaGetLastError();
}

// The override and the float32 carry are instances of their own
// (OVERRIDE, F32), so that the launches without them compile to the code
// they had before they existed: as a runtime branch the override slowed
// the multi-chunk launch without the key from 2.26 to 2.93 ms (Sidewalk,
// B = 1024, 80x60, on an H100).
template <bool MESH, bool SCHED, bool ACTIVE>
static int launch_tri_pass(const bool f32, const dim3 grid, const size_t smem,
                           cudaStream_t stream, TRI_PARAMS) {
    if (slot_key != nullptr)
        return f32 ? launch_instance<MESH, SCHED, true, true, ACTIVE>(grid, smem, stream, TRI_ARGS)
                   : launch_instance<MESH, SCHED, true, false, ACTIVE>(grid, smem, stream, TRI_ARGS);
    return f32 ? launch_instance<MESH, SCHED, false, true, ACTIVE>(grid, smem, stream, TRI_ARGS)
               : launch_instance<MESH, SCHED, false, false, ACTIVE>(grid, smem, stream, TRI_ARGS);
}

// The multi-chunk kernel's instance for the override, the carry dtype and
// the kill: its dynamic shared memory (MULTI_SMEM and the warps' store
// buffers, above the 48 KB default) is opted into once per process and
// instance.
template <bool OVERRIDE, bool F32, bool ACTIVE>
static int launch_multi(const int B, cudaStream_t stream, TRI_PARAMS, int tri_chunk) {
    constexpr size_t smem = MULTI_SMEM + M_WARPS * warp_buf_bytes<F32, F32>();
    static bool opted = false;
    if (!opted) {
        const cudaError_t err = cudaFuncSetAttribute(
            tri_pass_multi_kernel<OVERRIDE, F32, ACTIVE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        opted = true;
    }
    const int n_tx = (W + TILE_W - 1) / TILE_W, n_ty = (H + TILE_H - 1) / TILE_H;
    const int n_groups = ((n_tx + GROUP_X - 1) / GROUP_X) * ((n_ty + GROUP_Y - 1) / GROUP_Y);
    const dim3 grid(min(n_groups, max(1, (BLOCK_TARGET + B - 1) / B)), B);
    tri_pass_multi_kernel<OVERRIDE, F32, ACTIVE><<<grid, M_THREADS, smem, stream>>>(
        verts9, attr, layout_id, origin, fwd, right, up, tan_xy, xbase, ybase, verts9_alt,
        attr_alt, pg_wall, wall_open, slot_key, slot_tex, slot_tex_alt, row_code, S, W, H, Wn,
        all_quads, tri_chunk, t_out, attr_out);
    return (int)cudaGetLastError();
}

template <bool ACTIVE>
static int launch_multi_any(const bool f32, const int B, cudaStream_t stream, TRI_PARAMS,
                            int tri_chunk) {
    if (slot_key != nullptr)
        return f32 ? launch_multi<true, true, ACTIVE>(B, stream, TRI_ARGS, tri_chunk)
                   : launch_multi<true, false, ACTIVE>(B, stream, TRI_ARGS, tri_chunk);
    return f32 ? launch_multi<false, true, ACTIVE>(B, stream, TRI_ARGS, tri_chunk)
               : launch_multi<false, false, ACTIVE>(B, stream, TRI_ARGS, tri_chunk);
}

// ``n_live`` (last, after the stream): the most rows live in an env of
// the bank (raycast.live_row_bound of row_code), which sizes the ACTIVE
// one-block launch's staging, 1 to S; ignored elsewhere.
extern "C" int mw_tri_pass(
    const float* verts9, const float* attr, const int* layout_id,
    const float* origin, const float* fwd, const float* right, const float* up,
    const float* tan_xy, const float* xbase, const float* ybase,
    const float* mesh_v9, const float* mesh_attr,
    const float* verts9_alt, const float* attr_alt, const int* pg_wall,
    const float* wall_open, const unsigned* slot_key, const float* slot_tex_f,
    const float* slot_tex_alt_f, const int* row_code,
    int B, int S, int N, int W, int H, int Wn, int all_quads, int tri_chunk, int n_sched,
    int f32, float* t_out, void* attr_out, cudaStream_t stream, int n_live)
{
    const bool paired = pg_wall != nullptr;
    const bool mesh = mesh_v9 != nullptr;
    const bool sched = n_sched > 0;
    const bool active = row_code != nullptr;
    const bool multi = !sched && S > tri_chunk;
    if (paired && (verts9_alt == nullptr || attr_alt == nullptr || wall_open == nullptr))
        return (int)cudaErrorInvalidValue;
    if (mesh && mesh_attr == nullptr) return (int)cudaErrorInvalidValue;
    if (slot_key != nullptr && (slot_tex_f == nullptr || (paired && slot_tex_alt_f == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (N > IDX_MASK + 1) return (int)cudaErrorInvalidValue;
    // the kill: a dense scan of the super bank's own rows (ACTIVE instances)
    if (active && (wall_open == nullptr || paired || mesh || sched)) return (int)cudaErrorInvalidValue;
    if (multi ? (mesh || tri_chunk < 16 || tri_chunk > IDX_MASK + 1 || S > 4096)
              : S > IDX_MASK + 1)
        return (int)cudaErrorInvalidValue;
    if (sched && (paired || n_sched > 255 || n_sched * S > 4096)) return (int)cudaErrorInvalidValue;
    if (B == 0 || W == 0 || H == 0) return 0;
    if (active && !multi && (n_live < 1 || n_live > S)) return (int)cudaErrorInvalidValue;
    const float4* slot_tex = reinterpret_cast<const float4*>(slot_tex_f);
    const float4* slot_tex_alt = reinterpret_cast<const float4*>(slot_tex_alt_f);
    if (multi)
        return active ? launch_multi_any<true>(f32, B, stream, TRI_ARGS, tri_chunk)
                      : launch_multi_any<false>(f32, B, stream, TRI_ARGS, tri_chunk);
    const int n_tiles = ((W + TILE_W - 1) / TILE_W) * ((H + TILE_H - 1) / TILE_H);
    const int per_env = min(n_tiles, max(1, (BLOCK_TARGET + B - 1) / B));
    const dim3 grid(per_env, B);
    const size_t per_row = 3 * sizeof(float4) + 2 * sizeof(unsigned short);
    const size_t n_rows = active ? (size_t)n_live : (size_t)S * (sched ? n_sched : 1);
    const size_t smem = n_rows * per_row + (paired ? n_rows : 0) +
                        (sched ? (size_t)n_sched * sizeof(int) : 0) +
                        (mesh ? (size_t)N * per_row : 0);
    if (sched)
        return mesh ? launch_tri_pass<true, true, false>(f32, grid, smem, stream, TRI_ARGS)
                    : launch_tri_pass<false, true, false>(f32, grid, smem, stream, TRI_ARGS);
    if (active) return launch_tri_pass<false, false, true>(f32, grid, smem, stream, TRI_ARGS);
    return mesh ? launch_tri_pass<true, false, false>(f32, grid, smem, stream, TRI_ARGS)
                : launch_tri_pass<false, false, false>(f32, grid, smem, stream, TRI_ARGS);
}

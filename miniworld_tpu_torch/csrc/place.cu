// Entity placement by budgeted rejection sampling, one warp per env, the
// tries of a pose in parallel lanes. Two entries share the tries
// (place_pose):
//   - mw_place, at reset: every entity slot, in order, then the agent,
//     each against the slots placed before it. Replaces
//     miniworld_tpu/ops/place.py:place_one chained over the slots as in
//     miniworld_tpu/vector.py:_reset_one's place_body; plain version
//     place_all_plain in miniworld_tpu_torch/ops/place.py;
//   - mw_place_one, inside a step: one pose an env against an obstacle
//     list the caller gives (CollectHealth's kit respawn,
//     miniworld_tpu/envs/interact.py:200-214 calling place_one); plain
//     version _place_one.
// XLA-fused jnp in the JAX package. Kernel and plain versions agree bit
// for bit (-fmad=false and the same operations in the same order).
//
// Per try: the room by inverse CDF over room_area * room_mask (summed in
// room order), the room's (or the rule's) bbox widened by the radius,
// the uniform position in it, then three rejections — outside the
// room's convex outline, overlapping one of the room-local wall
// segments, overlapping an entity already placed. On a procgen maze
// (room_weight != nullptr) each room's area is multiplied by the env's
// room weight (0 for the junction of a closed wall) before it enters the
// sums, in the JAX order, and a room-local segment whose code names an
// open wall is shifted by 1e9 on all four coordinates (gate_segs4), which
// puts it out of reach. The first try that
// passes wins; when none does, the candidate of try ``budget`` is
// clamped into the bbox of a fallback room. An exact rule position
// overrides; the direction is the rule's or a uniform in its range. The
// uniforms are ops/rng.py's counter-based hash, u[i][j] =
// hash01(hash_u32(seed, 1), 4 i + j), in 32-bit unsigned arithmetic.
//
// What bounds it on an H100: neither bytes (a few hundred per env) nor
// operations (about 10^8 at B = 4096 with six placements of 18 tries,
// about 4 x 10^8 on an 8x8 maze at B = 8192, two placements over 176
// rooms and 40 segments) come near the card's rates. What is left is
// latency: the E+1 placements of an env are a dependent chain (each
// collides with the ones before it); and, where an env has many rooms,
// the L1 throughput of the tries' gathers: the lanes of a warp test
// different rooms, so each load of an outline vertex or wall segment
// touches up to one line per lane (the reason a lane stops loading at
// its first failed test).
//
// Design. The tries of one slot are independent given the entities
// already placed (each draws its own counter row u[i]), and the room
// CDF depends only on the env, so:
//   - a warp owns an env (WARPS envs a block): B = 8192 gives 8192 warps,
//     about 62 per SM, where one thread per env gave 64 blocks;
//   - one lane sums the room weights in room order into shared memory
//     once per env (sequentially, as the plain version's cumsum is
//     meant: a warp scan would round differently unless the weights
//     sum exactly); the last entry is the total, the same bits as a
//     separate sum. A draw is then a binary search for the first r with
//     u * total < cdf[r] (0 where there is none, as the linear scan and
//     torch's argmax of all-false give): exact, since the CDF never
//     decreases (the weights are >= 0), plateaus included;
//   - per slot, lane i < budget runs try i, lane ``budget`` computes the
//     fallback candidate and lane ``budget + 1`` draws the fallback room,
//     in rounds of 32 lanes where budget + 2 > 32; the first passing try
//     is the lowest set bit of a ballot, its position broadcast by a
//     shuffle, and a round with a pass ends the slot;
//   - the placed entities (x, z, radius, placed) live in shared memory
//     per warp; lane 0 writes a slot's result and its entry there.

#include <cuda_runtime.h>
#include <math.h>
#include <float.h>

#include "rng.cuh"

#define MAX_SLOTS 32
#define WARPS 4  // envs (warps) a block

struct Bank {
    const unsigned char* room_mask;  // (L, R)
    const float* room_area;          // (L, R)
    const float* room_aabb;          // (L, R, 4) [min_x, max_x, min_z, max_z]
    const float* room_outline;       // (L, R, V, 2)
    const float* room_norms;         // (L, R, V, 2)
    const unsigned char* room_vmask; // (L, R, V)
    const float* room_segs;          // (L, R, 4, NS) [a_x, a_z, b_x, b_z]
    int R, V, NS;
    // procgen maze, null otherwise
    const float* room_weight;        // (B, R)
    const int* room_seg_wall;        // (L, R, NS), -1 = always solid
    const float* wall_open;          // (B, Wn), 1 = open
    int Wn;
};

// sample_room over the env's CDF: the first room whose running weight
// sum exceeds u * total, 0 where none does (a binary search; the CDF
// never decreases)
__device__ __forceinline__ int room_search(const float* cdf, int R, float u) {
    const float thr = u * cdf[R - 1];
    int lo = 0, hi = R;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (thr < cdf[mid]) hi = mid;
        else lo = mid + 1;
    }
    return lo < R ? lo : 0;
}

// A placement rule's row: its room (-1: drawn), bbox (nan: the room's),
// exact position (nan: sampled), direction (nan: drawn in [lo, hi]) and
// the entity's radius.
struct Rule {
    int room;
    float bbox[4];
    float pos[3];
    float dir, dir_lo, dir_hi;
    float radius;
};

// The rule tensors, row i of each: (B, E+1, ...) for mw_place, (B, ...)
// for mw_place_one.
struct RuleRows {
    const int* room;       // -1 = drawn
    const float* bbox;     // 4 a row, nan = room bbox
    const float* pos;      // 3 a row, nan = sample
    const float* dir;      // nan = sample range
    const float* dir_lo;
    const float* dir_hi;
    const float* radius;
};

__device__ __forceinline__ Rule load_rule(const RuleRows& rr, size_t i) {
    Rule rule;
    rule.room = rr.room[i];
    for (int k = 0; k < 4; ++k) rule.bbox[k] = rr.bbox[i * 4 + k];
    for (int k = 0; k < 3; ++k) rule.pos[k] = rr.pos[i * 3 + k];
    rule.dir = rr.dir[i];
    rule.dir_lo = rr.dir_lo[i];
    rule.dir_hi = rr.dir_hi[i];
    rule.radius = rr.radius[i];
    return rule;
}

// The obstacles a try must clear: for mw_place the entities placed so
// far in a warp's env, for mw_place_one the caller's list.
struct Placed {
    float x[MAX_SLOTS], z[MAX_SLOTS], r[MAX_SLOTS];
    unsigned char on[MAX_SLOTS];
};

// A try's room and candidate position (x, z; y is 0) from its uniforms.
__device__ __forceinline__ int candidate(const Bank& bk, int lid, const float* cdf,
                                         const Rule& rule, const float* u, float* px_out,
                                         float* pz_out) {
    const int room = rule.room >= 0 ? rule.room : room_search(cdf, bk.R, u[0]);
    const float* aabb = bk.room_aabb + ((size_t)lid * bk.R + room) * 4;
    float bbox[4];
    for (int k = 0; k < 4; ++k) bbox[k] = isnan(rule.bbox[k]) ? aabb[k] : rule.bbox[k];
    const float r = rule.radius;
    const float lo_x = bbox[0] - r, hi_x = bbox[1] + r;
    const float lo_z = bbox[2] - r, hi_z = bbox[3] + r;
    *px_out = lo_x + u[1] * (hi_x - lo_x);
    *pz_out = lo_z + u[3] * (hi_z - lo_z);
    return room;
}

// Whether a candidate in ``room`` is free: inside the room's outline,
// clear of its walls and of the obstacles. The plain version ANDs the
// three tests over every vertex, segment and obstacle; the first failing
// one decides the same boolean, so a lane returns there and loads no
// more of its room (the lanes of a warp read different rooms, and each
// distinct line is one more L1 wavefront).
__device__ bool is_free(const Bank& bk, int b, int lid, int room, float r, float px, float pz,
                        const Placed& pl, int n_obs) {
    const size_t lr = (size_t)lid * bk.R + room;
    const float* outline = bk.room_outline + lr * bk.V * 2;
    const float* norms = bk.room_norms + lr * bk.V * 2;
    const unsigned char* vmask = bk.room_vmask + lr * bk.V;
    for (int v = 0; v < bk.V; ++v) {
        if (!vmask[v]) continue;
        const float apx = px - outline[2 * v];
        const float apz = pz - outline[2 * v + 1];
        const float dot = norms[2 * v] * apx + norms[2 * v + 1] * apz;
        if (!(dot > 0.0f)) return false;  // outside the outline
    }

    for (int e = 0; e < n_obs; ++e) {
        if (!pl.on[e]) continue;
        const float dx = pl.x[e] - px;
        const float dz = pl.z[e] - pz;
        const float rsum = r + pl.r[e];
        if (dx * dx + dz * dz < rsum * rsum) return false;  // overlaps an obstacle
    }

    const float* segs = bk.room_segs + lr * 4 * bk.NS;
    const int* codes = bk.room_seg_wall != nullptr ? bk.room_seg_wall + lr * bk.NS : nullptr;
    const float* wall_open = codes != nullptr ? bk.wall_open + (size_t)b * bk.Wn : nullptr;
    const float rr = r * r;
    for (int j = 0; j < bk.NS; ++j) {
        float ax = segs[j], az = segs[bk.NS + j];
        float bx = segs[2 * bk.NS + j], bz = segs[3 * bk.NS + j];
        if (codes != nullptr && codes[j] >= 0 && !(wall_open[codes[j]] < 0.5f)) {
            ax = ax + 1e9f;
            az = az + 1e9f;
            bx = bx + 1e9f;
            bz = bz + 1e9f;
        }
        const float abx = bx - ax, abz = bz - az;
        const float apx = px - ax, apz = pz - az;
        float t = (apx * abx + apz * abz) / fmaxf(abx * abx + abz * abz, 1e-12f);
        t = fminf(fmaxf(t, 0.0f), 1.0f);
        const float dx = ax + t * abx - px;
        const float dz = az + t * abz - pz;
        if (dx * dx + dz * dz < rr) return false;  // overlaps a wall
    }
    return true;
}

// A warp's env's room CDF: the room weights in parallel, then their
// running sum by one lane (in room order, as the plain version's cumsum).
__device__ void build_cdf(const Bank& bk, int b, int lid, int lane, float* cdf) {
    const int R = bk.R;
    const unsigned char* mask = bk.room_mask + (size_t)lid * R;
    const float* area = bk.room_area + (size_t)lid * R;
    const float* weight = bk.room_weight != nullptr ? bk.room_weight + (size_t)b * R : nullptr;
    for (int r = lane; r < R; r += 32) {
        const float p = mask[r] ? area[r] : 0.0f;
        cdf[r] = weight != nullptr ? p * weight[r] : p;
    }
    __syncwarp();
    if (lane == 0) {
        float c = 0.0f;
        for (int r = 0; r < R; ++r) {
            c = c + cdf[r];
            cdf[r] = c;
        }
    }
    __syncwarp();
}

struct Pose {
    float x, y, z, d;
};

// One entity's pose by a warp, the same in every lane: tries
// 0..budget-1, the fallback candidate (budget) and the fallback room
// draw (budget + 1), 32 lanes a round; the first passing try wins, else
// the fallback candidate clamped into the fallback room's bbox inset by
// the radius. Then the rule's exact position and its direction.
__device__ Pose place_pose(const Bank& bk, int b, int lid, const float* cdf, const Rule& rule,
                           unsigned int seed, int budget, const Placed& pl, int n_obs,
                           int lane) {
    const unsigned int key = hash_u32(seed, 1u);  // uniforms(seed, 1, ...)
    bool found = false;
    float px = 0.0f, pz = 0.0f;  // the winner's position
    float fb_x = 0.0f, fb_z = 0.0f;  // lane budget % 32: the fallback candidate
    int fb_room = 0;  // lane (budget + 1) % 32: the fallback room
    for (int base = 0; base < budget + 2; base += 32) {
        const int t = base + lane;
        bool ok = false;
        float cx = 0.0f, cz = 0.0f;
        if (t <= budget) {
            float u[4];
            for (int j = 0; j < 4; ++j) u[j] = hash01(key, (unsigned int)(4 * t + j));
            const int room = candidate(bk, lid, cdf, rule, u, &cx, &cz);
            if (t < budget) ok = is_free(bk, b, lid, room, rule.radius, cx, cz, pl, n_obs);
            else {
                fb_x = cx;
                fb_z = cz;
            }
        } else if (t == budget + 1) {
            const float u_room = hash01(key, (unsigned int)(4 * (budget + 1)));
            fb_room = rule.room >= 0 ? rule.room : room_search(cdf, bk.R, u_room);
        }
        const unsigned pass = __ballot_sync(0xffffffffu, ok);
        if (pass) {  // the earliest passing try of the earliest round
            const int w = __ffs(pass) - 1;
            px = __shfl_sync(0xffffffffu, cx, w);
            pz = __shfl_sync(0xffffffffu, cz, w);
            found = true;
            break;
        }
    }
    Pose p{px, 0.0f, pz, 0.0f};
    if (!found) {
        p.x = __shfl_sync(0xffffffffu, fb_x, budget & 31);
        p.z = __shfl_sync(0xffffffffu, fb_z, budget & 31);
        const int room = __shfl_sync(0xffffffffu, fb_room, (budget + 1) & 31);
        const float* aabb = bk.room_aabb + ((size_t)lid * bk.R + room) * 4;
        const float r = rule.radius;
        const float lo_x = fminf(aabb[0] + r, aabb[1] - r), hi_x = fmaxf(aabb[0] + r, aabb[1] - r);
        const float lo_z = fminf(aabb[2] + r, aabb[3] - r), hi_z = fmaxf(aabb[2] + r, aabb[3] - r);
        p.x = fminf(fmaxf(p.x, lo_x), hi_x);
        p.z = fminf(fmaxf(p.z, lo_z), hi_z);
    }
    if (!isnan(rule.pos[0])) {  // exact position, nan_to_num'd
        float q[3];
        for (int k = 0; k < 3; ++k) {
            const float v = rule.pos[k];
            q[k] = isnan(v) ? 0.0f : (isinf(v) ? (v > 0.0f ? FLT_MAX : -FLT_MAX) : v);
        }
        p.x = q[0];
        p.y = q[1];
        p.z = q[2];
    }
    const float u_dir = hash01(key, (unsigned int)(4 * (budget + 1) + 1));
    p.d = isnan(rule.dir) ? rule.dir_lo + u_dir * (rule.dir_hi - rule.dir_lo) : rule.dir;
    return p;
}

__global__ void __launch_bounds__(WARPS * 32) place_kernel(
    const unsigned int* __restrict__ seeds,     // (B, E+1) per-slot subseeds
    const int* __restrict__ layout_id,          // (B,)
    RuleRows rr,                                // (B, E+1, ...), row E the agent's
    const unsigned char* __restrict__ slot_mask,  // (B, E)
    Bank bk, int B, int E, int budget,
    float* __restrict__ ent_pos,                // (B, E, 3)
    float* __restrict__ ent_dir,                // (B, E)
    float* __restrict__ agent_pos,              // (B, 3)
    float* __restrict__ agent_dir)              // (B,)
{
    extern __shared__ float cdf_all[];  // WARPS x R
    __shared__ Placed placed_all[WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + warp;
    if (b >= B) return;  // the whole warp: only warp-level syncs below
    const int lid = layout_id[b];
    const int A = E + 1;
    float* cdf = cdf_all + (size_t)warp * bk.R;
    Placed& pl = placed_all[warp];

    for (int e = lane; e < E; e += 32) {
        pl.x[e] = 0.0f;
        pl.z[e] = 0.0f;
        pl.r[e] = rr.radius[(size_t)b * A + e];
        pl.on[e] = 0;
    }
    build_cdf(bk, b, lid, lane, cdf);

    for (int slot = 0; slot <= E; ++slot) {
        const size_t i = (size_t)b * A + slot;
        const Pose p = place_pose(bk, b, lid, cdf, load_rule(rr, i), seeds[i], budget, pl, E,
                                  lane);
        if (lane == 0) {
            if (slot == E) {
                agent_pos[3 * b] = p.x;
                agent_pos[3 * b + 1] = p.y;
                agent_pos[3 * b + 2] = p.z;
                agent_dir[b] = p.d;
            } else {
                const bool valid = slot_mask[(size_t)b * E + slot] != 0;
                const size_t o = (size_t)b * E + slot;
                ent_pos[3 * o] = valid ? p.x : 0.0f;
                ent_pos[3 * o + 1] = valid ? p.y : 0.0f;
                ent_pos[3 * o + 2] = valid ? p.z : 0.0f;
                ent_dir[o] = valid ? p.d : 0.0f;
                pl.x[slot] = valid ? p.x : 0.0f;
                pl.z[slot] = valid ? p.z : 0.0f;
                pl.on[slot] = valid;
            }
        }
        __syncwarp();  // the next slot's tries read this one's entry
    }
}

// One pose an env against the caller's obstacles (CollectHealth's kit
// respawn inside the step): the same tries as a slot of place_kernel.
__global__ void __launch_bounds__(WARPS * 32) place_one_kernel(
    const unsigned int* __restrict__ seeds,     // (B,)
    const int* __restrict__ layout_id,          // (B,)
    RuleRows rr,                                // (B, ...)
    const float* __restrict__ obs_xz,           // (B, O, 2)
    const float* __restrict__ obs_r,            // (B, O)
    const unsigned char* __restrict__ obs_mask,  // (B, O)
    Bank bk, int B, int O, int budget,
    float* __restrict__ pos,                    // (B, 3)
    float* __restrict__ dir)                    // (B,)
{
    extern __shared__ float cdf_all[];  // WARPS x R
    __shared__ Placed obstacles_all[WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + warp;
    if (b >= B) return;
    const int lid = layout_id[b];
    float* cdf = cdf_all + (size_t)warp * bk.R;
    Placed& pl = obstacles_all[warp];
    for (int e = lane; e < O; e += 32) {
        const size_t o = (size_t)b * O + e;
        pl.x[e] = obs_xz[2 * o];
        pl.z[e] = obs_xz[2 * o + 1];
        pl.r[e] = obs_r[o];
        pl.on[e] = obs_mask[o];
    }
    build_cdf(bk, b, lid, lane, cdf);  // its syncs also publish the obstacles
    const Pose p = place_pose(bk, b, lid, cdf, load_rule(rr, b), seeds[b], budget, pl, O, lane);
    if (lane == 0) {
        pos[3 * b] = p.x;
        pos[3 * b + 1] = p.y;
        pos[3 * b + 2] = p.z;
        dir[b] = p.d;
    }
}

// The dynamic shared memory of a launch (WARPS room CDFs), and the
// kernel's limit raised once where it is above the 48 KB default (not
// per launch, so a captured graph replays no attribute call).
template <typename Kernel>
static int smem_for(Kernel kernel, size_t* opted, int R, size_t* smem) {
    *smem = (size_t)WARPS * R * sizeof(float);
    if (*smem > *opted) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
        if (err != cudaSuccess) return (int)err;
        *opted = *smem;
    }
    return 0;
}

extern "C" int mw_place(
    const unsigned int* seeds, const int* layout_id, const int* rule_room,
    const float* rule_bbox, const float* rule_pos, const float* rule_dir,
    const float* rule_dir_lo, const float* rule_dir_hi, const float* radius,
    const unsigned char* slot_mask,
    const unsigned char* room_mask, const float* room_area, const float* room_aabb,
    const float* room_outline, const float* room_norms, const unsigned char* room_vmask,
    const float* room_segs,
    const float* room_weight, const int* room_seg_wall, const float* wall_open,
    int B, int E, int R, int V, int NS, int Wn, int budget,
    float* ent_pos, float* ent_dir, float* agent_pos, float* agent_dir,
    cudaStream_t stream)
{
    static size_t smem_opted = 48 * 1024;  // the dynamic limit set so far
    if (E > MAX_SLOTS || R < 1 || budget < 0) return (int)cudaErrorInvalidValue;
    if ((room_weight == nullptr) != (room_seg_wall == nullptr) ||
        (room_seg_wall == nullptr) != (wall_open == nullptr))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    Bank bk{room_mask, room_area, room_aabb, room_outline, room_norms, room_vmask,
            room_segs, R, V, NS, room_weight, room_seg_wall, wall_open, Wn};
    RuleRows rr{rule_room, rule_bbox, rule_pos, rule_dir, rule_dir_lo, rule_dir_hi, radius};
    size_t smem;
    const int err = smem_for(place_kernel, &smem_opted, R, &smem);
    if (err) return err;
    place_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, smem, stream>>>(
        seeds, layout_id, rr, slot_mask, bk, B, E, budget, ent_pos, ent_dir, agent_pos,
        agent_dir);
    return (int)cudaGetLastError();
}

extern "C" int mw_place_one(
    const unsigned int* seeds, const int* layout_id, const int* rule_room,
    const float* rule_bbox, const float* rule_pos, const float* rule_dir,
    const float* rule_dir_lo, const float* rule_dir_hi, const float* radius,
    const float* obs_xz, const float* obs_r, const unsigned char* obs_mask,
    const unsigned char* room_mask, const float* room_area, const float* room_aabb,
    const float* room_outline, const float* room_norms, const unsigned char* room_vmask,
    const float* room_segs,
    const float* room_weight, const int* room_seg_wall, const float* wall_open,
    int B, int O, int R, int V, int NS, int Wn, int budget,
    float* pos, float* dir, cudaStream_t stream)
{
    static size_t smem_opted = 48 * 1024;
    if (O > MAX_SLOTS || O < 0 || R < 1 || budget < 0) return (int)cudaErrorInvalidValue;
    if ((room_weight == nullptr) != (room_seg_wall == nullptr) ||
        (room_seg_wall == nullptr) != (wall_open == nullptr))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    Bank bk{room_mask, room_area, room_aabb, room_outline, room_norms, room_vmask,
            room_segs, R, V, NS, room_weight, room_seg_wall, wall_open, Wn};
    RuleRows rr{rule_room, rule_bbox, rule_pos, rule_dir, rule_dir_lo, rule_dir_hi, radius};
    size_t smem;
    const int err = smem_for(place_one_kernel, &smem_opted, R, &smem);
    if (err) return err;
    place_one_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, smem, stream>>>(
        seeds, layout_id, rr, obs_xz, obs_r, obs_mask, bk, B, O, budget, pos, dir);
    return (int)cudaGetLastError();
}

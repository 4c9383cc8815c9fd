// Reset-time placement: every entity slot of a reset, in order, then the
// agent, by budgeted rejection sampling — one thread per env.
//
// Replaces: miniworld_tpu/ops/place.py:place_one chained over the slots
// as in miniworld_tpu/vector.py:_reset_one's place_body (E entity
// slots, then the agent), XLA-fused jnp in the JAX package. The plain
// PyTorch version is place_all_plain in miniworld_tpu_torch/ops/place.py,
// which runs place_one per slot over the whole batch; the two agree bit
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
// rooms and 40 segments)
// come near the card's rates; the E+1 placements of an env are a
// dependent chain (each collides with the ones before it), so the
// kernel is latency-bound. What the design buys is the launch count:
// one launch per reset instead of the thousands of small launches of
// the plain version (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <float.h>

#include "rng.cuh"

#define MAX_SLOTS 32

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

// a room's draw weight: its area where it exists, times the env's
// procgen room weight
__device__ __forceinline__ float room_prob(const unsigned char* mask, const float* area,
                                           const float* weight, int r) {
    const float p = mask[r] ? area[r] : 0.0f;
    return weight != nullptr ? p * weight[r] : p;
}

// sample_room: first room whose running weight sum exceeds u * total
__device__ int sample_room(const Bank& bk, int b, int lid, float u) {
    const unsigned char* mask = bk.room_mask + (size_t)lid * bk.R;
    const float* area = bk.room_area + (size_t)lid * bk.R;
    const float* weight = bk.room_weight != nullptr ? bk.room_weight + (size_t)b * bk.R : nullptr;
    float total = 0.0f;
    for (int r = 0; r < bk.R; ++r) total = total + room_prob(mask, area, weight, r);
    const float thr = u * total;
    float cdf = 0.0f;
    for (int r = 0; r < bk.R; ++r) {
        cdf = cdf + room_prob(mask, area, weight, r);
        if (thr < cdf) return r;
    }
    return 0;
}

struct Rule {
    int room;
    float bbox[4];
    float radius;
};

// One try: the candidate position (x, z; y is 0) and whether it is free.
__device__ bool one_try(const Bank& bk, int b, int lid, const Rule& rule, const float* u,
                        const float* ex, const float* ez, const float* er,
                        const bool* placed, int n_ents, float* px_out, float* pz_out) {
    const int room = rule.room >= 0 ? rule.room : sample_room(bk, b, lid, u[0]);
    const size_t lr = (size_t)lid * bk.R + room;
    const float* aabb = bk.room_aabb + lr * 4;
    float bbox[4];
    for (int k = 0; k < 4; ++k) bbox[k] = isnan(rule.bbox[k]) ? aabb[k] : rule.bbox[k];
    const float r = rule.radius;
    const float lo_x = bbox[0] - r, hi_x = bbox[1] + r;
    const float lo_z = bbox[2] - r, hi_z = bbox[3] + r;
    const float px = lo_x + u[1] * (hi_x - lo_x);
    const float pz = lo_z + u[3] * (hi_z - lo_z);
    *px_out = px;
    *pz_out = pz;

    bool inside = true;
    const float* outline = bk.room_outline + lr * bk.V * 2;
    const float* norms = bk.room_norms + lr * bk.V * 2;
    const unsigned char* vmask = bk.room_vmask + lr * bk.V;
    for (int v = 0; v < bk.V; ++v) {
        if (!vmask[v]) continue;
        const float apx = px - outline[2 * v];
        const float apz = pz - outline[2 * v + 1];
        const float dot = norms[2 * v] * apx + norms[2 * v + 1] * apz;
        inside = inside && (dot > 0.0f);
    }

    bool wall_hit = false;
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
        wall_hit = wall_hit || (dx * dx + dz * dz < rr);
    }

    bool ent_hit = false;
    for (int e = 0; e < n_ents; ++e) {
        if (!placed[e]) continue;
        const float dx = ex[e] - px;
        const float dz = ez[e] - pz;
        const float rsum = r + er[e];
        ent_hit = ent_hit || (dx * dx + dz * dz < rsum * rsum);
    }
    return inside && !wall_hit && !ent_hit;
}

__global__ void place_kernel(
    const unsigned int* __restrict__ seeds,     // (B, E+1) per-slot subseeds
    const int* __restrict__ layout_id,          // (B,)
    const int* __restrict__ rule_room,          // (B, E+1)
    const float* __restrict__ rule_bbox,        // (B, E+1, 4), nan = room bbox
    const float* __restrict__ rule_pos,         // (B, E+1, 3), nan = sample
    const float* __restrict__ rule_dir,         // (B, E+1), nan = sample range
    const float* __restrict__ rule_dir_lo,      // (B, E+1)
    const float* __restrict__ rule_dir_hi,      // (B, E+1)
    const float* __restrict__ radius,           // (B, E+1), row E the agent's
    const unsigned char* __restrict__ slot_mask,  // (B, E)
    Bank bk, int B, int E, int budget,
    float* __restrict__ ent_pos,                // (B, E, 3)
    float* __restrict__ ent_dir,                // (B, E)
    float* __restrict__ agent_pos,              // (B, 3)
    float* __restrict__ agent_dir)              // (B,)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int lid = layout_id[b];
    const int A = E + 1;
    float ex[MAX_SLOTS], ez[MAX_SLOTS], er[MAX_SLOTS];
    bool placed[MAX_SLOTS];
    for (int e = 0; e < E; ++e) {
        ex[e] = 0.0f;
        ez[e] = 0.0f;
        er[e] = radius[(size_t)b * A + e];
        placed[e] = false;
    }

    for (int slot = 0; slot <= E; ++slot) {
        const size_t i = (size_t)b * A + slot;
        Rule rule;
        rule.room = rule_room[i];
        for (int k = 0; k < 4; ++k) rule.bbox[k] = rule_bbox[i * 4 + k];
        rule.radius = radius[i];
        const unsigned int key = hash_u32(seeds[i], 1u);  // uniforms(seed, 1, ...)
        float u[4];
        for (int j = 0; j < 4; ++j) u[j] = hash01(key, (unsigned int)(4 * budget + j));
        float px, pz;
        one_try(bk, b, lid, rule, u, ex, ez, er, placed, E, &px, &pz);  // the fallback candidate
        bool found = false;
        for (int t = 0; t < budget; ++t) {
            for (int j = 0; j < 4; ++j) u[j] = hash01(key, (unsigned int)(4 * t + j));
            float cx, cz;
            const bool ok = one_try(bk, b, lid, rule, u, ex, ez, er, placed, E, &cx, &cz);
            if (ok && !found) {
                px = cx;
                pz = cz;
            }
            found = found || ok;
        }
        const float u_room = hash01(key, (unsigned int)(4 * (budget + 1)));
        const float u_dir = hash01(key, (unsigned int)(4 * (budget + 1) + 1));
        float py = 0.0f;
        if (!found) {
            // clamp into the fallback room's bbox inset by the radius
            const int room = rule.room >= 0 ? rule.room : sample_room(bk, b, lid, u_room);
            const float* aabb = bk.room_aabb + ((size_t)lid * bk.R + room) * 4;
            const float r = rule.radius;
            const float lo_x = fminf(aabb[0] + r, aabb[1] - r), hi_x = fmaxf(aabb[0] + r, aabb[1] - r);
            const float lo_z = fminf(aabb[2] + r, aabb[3] - r), hi_z = fmaxf(aabb[2] + r, aabb[3] - r);
            px = fminf(fmaxf(px, lo_x), hi_x);
            pz = fminf(fmaxf(pz, lo_z), hi_z);
        }
        if (!isnan(rule_pos[i * 3])) {  // exact position, nan_to_num'd
            float p[3];
            for (int k = 0; k < 3; ++k) {
                const float v = rule_pos[i * 3 + k];
                p[k] = isnan(v) ? 0.0f : (isinf(v) ? (v > 0.0f ? FLT_MAX : -FLT_MAX) : v);
            }
            px = p[0];
            py = p[1];
            pz = p[2];
        }
        const float rd = rule_dir[i];
        const float lo = rule_dir_lo[i];
        const float d = isnan(rd) ? lo + u_dir * (rule_dir_hi[i] - lo) : rd;

        if (slot == E) {
            agent_pos[3 * b] = px;
            agent_pos[3 * b + 1] = py;
            agent_pos[3 * b + 2] = pz;
            agent_dir[b] = d;
        } else {
            const bool valid = slot_mask[(size_t)b * E + slot] != 0;
            const size_t o = (size_t)b * E + slot;
            ent_pos[3 * o] = valid ? px : 0.0f;
            ent_pos[3 * o + 1] = valid ? py : 0.0f;
            ent_pos[3 * o + 2] = valid ? pz : 0.0f;
            ent_dir[o] = valid ? d : 0.0f;
            ex[slot] = valid ? px : 0.0f;
            ez[slot] = valid ? pz : 0.0f;
            placed[slot] = valid;
        }
    }
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
    if (E > MAX_SLOTS) return (int)cudaErrorInvalidValue;
    if ((room_weight == nullptr) != (room_seg_wall == nullptr) ||
        (room_seg_wall == nullptr) != (wall_open == nullptr))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    Bank bk{room_mask, room_area, room_aabb, room_outline, room_norms, room_vmask,
            room_segs, R, V, NS, room_weight, room_seg_wall, wall_open, Wn};
    const int threads = 128;
    place_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
        seeds, layout_id, rule_room, rule_bbox, rule_pos, rule_dir, rule_dir_lo,
        rule_dir_hi, radius, slot_mask, bk, B, E, budget,
        ent_pos, ent_dir, agent_pos, agent_dir);
    return (int)cudaGetLastError();
}

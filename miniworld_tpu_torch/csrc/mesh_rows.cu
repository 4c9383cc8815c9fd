// World-space triangle rows of every dynamic mesh entity, for the whole
// batch in one launch.
//
// Replaces: miniworld_tpu/render/raycast.py:entity_mesh_rows, an
// XLA-fused jnp stage of every render with mesh entities (vmapped over
// the entity slots). The plain PyTorch version is entity_mesh_rows_plain
// in miniworld_tpu_torch/render/raycast.py; with -fmad=false the
// arithmetic below matches it operation by operation, so the two agree
// bit for bit.
//
// For env b and row r = e * M + m, with p = ent_proto[b, e] and the
// local row q = proto_mesh[layout, p, m] (25 floats: three vertices, the
// affine-uv rows a1 | a2 | b, the normal, the colour, the slot, the last
// attribute) and R the yaw rotation of ent_dir[b, e]:
//   verts  = R v * su + pos, su = height / max(proto height, 1e-9);
//   a1, a2 = R a * (1 / max(su, 1e-9)), b1, b2 = b - a . pos;
//   normal = R n; colour = q.colour * (colorable ? ent_color : 1);
//   slot   = Fourier: slot >= 0 ? tex_slot_base[layout, max(rint(slot), 0)]
//            : -1; nearest: the local slot;
//   valid  = mask & alive & !static & shape == SHAPE_MESH_TRIS, the
//            vertices zeroed where it is false.
// R v sums its three column products in the plain version's order,
// v0 * (cd, 0, -sd) + v1 * (0, 1, 0) + v2 * (sd, 0, cd); the dots run
// left to right; cd, sd are cosf / sinf, as torch.cos / torch.sin give
// them on the card.
//
// What bounds it on an H100: the bytes it writes, 101 a row (36 of
// vertices, 64 of attributes, the valid byte): 89 MB at CollectHealth's
// B = 1024 and 864 rows a render, 0.027 ms at 3.35 TB/s. The reads are
// small beside that: the prototype rows are shared by every env of a
// layout (a few hundred KB), and an entity's state by its M rows. The
// operations, some 70 a row, are far below the byte time.
//
// Design. One thread a (env, row), 128 a block, over B * E * M threads.
// The prototype rows and the entity's state go through the read-only
// path (__ldg), so the M threads of one entity and the envs of one
// layout hit in L1 / L2. verts9 is (B, 9, E * M) component-major:
// consecutive threads store consecutive floats of each of the 9 rows;
// the 16 attributes of a row go out as four float4 stores. Padding rows
// and rows of inactive entities are written like any other (their
// vertices zero), so the outputs need no fill.

#include <cuda_runtime.h>

#define SHAPE_MESH_TRIS 4
#define ROW_DIM 25   // floats a local mesh row (scene/mesh.py)
#define ATTR_DIM 16  // floats a row's attributes (render/raycast.ATTR_DIM)
#define THREADS 128

__global__ void __launch_bounds__(THREADS) mesh_rows_kernel(
    const float* __restrict__ proto_mesh, const unsigned char* __restrict__ proto_mesh_mask,
    const int* __restrict__ proto_shape, const unsigned char* __restrict__ proto_static,
    const float* __restrict__ proto_height, const unsigned char* __restrict__ proto_colorable,
    const int* __restrict__ tex_slot_base, const void* __restrict__ layout_id,
    const int* __restrict__ ent_proto, const unsigned char* __restrict__ ent_alive,
    const float* __restrict__ ent_height, const float* __restrict__ ent_dir,
    const float* __restrict__ ent_pos, const float* __restrict__ ent_color,
    int B, int E, int L, int P, int M, int T, int lid64, int fourier,
    float* __restrict__ verts9, float* __restrict__ attrs, unsigned char* __restrict__ valid)
{
    const int n = E * M;
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= (long long)B * n) return;
    const int b = (int)(idx / n), r = (int)(idx - (long long)b * n);
    const int e = r / M, m = r - e * M;

    int lid = lid64 ? (int)__ldg((const long long*)layout_id + b)
                    : __ldg((const int*)layout_id + b);
    lid = min(max(lid, 0), L - 1);
    const int i = b * E + e;  // the entity's slot in the (B, E) state
    const int p = min(max(__ldg(ent_proto + i), 0), P - 1);
    const int lp = lid * P + p;
    const float* q = proto_mesh + ((size_t)lp * M + m) * ROW_DIM;

    const bool ok = __ldg(proto_mesh_mask + (size_t)lp * M + m) && __ldg(ent_alive + i) &&
                    !__ldg(proto_static + lp) && __ldg(proto_shape + lp) == SHAPE_MESH_TRIS;
    const float su = __ldg(ent_height + i) / fmaxf(__ldg(proto_height + lp), 1e-9f);
    const float dir = __ldg(ent_dir + i);
    const float cd = cosf(dir), sd = sinf(dir), msd = -sd;
    const float px = __ldg(ent_pos + 3 * i), py = __ldg(ent_pos + 3 * i + 1),
                pz = __ldg(ent_pos + 3 * i + 2);

    // R a, the columns' products summed in order: a0 col_x + a1 col_y + a2 col_z
#define ROT0(a0, a1, a2) ((a0) * cd + (a1) * 0.0f + (a2) * sd)
#define ROT1(a0, a1, a2) ((a0) * 0.0f + (a1) * 1.0f + (a2) * 0.0f)
#define ROT2(a0, a1, a2) ((a0) * msd + (a1) * 0.0f + (a2) * cd)

    const size_t vbase = (size_t)b * 9 * n + r;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
        const float a0 = __ldg(q + 3 * v), a1 = __ldg(q + 3 * v + 1), a2 = __ldg(q + 3 * v + 2);
        const float x = ROT0(a0, a1, a2) * su + px;
        const float y = ROT1(a0, a1, a2) * su + py;
        const float z = ROT2(a0, a1, a2) * su + pz;
        verts9[vbase + (size_t)(3 * v) * n] = ok ? x : 0.0f;
        verts9[vbase + (size_t)(3 * v + 1) * n] = ok ? y : 0.0f;
        verts9[vbase + (size_t)(3 * v + 2) * n] = ok ? z : 0.0f;
    }

    const float inv_su = 1.0f / fmaxf(su, 1e-9f);
    float w[ATTR_DIM];
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // a1, a2 and their b
        const float a0 = __ldg(q + 9 + 3 * k), a1 = __ldg(q + 10 + 3 * k),
                    a2 = __ldg(q + 11 + 3 * k);
        const float x = ROT0(a0, a1, a2) * inv_su;
        const float y = ROT1(a0, a1, a2) * inv_su;
        const float z = ROT2(a0, a1, a2) * inv_su;
        w[3 * k] = x;
        w[3 * k + 1] = y;
        w[3 * k + 2] = z;
        w[6 + k] = __ldg(q + 15 + k) - (x * px + y * py + z * pz);
    }
    {
        const float a0 = __ldg(q + 17), a1 = __ldg(q + 18), a2 = __ldg(q + 19);
        w[8] = ROT0(a0, a1, a2);
        w[9] = ROT1(a0, a1, a2);
        w[10] = ROT2(a0, a1, a2);
    }
#undef ROT0
#undef ROT1
#undef ROT2
    const bool tint = __ldg(proto_colorable + lp);
#pragma unroll
    for (int c = 0; c < 3; ++c)
        w[11 + c] = __ldg(q + 20 + c) * (tint ? __ldg(ent_color + 3 * i + c) : 1.0f);
    float slot = __ldg(q + 23);
    if (fourier) {
        const int s = min(max((int)rintf(slot), 0), T - 1);
        slot = slot >= 0.0f ? (float)__ldg(tex_slot_base + (size_t)lid * T + s) : -1.0f;
    }
    w[14] = slot;
    w[15] = __ldg(q + 24);

    float4* out = reinterpret_cast<float4*>(attrs + (size_t)idx * ATTR_DIM);
#pragma unroll
    for (int k = 0; k < 4; ++k)
        out[k] = make_float4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
    valid[idx] = ok ? 1 : 0;
}

extern "C" int mw_entity_mesh_rows(
    const float* proto_mesh, const unsigned char* proto_mesh_mask, const int* proto_shape,
    const unsigned char* proto_static, const float* proto_height,
    const unsigned char* proto_colorable, const int* tex_slot_base, const void* layout_id,
    const int* ent_proto, const unsigned char* ent_alive, const float* ent_height,
    const float* ent_dir, const float* ent_pos, const float* ent_color,
    int B, int E, int L, int P, int M, int T, int lid64, int fourier,
    float* verts9, float* attrs, unsigned char* valid, cudaStream_t stream)
{
    if (B < 0 || E < 0 || M < 0 || L < 1 || P < 1 || T < 1) return (int)cudaErrorInvalidValue;
    const long long total = (long long)B * E * M;
    if (total == 0) return 0;
    const long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    mesh_rows_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
        proto_mesh, proto_mesh_mask, proto_shape, proto_static, proto_height, proto_colorable,
        tex_slot_base, layout_id, ent_proto, ent_alive, ent_height, ent_dir, ent_pos, ent_color,
        B, E, L, P, M, T, lid64, fourier, verts9, attrs, valid);
    return (int)cudaGetLastError();
}

// Device code shared by the two scans of a procgen super bank's dense
// rows (tri_pass_ortho.cu, the top view; visible_ents.cu, the occlusion
// queries): whether a row is live in an env, the JAX package's dense
// tri_active = tri_active_base + wall_open @ tri_wall_onehot > 0.5
// (miniworld_tpu/render/topview.py:77-84, visibility.py:119-123), decoded
// from the row's code as render/topview.py's row_live does.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// code (topview.wall_codes) -1: a row no wall kills; -2: a row no env
// draws, or padding; 2w: live where wall w is open (base 0, sign +1);
// 2w + 1: live where it is closed (base 1, sign -1). A maze row without
// the env's walls (wall_open null) is never live.
__device__ __forceinline__ bool row_live(const int code, const float* __restrict__ wall_open,
                                         const int b, const int NW) {
    if (code < 0) return code == -1;
    if (wall_open == nullptr) return false;
    const float base = (code & 1) ? 1.0f : 0.0f;
    const float sign = (code & 1) ? -1.0f : 1.0f;
    return base + sign * wall_open[(size_t)b * NW + (code >> 1)] > 0.5f;
}

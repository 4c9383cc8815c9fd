// Counter-based uniforms of miniworld_tpu_torch/ops/rng.py (the JAX
// package's ops/rng.py) in 32-bit unsigned arithmetic, for the kernels
// that draw their own numbers (place.cu, mazegen.cu) and tri_pass.cu's
// texture-variant override.
#pragma once

static __device__ __forceinline__ unsigned int hash_u32(unsigned int key, unsigned int id) {
    unsigned int x = (id * 0x9E3779B9u) ^ key;
    x = (x ^ (x >> 16)) * 0x7FEB352Du;
    x = (x ^ (x >> 15)) * 0x846CA68Bu;
    return x ^ (x >> 16);
}

// uniform float in [0, 1) with 24-bit resolution
static __device__ __forceinline__ float hash01(unsigned int key, unsigned int id) {
    return (float)(hash_u32(key, id) >> 8) * (1.0f / 16777216.0f);
}

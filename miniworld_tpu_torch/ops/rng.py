"""Counter-based uniforms and threefry key splitting, bit-exact with JAX.

Counterpart of ``miniworld_tpu/ops/rng.py`` plus the pieces of
``jax.random`` the env engine consumes: ``split``, ``random_bits`` and
``randint`` on raw threefry2x32 key data, in the
``jax_threefry_partitionable=True`` form (JAX's default: word i of a
draw from key k is ``threefry2x32(k, (0, i))``, its two outputs xored
for 32-bit bits, kept apart for a split). Keys are (..., 2) tensors of
the two uint32 key words.

All u32 arithmetic runs in int64 with an explicit ``& 0xFFFFFFFF``:
torch's uint32 kernels cover few ops on either CPU or CUDA. Products
of two u32 values would overflow int64, so ``_mul32`` splits one factor
into 16-bit halves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from miniworld_tpu_torch.ops import geom

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for u32 values held in int64."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011), as jax implements it."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key_data(seed: int, device=None) -> torch.Tensor:
    """(2,) key data of ``jax.random.key(seed)`` for 0 <= seed < 2**32."""
    if not 0 <= int(seed) <= M32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return torch.tensor([0, int(seed)], dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split`` on key data: (..., 2) -> (..., num, 2)."""
    k0 = key[..., 0:1]
    k1 = key[..., 1:2]
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(counts), counts)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.bits(key, (num,), jnp.uint32)`` on key data: (..., 2)
    -> (..., num) u32 in int64 (jax/_src/prng.py
    _threefry_random_bits_partitionable)."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(counts), counts)
    return b0 ^ b1


def randint(key: torch.Tensor, num, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, (num,), 0, maxval)`` (int32) on key data:
    (..., 2) -> (..., num) int64 in [0, maxval), 0 < maxval < 2**31
    (jax/_src/random.py _randint): two words of bits from the key's two
    splits, folded with the multiplier (2**16 mod maxval)**2 mod
    maxval. ``num=()`` draws ``randint(key, (), 0, maxval)``: (...,),
    the first word of each split."""
    if not 0 < int(maxval) < (1 << 31):
        raise ValueError(f"randint needs 0 < maxval < 2**31, got {maxval}")
    if num == ():
        return randint(key, 1, maxval)[..., 0]
    span = int(maxval)
    bits = random_bits(split(key, 2), num)  # both splits' words in one threefry call
    hi, lo = bits[..., 0, :], bits[..., 1, :]
    mult = ((1 << 16) % span) ** 2 % span
    return ((hi % span) * mult + lo % span) % span


def uniform(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)`` on
    key data: (..., 2) -> (..., *shape) f32 (jax/_src/random.py
    _uniform): the top 23 of each word of ``random_bits`` as the
    mantissa of a float in [1, 2), minus 1, then ``f * (max - min) +
    min``, rounded twice, and ``max(min, .)``. ``minval`` / ``maxval``
    broadcast against the result's trailing axes; a batch of keys (...,
    k, 2) with (k,) bounds draws k parameters of shape () in one
    threefry call. (XLA:CPU contracts the scaling into one fused
    multiply-add inside some of the JAX package's step programs: ROADMAP
    C1.)"""
    n = math.prod(int(s) for s in shape)
    bits = random_bits(key, n).reshape(key.shape[:-1] + tuple(shape))
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.as_tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def hash_u32(key, ids: torch.Tensor) -> torch.Tensor:
    """Full-width u32 mix of (key, id) — subseed derivation."""
    x = _mul32(ids.to(torch.int64) & M32, _GOLDEN) ^ key
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def hash01(key, ids: torch.Tensor) -> torch.Tensor:
    """Uniform float32 in [0, 1) keyed on (key, id); 24-bit resolution."""
    x = hash_u32(key, ids)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def cheap_seed(key: torch.Tensor) -> torch.Tensor:
    """(...,) u32 seed from key data (..., 2): first ^ last * golden."""
    return key[..., 0] ^ _mul32(key[..., -1], _GOLDEN)


def sub(seed: torch.Tensor, purpose: int) -> torch.Tensor:
    """Purpose-separated subseed."""
    return hash_u32(seed, torch.full_like(seed, purpose))


def uniforms(seed: torch.Tensor, purpose: int, shape) -> torch.Tensor:
    """Uniform [0, 1) tensor keyed on (seed, purpose): seed (B,) ->
    (B, *shape)."""
    n = 1
    for s in shape:
        n *= int(s)
    ids = torch.arange(n, dtype=torch.int64, device=seed.device)
    u = hash01(sub(seed, purpose)[:, None], ids[None, :])
    return u.reshape((seed.shape[0],) + tuple(shape))


# -- the trainer's draws (jax/_src/random.py) --------------------------------

_TINY = float(np.finfo(np.float32).tiny)
# jax.random.normal's open interval: nextafter(-1, 0) to 1
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# XLA's single-precision erf_inv (Giles 2010), w < 5 and w >= 5 branches
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` on key data (..., 2): threefry of
    the count words (0, data) (jax/_src/prng.py threefry_fold_in), which
    is also ``split(key, n)[data]`` for any n > data."""
    d = int(data) & M32
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(key[..., 0]),
                          torch.full_like(key[..., 0], d))
    return torch.stack([b0, b1], dim=-1)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function in XLA's arithmetic (ErfInv32 of
    XLA's math library, Giles' single-precision polynomials):
    ``w = -log1p(-x * x)``, a degree-8 polynomial in ``w - 2.5`` (w < 5)
    or ``sqrt(w) - 3``, times x; +-1 map to +-inf. XLA:CPU's log1p is its
    own expansion, so the C library's ``log1pf`` in its place leaves the
    result within 2 ulps of the JAX package's (tests/test_torch_rng.py)."""
    w = -geom.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, geom.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge) + p * w
    inf = torch.full_like(x, math.inf)
    return torch.where(x.abs() == 1.0, torch.copysign(inf, x), p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, jnp.float32)`` on key data (2,):
    ``sqrt(2) * erf_inv(uniform(key, shape, nextafter(-1, 0), 1))``
    (jax/_src/random.py _normal_real)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * erf_inv(u)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, on key
    data (2,): the Gumbel-max trick in JAX's default "low" mode, argmax of
    ``logits - log(-log(uniform(key, logits.shape, tiny, 1)))``, the first
    index on a tie (jax/_src/random.py _gumbel). Returns int64 indices of
    shape ``logits.shape[:-1]``. The double log turns one ulp of a log
    into many, so a draw where two candidates nearly tie can differ from
    the JAX package's (the tests count the share that agrees)."""
    u = uniform(key, tuple(logits.shape), _TINY, 1.0)
    gumbel = -geom.log(-geom.log(u))
    return torch.argmax(gumbel + logits.to(torch.float32), dim=-1)

"""The port's threefry split and counter-based uniforms are bit-exact
with jax.random and miniworld_tpu/ops/rng.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu.ops import rng as jrng
from miniworld_tpu_torch.ops import rng as trng

SEEDS = [0, 1, 12345, 2**32 - 1]


def _kd(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


@pytest.mark.parametrize("num", [1, 3, 8, 1024])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_from_seed(seed, num):
    want = _kd(jax.random.split(jax.random.key(seed), num))
    got = trng.split(trng.key_data(seed), num).numpy()
    np.testing.assert_array_equal(got, want)


def test_split_batched_keys():
    """Splitting a batch of keys (the step's per-env 3-way split)."""
    keys = jax.random.split(jax.random.key(5), 64)
    want = _kd(jax.vmap(lambda k: jax.random.split(k, 3))(keys))
    got = trng.split(torch.from_numpy(_kd(keys)), 3).numpy()
    np.testing.assert_array_equal(got, want)


def _seeds_pair(n=64):
    keys = jax.random.split(jax.random.key(11), n)
    j_seed = jax.vmap(jrng.cheap_seed)(keys)
    t_seed = trng.cheap_seed(torch.from_numpy(_kd(keys)))
    return j_seed, t_seed


def test_cheap_seed():
    j_seed, t_seed = _seeds_pair()
    np.testing.assert_array_equal(t_seed.numpy(), np.asarray(j_seed).astype(np.int64))


@pytest.mark.parametrize("fn", ["hash_u32", "hash01"])
def test_hashes(fn):
    j_seed, t_seed = _seeds_pair()
    ids = np.arange(257, dtype=np.uint32)
    want = np.asarray(getattr(jrng, fn)(j_seed[:, None], jnp.asarray(ids)[None, :]))
    got = getattr(trng, fn)(t_seed[:, None], torch.from_numpy(ids.astype(np.int64))[None, :])
    if fn == "hash_u32":
        want = want.astype(np.int64)
    else:
        assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("purpose,shape", [(1, (18, 4)), (11, (3,)), (15, (8, 3)), (18, ())])
def test_sub_and_uniforms(purpose, shape):
    j_seed, t_seed = _seeds_pair()
    np.testing.assert_array_equal(
        trng.sub(t_seed, purpose).numpy(),
        np.asarray(jax.vmap(lambda s: jrng.sub(s, purpose))(j_seed)).astype(np.int64),
    )
    want = np.asarray(jax.vmap(lambda s: jrng.uniforms(s, purpose, shape))(j_seed))
    np.testing.assert_array_equal(trng.uniforms(t_seed, purpose, shape).numpy(), want)


@pytest.mark.parametrize("maxval", [3, 6, 8])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed, maxval):
    """``randint`` on key data equals ``jax.random.randint(key, (n,), 0,
    maxval)``, from a seed's key and from split keys, batched."""
    keys = jax.random.split(jax.random.key(seed), 5)
    want = np.stack([np.asarray(jax.random.randint(k, (300,), 0, maxval)) for k in keys])
    got = trng.randint(torch.from_numpy(_kd(keys)), 300, maxval).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jax.random.randint(jax.random.key(seed), (7,), 0, maxval))
    np.testing.assert_array_equal(trng.randint(trng.key_data(seed), 7, maxval).numpy(), want)
    assert set(np.unique(got)) == set(range(maxval))


def test_random_bits():
    key = jax.random.key(9)
    want = np.asarray(jax.random.bits(key, (64,), jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(trng.random_bits(trng.key_data(9), 64).numpy(), want)

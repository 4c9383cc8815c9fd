"""The port's threefry split and counter-based uniforms are bit-exact
with jax.random and miniworld_tpu/ops/rng.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniworld_tpu.ops import rng as jrng
from miniworld_tpu_torch.ops import rng as trng

from _torch_parity import one_torch_thread  # noqa: F401 (autouse: torch on one thread)

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


# -- the trainer's draws ---------------------------------------------------------

NORMAL_ULPS = 3  # the largest distance measured
CATEGORICAL_MIN_SHARE = 0.999


def _ulps(a, b) -> int:
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(a) - key(b)).max())


@pytest.mark.parametrize("data", [0, 1, 7, 2**31 + 5, 2**32 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, data):
    want = _kd(jax.random.fold_in(jax.random.key(seed), data))
    np.testing.assert_array_equal(trng.fold_in(trng.key_data(seed), data).numpy(), want)
    # batched keys, and fold_in(k, 0) is the first of any split of k
    keys = jax.random.split(jax.random.key(seed), 4)
    want = np.stack([_kd(jax.random.fold_in(k, data)) for k in keys])
    np.testing.assert_array_equal(trng.fold_in(torch.from_numpy(_kd(keys)), data).numpy(), want)
    np.testing.assert_array_equal(trng.fold_in(trng.key_data(seed), 0).numpy(),
                                  trng.split(trng.key_data(seed), 3)[0].numpy())


@pytest.mark.parametrize("maxval", [3, 5, 7, 100, 4095, 49152])
def test_randint_scalar(maxval):
    """``randint(key, (), 0, maxval)``: PPO's roll offset."""
    keys = jax.random.split(jax.random.key(13), 64)
    want = np.array([int(jax.random.randint(k, (), 0, maxval)) for k in keys])
    got = trng.randint(torch.from_numpy(_kd(keys)), (), maxval).numpy()
    assert got.shape == (64,)
    np.testing.assert_array_equal(got, want)


def test_uniform_tiny_to_one():
    """The Gumbel draw's ``uniform(key, shape, tiny, 1)``: bit for bit."""
    tiny = float(np.finfo(np.float32).tiny)
    for seed in SEEDS:
        want = np.asarray(jax.random.uniform(jax.random.key(seed), (999, 3), minval=tiny,
                                             maxval=1.0))
        got = trng.uniform(trng.key_data(seed), (999, 3), tiny, 1.0).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal(seed):
    """``normal``: XLA's erf_inv polynomial with the C library's log1pf
    for XLA:CPU's own log1p, within NORMAL_ULPS of jax.random.normal."""
    want = np.asarray(jax.random.normal(jax.random.key(seed), (100_000,)))
    got = trng.normal(trng.key_data(seed), (100_000,)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _ulps(got, want) <= NORMAL_ULPS
    want = np.asarray(jax.random.normal(jax.random.key(seed), (3, 3, 4, 16)))
    got = trng.normal(trng.key_data(seed), (3, 3, 4, 16)).numpy()
    assert got.shape == (3, 3, 4, 16) and _ulps(got, want) <= NORMAL_ULPS


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, -0.5, 0.5], dtype=torch.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    got = trng.erf_inv(x).numpy()
    np.testing.assert_array_equal(got[:3], want[:3])
    assert _ulps(got[3:], want[3:]) <= 2


@pytest.mark.parametrize("n_actions", [3, 6])
def test_categorical(n_actions):
    """100k (B, A) draws from the same f32 logits: equal on at least
    CATEGORICAL_MIN_SHARE of them (printed; a draw whose two best
    candidates nearly tie may go the other way, the double log amplifying
    an ulp of a log)."""
    rng = np.random.default_rng(n_actions)
    logits = (rng.normal(size=(100_000, n_actions)) * 2.0).astype(np.float32)
    want = np.asarray(jax.random.categorical(jax.random.key(4), logits))
    got = trng.categorical(trng.key_data(4), torch.from_numpy(logits)).numpy()
    assert got.shape == want.shape
    share = (got == want).mean()
    print(f"categorical, {n_actions} actions: {share:.6f} of {len(got)} draws equal")
    assert share >= CATEGORICAL_MIN_SHARE
    # zero logits: the Gumbel draw's own argmax
    flat = np.zeros((1000, n_actions), np.float32)
    want = np.asarray(jax.random.categorical(jax.random.key(8), flat))
    got = trng.categorical(trng.key_data(8), torch.from_numpy(flat)).numpy()
    assert (got == want).mean() >= CATEGORICAL_MIN_SHARE

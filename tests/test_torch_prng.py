"""Port parity, the counter PRNG of Monte-Carlo path tracing: the port's
host-side key derivation (``utils/prng.py``) against ``jax.random`` on raw
keys, and the per-ray draws of ``raytracer/montecarlo.py`` against the JAX
package's, bit for bit (the Box-Muller normals to 1e-6: they go through
log, cos and sin)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvsrn_tpu.raytracer import montecarlo as jmc
from fvsrn_tpu_torch.raytracer import montecarlo as tmc
from fvsrn_tpu_torch.utils import prng

torch.set_num_threads(1)
RAY_IDS = np.arange(10_000, dtype=np.uint32)


def words(key):
    return [int(v) for v in np.asarray(key)]


@pytest.mark.parametrize("seed", [0, 7, 42, 2 ** 31 - 1, -3])
def test_keys_match_jax(seed):
    """PRNGKey, split into 2 and 5, fold_in and a chain of them."""
    jk = jax.random.PRNGKey(seed)
    k = prng.prng_key(seed)
    assert list(k) == words(jk)
    for n in (2, 5):
        assert [list(v) for v in prng.split(k, n)] == [
            words(v) for v in jax.random.split(jk, n)]
    for data in (0, 7, 123456):
        assert list(prng.fold_in(k, data)) == words(
            jax.random.fold_in(jk, data))
    jc = jax.random.split(jax.random.fold_in(jax.random.split(jk, 5)[4], 7))
    c = prng.split(prng.fold_in(prng.split(k, 5)[4], 7))
    assert [list(v) for v in c] == [words(v) for v in jc]


def test_split_is_fold_in_over_the_counter():
    """split(k, n)[i] is the Threefry block of k over (0, i); for
    PRNGKey(42) and i = 0 that is [1832780943, 270669613]."""
    k = prng.prng_key(42)
    assert prng.split(k, 5)[0] == (1832780943, 270669613)
    assert prng.split(k, 5) == tuple(prng.fold_in(k, i) for i in range(5))


def test_threefry_on_tensors_matches_ints():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, (2, 64), dtype=np.uint64)
    got = prng.threefry2x32(123, 4_000_000_000, torch.tensor(x[0]
                                                            .astype(np.int64)),
                            torch.tensor(x[1].astype(np.int64)))
    for i in range(64):
        want = prng.threefry2x32(123, 4_000_000_000, int(x[0, i]),
                                 int(x[1, i]))
        assert (int(got[0][i]), int(got[1][i])) == want


@pytest.mark.parametrize("salt", [0, 1, 2, 3])
def test_ray_uniform_matches_jax(salt):
    """10,000 ray ids, bit for bit, with and without a minimum value."""
    jk = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    k = prng.fold_in(prng.prng_key(7), 3)
    rid = torch.from_numpy(RAY_IDS.astype(np.int64))
    for minval in (0.0, 1e-10):
        want = np.asarray(jmc.ray_uniform(jk, jnp.asarray(RAY_IDS),
                                          jnp.float32, minval=minval,
                                          salt=salt))
        got = tmc.ray_uniform(k, rid, torch.float32, minval=minval,
                              salt=salt).numpy()
        assert got.shape == want.shape == (10_000, 1)
        np.testing.assert_array_equal(got, want)


def test_ray_uniform_salt_wraps():
    """The key's second word plus the salt wraps modulo 2^32."""
    jk = jnp.asarray([5, 2 ** 32 - 2], jnp.uint32)
    rid = np.arange(256, dtype=np.uint32)
    want = np.asarray(jmc.ray_uniform(jk, jnp.asarray(rid), jnp.float32,
                                      salt=9))
    got = tmc.ray_uniform((5, 2 ** 32 - 2), torch.arange(256), salt=9)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ray_normal3_matches_jax():
    jk = jax.random.PRNGKey(11)
    want = np.asarray(jmc.ray_normal3(jk, jnp.asarray(RAY_IDS),
                                      jnp.float32))
    got = tmc.ray_normal3(prng.prng_key(11),
                          torch.from_numpy(RAY_IDS.astype(np.int64)),
                          torch.float32).numpy()
    assert got.shape == (10_000, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


SHAPES = [(7,), (5, 3), (2, 4, 4, 2)]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_random_bits_and_uniform_match_jax(seed):
    """random_bits, uniform and uniform with a minval/maxval pair (XLA's
    fused multiply-add) bit for bit, for several keys and shapes."""
    jk, k = jax.random.fold_in(jax.random.PRNGKey(seed), 1), prng.fold_in(
        prng.prng_key(seed), 1)
    for shape in SHAPES:
        want = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
        got = prng.random_bits(k, shape)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        for lo, hi in ((0.0, 1.0), (-2.5, 3.7)):
            want = np.asarray(jax.random.uniform(jk, shape, minval=lo,
                                                 maxval=hi))
            got = prng.uniform(k, shape, lo, hi)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_normal_matches_jax(seed):
    """random.normal within 1e-6: XLA's erf_inv polynomial, its log1p an
    ulp off PyTorch's (torch.erfinv itself reads ~1e-5 off in the
    tails)."""
    jk, k = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for shape in SHAPES + [(20_000, 3)]:
        want = np.asarray(jax.random.normal(jk, shape))
        got = prng.normal(k, shape)
        assert got.shape == shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 10, 4097])
def test_permutation_matches_jax(n):
    """random.permutation(key, n) exact: 0, 1 and 2 rounds of stable
    sorts by fresh bits."""
    for seed in (0, 5):
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed),
                                                 n))
        got = prng.permutation(prng.prng_key(seed), n)
        np.testing.assert_array_equal(got.numpy(), want)
        assert sorted(got.tolist()) == list(range(n))

"""The port's threefry draws (K8) against ``jax.random``, bit for bit.

``transmogrifai_tpu_torch/ops/threefry.py`` replays ``jax.random``'s
Threefry-2x32 under ``jax_threefry_partitionable`` (keys, ``split``, the
32-bit draws, ``uniform``), and ``ops/trees.py`` builds the JAX package's
draws on it: ``rng_keys``, the Poisson bootstrap (Knuth's loop, each log
taken in float64 and rounded to float32), the exactly-k feature masks and
the row-subsample masks.  Each is held to the JAX package's function on
the same seed: every bit equal, at the sweep's [50, 891] and [50, 10]
shapes, at other rates and fractions, and at a shape past 2^16 elements.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.ops import trees as JT

from transmogrifai_tpu_torch.ops import threefry as R
from transmogrifai_tpu_torch.ops import trees as PT

torch.set_num_threads(1)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32) if a.dtype == np.float32 else a


def test_partitionable_threefry_is_the_reference_layout():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 42, 7919, 2 ** 32 - 1])
@pytest.mark.parametrize("num", [2, 3, 5])
def test_key_and_split_match_jax(seed, num):
    jk = jax.random.PRNGKey(jnp.uint32(seed))
    assert tuple(int(v) for v in np.asarray(jk)) == R.key(seed)
    want = [tuple(int(v) for v in row) for row in np.asarray(jax.random.split(jk, num))]
    assert R.split(R.key(seed), num) == want


@pytest.mark.parametrize("shape", [(7,), (50, 891), (3, 5, 11), (2, 40000)])
def test_uniform_and_bits_match_jax(shape):
    jk = jax.random.split(jax.random.PRNGKey(jnp.uint32(42)))[1]
    pk = R.split(R.key(42))[1]
    want = np.asarray(jax.random.uniform(jk, shape))
    got = R.uniform(pk, shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    want_bits = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    np.testing.assert_array_equal(R.random_bits(pk, shape).numpy().astype(np.uint32), want_bits)


def test_rng_keys_match_jax():
    for seed in (0, 42, 12345):
        jb, jf = JT.rng_keys(seed)
        pb, pf = PT.rng_keys(seed)
        assert pb == tuple(int(v) for v in np.asarray(jb))
        assert pf == tuple(int(v) for v in np.asarray(jf))


@pytest.mark.parametrize("n,trees,rate,seed", [
    (891, 50, 1.0, 42),     # the stock sweep's draw
    (891, 50, 0.5, 42),     # a subsampling rate below 1
    (3000, 9, 1.0, 3),
    (600, 20, 0.3, 11),
    (257, 4, 2.5, 42),      # rate above 1: more Knuth steps
])
def test_bootstrap_weights_match_jax(n, trees, rate, seed):
    jb, _ = JT.rng_keys(seed)
    pb, _ = PT.rng_keys(seed)
    want = np.asarray(JT.bootstrap_weights(jb, n, trees, True, rate))
    got = PT.bootstrap_weights(pb, n, trees, True, rate)
    assert got.dtype == torch.float32 and tuple(got.shape) == (trees, n)
    np.testing.assert_array_equal(got.numpy(), want)
    off = PT.bootstrap_weights(pb, n, trees, False, rate)
    np.testing.assert_array_equal(off.numpy(), np.asarray(JT.bootstrap_weights(jb, n, trees,
                                                                               False, rate)))


@pytest.mark.parametrize("d,trees,frac", [
    (10, 50, np.sqrt(10) / 10),   # the stock forests: k = 3 of 10
    (10, 50, 0.5), (23, 17, 1.0 / 3.0), (5, 8, 0.05), (12, 6, 1.0)])
def test_feature_masks_match_jax(d, trees, frac):
    _, jf = JT.rng_keys(42)
    _, pf = PT.rng_keys(42)
    want = np.asarray(JT.feature_masks(jf, d, trees, frac))
    got = PT.feature_masks(pf, d, trees, frac).numpy()
    np.testing.assert_array_equal(got, want)
    k = max(1, int(round(frac * d)))
    assert (got.sum(1) >= k).all()


@pytest.mark.parametrize("n,rounds,frac", [(891, 200, 0.8), (1000, 7, 0.5), (64, 3, 1.0)])
def test_subsample_weights_match_jax(n, rounds, frac):
    js, _ = JT.rng_keys(42)
    ps, _ = PT.rng_keys(42)
    np.testing.assert_array_equal(PT.subsample_weights(ps, n, rounds, frac).numpy(),
                                  np.asarray(JT.subsample_weights(js, n, rounds, frac)))

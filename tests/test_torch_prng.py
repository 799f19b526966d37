"""The port's threefry draws (``mmlspark_tpu_torch/utils/prng.py``) against
``jax.random`` (threefry2x32, ``jax_threefry_partitionable`` on): keys,
``fold_in``, ``split`` and float32 ``uniform`` bitwise; ``normal``
within a few ulps (torch's ``erfinv`` is not XLA's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.utils import prng

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

SEEDS = [0, 1, 2 ** 31 - 1]
DATA = [0, 3, 999_999, 10 ** 6]
SHAPES = [(1, 28), (16, 136), (64, 3)]


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


def test_partitionable_threefry_is_the_reference_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + [-1, 2 ** 32 + 5])
def test_keys(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", DATA)
def test_fold_in_and_uniform(seed, data):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    pk = prng.fold_in(prng.PRNGKey(seed), data)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    for shape in SHAPES:
        np.testing.assert_array_equal(
            _bits(prng.uniform(pk, shape).numpy()),
            _bits(jax.random.uniform(jk, shape)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_batched_keys(seed):
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    js, ps = jax.random.split(jk, 7), prng.split(pk, 7)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    # a batch of keys draws a batch of arrays, key by key; fold_in over a
    # batch folds each key
    batch = prng.uniform(prng.fold_in(ps, 4), (5, 3)).numpy()
    for i in range(7):
        np.testing.assert_array_equal(
            _bits(batch[i]),
            _bits(jax.random.uniform(jax.random.fold_in(js[i], 4), (5, 3))))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_range_and_normal(seed):
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    np.testing.assert_array_equal(
        _bits(prng.uniform(pk, (64, 3), lo, 1.0).numpy()),
        _bits(jax.random.uniform(jk, (64, 3), jnp.float32, lo, 1.0)))
    for shape in SHAPES:
        want = np.asarray(jax.random.normal(jk, shape, jnp.float32))
        got = prng.normal(pk, shape).numpy()
        # the uniforms are bitwise equal; erfinv differs. Within |z| <= 2,
        # 4 ulps at the draw's scale (near 0 the error follows u's absolute
        # spacing, 2^-23, not the tiny normal's own ulp); in the tails an
        # ulp of u moves z by exp(z^2 / 2) of it, and the two erfinv
        # implementations part by up to 5e-6 relative there
        ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
        body = np.abs(want) <= 2.0
        assert np.all(np.abs(got - want)[body] <= 4 * ulp[body])
        np.testing.assert_allclose(got[~body], want[~body], rtol=1e-5)


def test_draws_follow_the_keys_device():
    k = prng.fold_in(prng.PRNGKey(5), 9)
    assert prng.uniform(k, (3, 4)).device == k.device
    assert prng.uniform(k, (3, 4)).dtype == torch.float32
    u = prng.uniform(k, (4096,))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0

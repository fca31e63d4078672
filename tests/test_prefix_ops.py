"""Int32 prefix sum (ops/prefix.py) vs exact numpy cumsum."""
import numpy as np
import pytest

import jax.numpy as jnp

from gramtools_tpu.ops.prefix import prefix_sum, prefix_sum_np


@pytest.mark.parametrize("n", [1, 7, 64, 511, 512, 513, 2048, 20480])
def test_cumsum_matches_numpy(n):
    rng = np.random.RandomState(n)
    x = rng.randint(0, 5, size=n).astype(np.int32)
    got = np.asarray(prefix_sum(jnp.asarray(x)))
    np.testing.assert_array_equal(got, prefix_sum_np(x))


def test_cumsum_exclusive_and_bool():
    rng = np.random.RandomState(0)
    x = rng.rand(1000) < 0.3
    got = np.asarray(prefix_sum(jnp.asarray(x), exclusive=True))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, prefix_sum_np(x, exclusive=True))


def test_cumsum_channels():
    """Leading batch dims prefix-sum independently (the scan step stacks
    cnt and nz into one call)."""
    rng = np.random.RandomState(1)
    x = rng.randint(0, 100, size=(2, 3000)).astype(np.int32)
    got = np.asarray(prefix_sum(jnp.asarray(x)))
    np.testing.assert_array_equal(got, prefix_sum_np(x))


def test_cumsum_exact_past_tf32_and_f32():
    """Exact where a float formulation is not: every 512-wide block total
    (4095 * 512 ~ 2**21) is past the 11 significant bits of TF32, and
    the prefix runs past 2**24, where float32 stops holding integers
    (odd values past 2**24 have no float32 form)."""
    n = 8192 + 1
    x = np.full(n, 4095, np.int32)
    x[-1] = 1
    want = prefix_sum_np(x)
    assert want[-2] > 2 ** 24 and want[-1] % 2 == 1
    got = np.asarray(prefix_sum(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)

"""Device-path checks that need the GPU (marker `gpu`): skipped on the
CPU, run on the card by chip_smoke.py's test phase.

They pin what the CPU backend cannot show: the prefix sums and the
packed rank are exact as the GPU compiles them, and the log engine
agrees with the scalar host oracle there."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gramtools_tpu.ops.prefix import prefix_sum, prefix_sum_np

pytestmark = pytest.mark.gpu


def test_prefix_sum_exact_on_gpu(gpu):
    """Block totals past TF32's 11 bits and a prefix past 2**24, in the
    (2, N) stacked layout the scan step uses."""
    n = 40_961
    x = np.full((2, n), 4095, np.int32)
    x[1, ::2] = 1
    got = np.asarray(jax.jit(prefix_sum)(jax.device_put(x, gpu)))
    np.testing.assert_array_equal(got, prefix_sum_np(x))
    assert got[0, -1] > 2 ** 24


def test_packed_rank_exact_on_gpu(gpu):
    from gramtools_tpu.index.fm import FMIndex
    from gramtools_tpu.ops.rank import build_packed_occ, make_packed_occ_rows

    rng = np.random.RandomState(3)
    text = rng.randint(1, 5, size=50_000).astype(np.uint32)
    fm = FMIndex.build(text)
    occ_rows = make_packed_occ_rows(
        jax.device_put(build_packed_occ(fm), gpu), fm.size)
    rows = rng.randint(0, fm.size + 1, size=(64, 256)).astype(np.int32)
    got = np.asarray(jax.jit(occ_rows)(jax.device_put(rows, gpu)))
    want = np.ascontiguousarray(fm.occ.T)[rows]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rank", ["dense", "packed"])
def test_log_engine_matches_host_on_gpu(gpu, rank, monkeypatch):
    from test_packed_rank import check_log_engine_matches_host

    assert jnp.zeros(1).devices() == {gpu}
    check_log_engine_matches_host("random", rank, monkeypatch)

"""Packed-BWT rank (ops/rank.py) vs the dense occ prefix table: the
numpy oracle and the jnp twin must be bit-equal to fm.occ gathers on
every prefix length, for every query shape the engine uses.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gramtools_tpu.index.fm import FMIndex
from gramtools_tpu.ops.rank import (
    BLOCK, build_packed_occ, make_packed_occ_rows, packed_occ_rows_np)
from gramtools_tpu.prg.linearise import prg_string_to_ints


def _random_prg_ints(rng, n_sites=6, seq_len=40):
    parts = []
    for _ in range(n_sites):
        parts.append("".join(rng.choice(list("ACGT"), size=seq_len)))
        parts.append("[" + ",".join(
            "".join(rng.choice(list("ACGT"), size=rng.randint(1, 5)))
            for _ in range(rng.randint(2, 4))) + "]")
    parts.append("".join(rng.choice(list("ACGT"), size=seq_len)))
    return prg_string_to_ints("".join(parts))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_occ_np_matches_dense(seed):
    rng = np.random.RandomState(seed)
    fm = FMIndex.build(_random_prg_ints(rng))
    blocks = build_packed_occ(fm)
    rows = np.arange(fm.size + 1)          # every prefix length incl. n
    got = packed_occ_rows_np(blocks, rows, fm.size)
    want = np.ascontiguousarray(fm.occ.T)[np.clip(rows, 0, fm.size)]
    np.testing.assert_array_equal(got, want)
    # marker checkpoint channel agrees with the marker prefix counts
    blk_starts = np.arange(blocks.shape[0]) * BLOCK
    valid = blk_starts <= fm.size
    np.testing.assert_array_equal(
        blocks[valid, 4].astype(np.int64),
        fm.marker_prefix[np.minimum(blk_starts[valid], fm.size)])


@pytest.mark.parametrize("shape", ["flat", "grid", "end"])
def test_packed_occ_device_twins(shape):
    """The engine queries with (N,) and (G, B) row arrays; "end" puts
    the row i = n (prefix of the whole BWT) and rows past it, which
    clip to n, into the query."""
    rng = np.random.RandomState(7)
    fm = FMIndex.build(_random_prg_ints(rng, n_sites=3, seq_len=60))
    blocks = build_packed_occ(fm)
    rows = rng.randint(0, fm.size + 1, size=256).astype(np.int32)
    if shape == "end":
        rows[:3] = [fm.size, fm.size + 5, fm.size - 1]
    if shape == "grid":
        rows = rows.reshape(16, 16)
    occ_rows = make_packed_occ_rows(jnp.asarray(blocks), fm.size)
    got = np.asarray(jax.jit(occ_rows)(jnp.asarray(rows)))
    assert got.shape == rows.shape + (4,)
    want = np.ascontiguousarray(fm.occ.T)[np.clip(rows, 0, fm.size)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prg_choice", ["hard1", "hard2", "random"])
def test_log_engine_packed_rank_matches_host(prg_choice, monkeypatch):
    """The production log engine with GRAMTOOLS_TPU_RANK=packed must
    produce the same SearchStates as the host oracle (the same assertion
    test_search_jax.py makes for the dense rank)."""
    check_log_engine_matches_host(prg_choice, "packed", monkeypatch)


def check_log_engine_matches_host(prg_choice, rank, monkeypatch):
    """LogBatchedEngine.search_buffer with the given rank implementation
    vs the scalar host search, read by read (also run on the GPU by
    test_gpu_device.py)."""
    from gramtools_tpu.index.build import build_prg_index
    from gramtools_tpu.index.kmer_index import build_kmer_index
    from gramtools_tpu.mapping.search import search_read_backwards
    from gramtools_tpu.mapping.search_jax_log import (
        LogBatchedEngine, LogConfig)
    from gramtools_tpu.prg.linearise import PrgString

    from test_search_jax import HARD_NESTED_PRGS, random_prg, states_key

    rng = np.random.RandomState(11)
    if prg_choice == "random":
        prg_str = random_prg(rng, nested=True)
    else:
        prg_str = HARD_NESTED_PRGS[int(prg_choice[-1])]
    prg = PrgString(prg_string_to_ints(prg_str))
    idx = build_prg_index(prg)
    k = 3
    kmer_index = build_kmer_index(idx, k)
    monkeypatch.setenv("GRAMTOOLS_TPU_RANK", rank)
    engine = LogBatchedEngine(idx, k, LogConfig(pool=256, hits=64))
    assert engine.rank == rank
    assert (engine.blocks is not None) == (rank == "packed")

    reads = [rng.randint(1, 5, size=rng.randint(k, 12)).astype(np.uint8)
             for _ in range(30)]

    class S:
        all_reads_count = 0
        skipped_reads_count = 0
        missing_kmer_reads_count = 0
        no_extension_reads_count = 0
        exact_mapped_reads_count = 0

    results = engine.search_buffer(reads, kmer_index, k, S())
    from gramtools_tpu.common.seq import revcomp
    from gramtools_tpu.mapping.quasimap import all_read_kmers_in_index
    for i, read in enumerate(reads):
        expected = []
        for oriented in (read, revcomp(read)):
            if not all_read_kmers_in_index(k, oriented, kmer_index):
                continue
            seed_states = kmer_index.get(
                oriented[oriented.size - k:].astype(np.uint8).tobytes(), [])
            states = (search_read_backwards(oriented, seed_states, k, idx)
                      if seed_states else [])
            expected.append((states, int(oriented.size)))
        assert len(results[i]) == len(expected)
        for (got_states, got_len), (exp_states, exp_len) in zip(
                results[i], expected):
            assert got_len == exp_len
            assert states_key(got_states) == states_key(exp_states)

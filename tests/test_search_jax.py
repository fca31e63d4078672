"""Batched JAX search engine vs host reference engine: equivalence tests.

The host engine (mapping/search.py) is validated against the reference
fixtures (test_quasimap_integration.py); here the device engine must
produce identical coverage on those fixtures and identical SearchStates
on randomised PRGs/reads.
"""
from pathlib import Path

import numpy as np
import pytest

from gramtools_tpu.index.build import build_prg_index
from gramtools_tpu.index.kmer_index import build_kmer_index
from gramtools_tpu.mapping.quasimap import quasimap_reads
from gramtools_tpu.mapping.search import search_read_backwards
from gramtools_tpu.mapping.search_jax_log import LogBatchedEngine, LogConfig
from gramtools_tpu.prg.linearise import PrgString, prg_string_to_ints

DATA_DIR = Path("/root/reference/gramtools/tests/integration_test_data")


def random_prg(rng, num_sites=4, nested=False):
    parts = []
    for _ in range(num_sites):
        parts.append("".join(rng.choice(list("ACGT"),
                                        size=rng.randint(1, 6))))
        n_alleles = rng.randint(2, 4)
        alleles = []
        for _ in range(n_alleles):
            length = rng.randint(0 if nested else 1, 5)
            alleles.append("".join(rng.choice(list("ACGT"), size=length)))
        if nested and rng.rand() < 0.5 and len(alleles[0]) >= 2:
            mid = len(alleles[0]) // 2
            alleles[0] = (alleles[0][:mid] + "[A,C]" + alleles[0][mid:])
        parts.append("[" + ",".join(alleles) + "]")
    parts.append("".join(rng.choice(list("ACGT"), size=rng.randint(3, 8))))
    return "".join(parts)


def states_key(states):
    return sorted((s.lo, s.hi, s.traversed, s.traversing) for s in states)


HARD_NESTED_PRGS = [
    "A[[A[CCC,C],T],G]TA",                 # double nesting
    "A[T[TT,T]T,A[AT,]A]G[C,G]",           # nesting + deletion + SNP
    "T[A[C,G][C,G],]T",                    # adjacent nested sites + deletion
]


@pytest.mark.parametrize("seed,nested", [(0, False), (1, False), (2, True),
                                         (3, True), (4, True),
                                         (100, "hard0"), (101, "hard1"),
                                         (102, "hard2")])
def test_batched_matches_host_random(seed, nested):
    rng = np.random.RandomState(seed)
    if isinstance(nested, str):
        prg_str = HARD_NESTED_PRGS[int(nested[-1])]
    else:
        prg_str = random_prg(rng, nested=nested)
    try:
        prg = PrgString(prg_string_to_ints(prg_str))
        idx = build_prg_index(prg)
    except ValueError:
        pytest.skip("randomly generated inconsistent PRG")
    k = 3
    kmer_index = build_kmer_index(idx, k)
    # small pool/hit budget exercises the overflow->host path too
    engine = LogBatchedEngine(idx, k, LogConfig(pool=256, hits=64))

    # random reads: some sampled from the prg space, some random
    reads = []
    for _ in range(30):
        length = rng.randint(k, 12)
        reads.append(rng.randint(1, 5, size=length).astype(np.uint8))

    class S:
        all_reads_count = 0
        skipped_reads_count = 0
        missing_kmer_reads_count = 0
        no_extension_reads_count = 0
        exact_mapped_reads_count = 0

    results = engine.search_buffer(reads, kmer_index, k, S())
    # compare with host per read+orientation
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
        for (got_states, got_len), (exp_states, exp_len) in zip(results[i], expected):
            assert got_len == exp_len
            assert states_key(got_states) == states_key(exp_states)


@pytest.mark.skipif(not DATA_DIR.exists(), reason="fixtures unavailable")
@pytest.mark.parametrize("fixture,expected_grouped", [
    ("IT1", [{(0,): 1, (1,): 1}, {(0,): 1, (1,): 1}]),
    ("IT2", [{(0, 1): 1}, {(0, 1): 1}]),
    ("IT3", [{(0,): 1, (0, 1): 1}, {(0,): 1}]),
])
def test_device_engine_integration_parity(fixture, expected_grouped):
    from gramtools_tpu.index.kmer_index_vec import build_kmer_index_vectorised
    prg = PrgString.from_file(DATA_DIR / fixture / "prg.bin")
    idx = build_prg_index(prg)
    # array-backed index exercises the vectorised seeding path
    kmer_index = build_kmer_index_vectorised(idx, 5)
    engine = LogBatchedEngine(idx, 5)
    stats, coverage = quasimap_reads(
        [str(DATA_DIR / fixture / "reads.fastq")], kmer_index, idx, 5,
        seed=42, engine=engine)
    assert coverage.grouped_counts == expected_grouped


def test_device_retry_pass():
    """Reads that overflow the phased plan's reduced budgets get one
    full-budget device re-scan (merged through the genealogy log)
    instead of falling straight back to the host engine."""
    rng = np.random.RandomState(7)
    tail = "".join(rng.choice(list("ACGT"), size=60))
    prg_str = "GT" + "[A,C]" * 10 + tail
    idx = build_prg_index(PrgString(prg_string_to_ints(prg_str)))
    k = 3
    kmer_index = build_kmer_index(idx, k)
    engine = LogBatchedEngine(idx, k, LogConfig(pool=512, hits=64))
    engine.retry_min = 1

    read = np.frombuffer(("GT" + "A" * 10 + tail).encode(), dtype=np.uint8)
    from gramtools_tpu.common.seq import encode_dna
    read = encode_dna("GT" + "A" * 10 + tail)
    reads = [read.copy() for _ in range(20)]

    class S:
        all_reads_count = 0
        skipped_reads_count = 0
        missing_kmer_reads_count = 0
        no_extension_reads_count = 0
        exact_mapped_reads_count = 0

    results = engine.search_buffer(reads, kmer_index, k, S())
    assert engine.device_retried > 0, "retry path not exercised"
    # the retry recovers most overflowed reads; genuinely over-budget
    # ones still fall back to the exact host engine
    assert engine.host_fallbacks < engine.device_retried

    from gramtools_tpu.common.seq import revcomp
    from gramtools_tpu.mapping.quasimap import all_read_kmers_in_index
    for i, r in enumerate(reads):
        expected = []
        for oriented in (r, revcomp(r)):
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


def test_device_retry_through_recording(tmp_path):
    """The retry pass also feeds the vectorised selection/recording path:
    coverage through quasimap_reads must equal the host engine's."""
    from gramtools_tpu.common.seq import encode_dna
    from gramtools_tpu.index.kmer_index_vec import build_kmer_index_vectorised

    rng = np.random.RandomState(7)
    tail = "".join(rng.choice(list("ACGT"), size=60))
    prg_str = "GT" + "[A,C]" * 10 + tail
    idx = build_prg_index(PrgString(prg_string_to_ints(prg_str)))
    k = 3
    kmer_index = build_kmer_index_vectorised(idx, k)

    read = "GT" + "A" * 10 + tail
    fq = tmp_path / "reads.fastq"
    fq.write_text("".join(f"@r{i}\n{read}\nZ\n{'I' * len(read)}\n"
                          for i in range(20)).replace("Z", "+"))

    engine = LogBatchedEngine(idx, k, LogConfig(pool=512, hits=64))
    engine.retry_min = 1
    stats_d, cov_d = quasimap_reads([str(fq)], kmer_index, idx, k,
                                    seed=42, engine=engine)
    assert engine.device_retried > 0
    pb_d = idx.graph.coverage.copy()

    # per-base coverage accumulates on the graph: fresh index for host run
    idx_h = build_prg_index(PrgString(prg_string_to_ints(prg_str)))
    kmer_index_h = build_kmer_index_vectorised(idx_h, k)
    stats_h, cov_h = quasimap_reads([str(fq)], kmer_index_h, idx_h, k, seed=42)
    assert cov_d.grouped_counts == cov_h.grouped_counts
    assert cov_d.allele_sum == cov_h.allele_sum
    assert np.array_equal(pb_d, idx_h.graph.coverage)
    assert stats_d.exact_mapped_reads_count == stats_h.exact_mapped_reads_count


def test_double_overflow_falls_back_exactly():
    """A hit budget so starved that even the full-budget retry pass
    overflows: rows must keep their flag through BOTH passes and land on
    the exact host path (VERDICT r2 item 10), with results bit-equal to
    the oracle."""
    rng = np.random.RandomState(11)
    tail = "".join(rng.choice(list("ACGT"), size=60))
    prg_str = "GT" + "[A,C]" * 14 + tail
    idx = build_prg_index(PrgString(prg_string_to_ints(prg_str)))
    k = 3
    kmer_index = build_kmer_index(idx, k)
    engine = LogBatchedEngine(idx, k, LogConfig(pool=512, hits=2))
    engine.retry_min = 1
    engine.max_hits_boost = 1   # freeze the adaptive budget

    from gramtools_tpu.common.seq import encode_dna
    read = encode_dna("GT" + "A" * 14 + tail)
    reads = [read.copy() for _ in range(8)]

    class S:
        all_reads_count = 0
        skipped_reads_count = 0
        missing_kmer_reads_count = 0
        no_extension_reads_count = 0
        exact_mapped_reads_count = 0

    results = engine.search_buffer(reads, kmer_index, k, S())
    assert engine.device_retried > 0, "retry pass not exercised"
    assert engine.host_fallbacks > 0, "second overflow did not fall back"

    from gramtools_tpu.common.seq import revcomp
    from gramtools_tpu.mapping.quasimap import all_read_kmers_in_index
    for i, r in enumerate(reads):
        expected = []
        for oriented in (r, revcomp(r)):
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


def test_hits_boost_step_up_changes_budget_once():
    """>2% of rows overflowing steps the adaptive hit budget up for
    later buffers: exactly one new dispatched shape, then steady."""
    rng = np.random.RandomState(11)
    tail = "".join(rng.choice(list("ACGT"), size=60))
    prg_str = "GT" + "[A,C]" * 10 + tail
    idx = build_prg_index(PrgString(prg_string_to_ints(prg_str)))
    k = 3
    kmer_index = build_kmer_index(idx, k)
    engine = LogBatchedEngine(idx, k, LogConfig(pool=512, hits=16))
    engine.retry_min = 10_000   # isolate the boost from the retry pass

    from gramtools_tpu.common.seq import encode_dna
    read = encode_dna("GT" + "A" * 10 + tail)

    class S:
        all_reads_count = 0
        skipped_reads_count = 0
        missing_kmer_reads_count = 0
        no_extension_reads_count = 0
        exact_mapped_reads_count = 0

    assert engine.hits_boost == 1
    engine.search_buffer([read.copy() for _ in range(16)], kmer_index, k, S())
    assert engine.hits_boost == 2, "boost did not step up"
    shapes_after_first = len(engine.dispatch_shapes)
    # freeze the budget at the stepped-up level: identical buffers must
    # then reuse ONE dispatched shape (zero steady-state recompiles)
    engine.max_hits_boost = engine.hits_boost
    engine.search_buffer([read.copy() for _ in range(16)], kmer_index, k, S())
    shapes_after_second = len(engine.dispatch_shapes)
    assert shapes_after_second == shapes_after_first + 1
    engine.search_buffer([read.copy() for _ in range(16)], kmer_index, k, S())
    assert len(engine.dispatch_shapes) == shapes_after_second, \
        "steady state recompiled"


def test_pool_shrink_drops_reseed_on_host():
    """A pool cap far below the seed fan-out: dropped states flag their
    rows and the host engine re-maps them exactly."""
    # homopolymer-rich graph -> the seeding kmer has many occurrences
    prg_str = "AAAAAAAAAAAAAAAAAAAA[C,G]AAAAAAAAAAAAAAAAAAAA"
    idx = build_prg_index(PrgString(prg_string_to_ints(prg_str)))
    k = 3
    kmer_index = build_kmer_index(idx, k)
    engine = LogBatchedEngine(idx, k, LogConfig(pool=8, hits=8))
    engine.retry_min = 10_000

    from gramtools_tpu.common.seq import encode_dna
    # more oriented rows than the pool holds even at 1 state/row
    reads = [encode_dna("AAAAAAAA") for _ in range(12)]

    class S:
        all_reads_count = 0
        skipped_reads_count = 0
        missing_kmer_reads_count = 0
        no_extension_reads_count = 0
        exact_mapped_reads_count = 0

    results = engine.search_buffer(reads, kmer_index, k, S())
    assert engine.host_fallbacks > 0
    for i, r in enumerate(reads):
        from gramtools_tpu.common.seq import revcomp
        from gramtools_tpu.mapping.quasimap import all_read_kmers_in_index
        expected = []
        for oriented in (r, revcomp(r)):
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


def test_retry_reuses_main_program_shape(tmp_path):
    """The retry pass re-dispatches the SAME (phases, R) program as the
    main pass: a run that retries must show exactly the same set of
    dispatched shapes as one that does not (one compiled device program
    per run -- each distinct shape is one more XLA compile of the fused
    program, and a second retry shape would double cold warmup)."""
    from gramtools_tpu.index.kmer_index_vec import build_kmer_index_vectorised
    from gramtools_tpu.mapping.quasimap import quasimap_reads

    rng = np.random.RandomState(7)
    tail = "".join(rng.choice(list("ACGT"), size=60))
    prg_str = "GT" + "[A,C]" * 10 + tail
    idx = build_prg_index(PrgString(prg_string_to_ints(prg_str)))
    k = 3
    kmer_index = build_kmer_index_vectorised(idx, k)
    read = "GT" + "A" * 10 + tail
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"@r{i}\n{read}\n+\n{'I' * len(read)}\n"
                          for i in range(20)))
    engine = LogBatchedEngine(idx, k, LogConfig(pool=4096, hits=16))
    engine.retry_min = 1
    engine.max_hits_boost = 1
    quasimap_reads([str(fq)], kmer_index, idx, k, seed=1, engine=engine)
    assert engine.device_retried > 0, "retry pass not exercised"
    assert len(engine.dispatch_shapes) == 1, engine.dispatch_shapes


def test_steady_rate_window_holds_every_counted_submit(tmp_path, monkeypatch):
    """run_summary's steady window must hold the host submit of every
    buffer whose reads it counts. quasimap_reads submits buffer N+1
    before it completes buffer N, so buffer 2 is submitted before the
    first completion opens the window: with a submit that sleeps, four
    buffers give 2 counted buffers (3 and 4) over at least 2 sleeps."""
    import time

    from gramtools_tpu.index.kmer_index_vec import build_kmer_index_vectorised
    from gramtools_tpu.mapping import search_jax_log

    rng = np.random.RandomState(7)
    tail = "".join(rng.choice(list("ACGT"), size=60))
    idx = build_prg_index(PrgString(prg_string_to_ints(
        "GT" + "[A,C]" * 4 + tail)))
    k = 3
    kmer_index = build_kmer_index_vectorised(idx, k)
    read = "GT" + "A" * 4 + tail
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"@r{i}\n{read}\n+\n{'I' * len(read)}\n"
                          for i in range(40)))
    sleep_s = 0.3
    filter_rows = search_jax_log._filter_buffer_rows

    def slow_filter(*args, **kwargs):
        time.sleep(sleep_s)
        return filter_rows(*args, **kwargs)

    monkeypatch.setattr(search_jax_log, "_filter_buffer_rows", slow_filter)
    engine = LogBatchedEngine(idx, k, LogConfig(pool=512, hits=64))
    quasimap_reads([str(fq)], kmer_index, idx, k, seed=1, engine=engine,
                   buffer_size=10)
    summary = engine.run_summary()
    assert summary["device_mapped"] > 0
    assert summary["first_buffer_seconds"] >= sleep_s
    assert summary["steady_state_new_shapes"] == 0
    assert 0 < summary["steady_reads_per_second"] <= 20 / (2 * sleep_s)

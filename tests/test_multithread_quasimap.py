"""max_threads parity: forked-worker quasimap produces identical coverage
to the single-process path (shard-invariant selection RNG)."""
import numpy as np
import pytest

from gramtools_tpu.index.build import build_prg_index
from gramtools_tpu.index.kmer_index import build_kmer_index
from gramtools_tpu.mapping.quasimap import quasimap_reads
from gramtools_tpu.prg.linearise import PrgString, prg_string_to_ints

PRG = "AAA[CC,TA]ACGTAC[TTTT,GGG]ACGT[A,C]TT"


def write_reads(tmp_path, reads):
    tmp_path.mkdir(parents=True, exist_ok=True)
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(fq)


def run(tmp_path, max_threads):
    idx = build_prg_index(PrgString(prg_string_to_ints(PRG)))
    kmer_index = build_kmer_index(idx, 4)
    reads = ["AAACCACGT", "AAATAACGT", "ACTTTTACG", "ACGGGACG",
             "GTACTTTTAC", "CGTATT", "CGTCTT", "ACGTAC"] * 3
    fq = write_reads(tmp_path, reads)
    stats, coverage = quasimap_reads([fq], kmer_index, idx, 4, seed=11,
                                     max_threads=max_threads)
    return (stats.as_dict(), coverage.allele_sum, coverage.grouped_counts,
            idx.graph.coverage.copy())


def test_multithread_matches_single(tmp_path):
    single = run(tmp_path / "a", 1)
    multi = run(tmp_path / "b", 3)
    assert single[0] == multi[0]           # stats
    assert single[1] == multi[1]           # allele sums
    assert single[2] == multi[2]           # grouped counts
    assert np.array_equal(single[3], multi[3])  # per-base coverage


def test_no_fork_after_jax_init(tmp_path):
    """fork() after JAX backend init is a latent deadlock (JAX runs a
    multithreaded runtime): once a backend is live the pool must switch
    to spawn workers."""
    import jax

    from gramtools_tpu.mapping.quasimap import _pool_start_method

    jax.jit(lambda x: x + 1)(np.float32(1.0)).block_until_ready()
    assert _pool_start_method() == "spawn"
    # parity must hold with spawned workers too (index ships by pickle)
    single = run(tmp_path / "a", 1)
    multi = run(tmp_path / "b", 2)
    assert single[0] == multi[0]
    assert np.array_equal(single[3], multi[3])


def test_spawned_workers_open_no_jax_backend():
    """Spawned workers unpickle an index the device engine has already
    used, and must not open a JAX backend doing so: on a GPU machine a
    second process on the card fails for want of device memory."""
    from gramtools_tpu.mapping import quasimap
    from gramtools_tpu.mapping.search_jax_log import LogBatchedEngine

    idx = build_prg_index(PrgString(prg_string_to_ints(PRG)))
    kmer_index = build_kmer_index(idx, 4)
    LogBatchedEngine(idx, 4)
    assert quasimap._jax_backend_live()
    pool = quasimap._make_pool(2, idx, kmer_index, 4)
    try:
        assert pool.apply(quasimap._jax_backend_live) is False
    finally:
        pool.terminate()

"""Benchmark: end-to-end quasimap throughput on one NVIDIA GPU.

Workload (BASELINE.md): an M. tuberculosis-scale genome graph (4.4Mb,
100k variant sites) with 150bp reads sampled from random haplotype
paths. Two graph profiles:

  BENCH_PROFILE=snp    (default) evenly spread biallelic SNPs -- the
                       reference's primary production shape;
  BENCH_PROFILE=mixed  70% SNPs, 10% deletions (incl. direct
                       deletions), 10% insertions, 5% multi-allelic,
                       5% nested sites -- stresses the jump-chain /
                       hit-budget machinery.

Primary metric: END-TO-END device-engine reads/s/chip through the full
production mapping path (quasimap_reads with the genealogy-log engine:
read IO, kmer filter, vectorised seeding, fused device scan + selection
+ coverage recording, retries, host fallbacks). The scan-only rate, an
analytic HBM roofline fraction, per-phase pool occupancy, and the
engine's stage timers are reported alongside.

vs_baseline: speedup over the compiled C++/OpenMP scalar-search
baseline (gramtools_tpu/native/quasimap.cpp) running the reference
backend's per-read worklist algorithm on all host cores -- the
reference `gram` binary itself cannot be built offline (BASELINE.md).

Prints ONE JSON line whose required keys are
{"metric", "value", "unit", "vs_baseline"}; extra keys carry the
breakdown, and the GPU's name and power limit (nvidia-smi).

It runs on the GPU and refuses any other backend, except a CPU smoke run
asked for explicitly with JAX_PLATFORMS=cpu (whose numbers are not
device numbers).
"""
import json
import os
import signal
import sys
import tempfile
import time

import numpy as np

GENOME_MB = float(os.environ.get("BENCH_GENOME_MB", "4.4"))
NUM_SITES = int(os.environ.get("BENCH_NUM_SITES", "100000"))
READ_LEN = int(os.environ.get("BENCH_READ_LEN", "150"))
KMER_SIZE = int(os.environ.get("BENCH_KMER_SIZE", "10"))
BATCH = int(os.environ.get("BENCH_BATCH", "4096"))       # scan-only batch
BATCHES = int(os.environ.get("BENCH_BATCHES", "8"))
E2E_READS = int(os.environ.get("BENCH_E2E_READS", "120000"))
# warmup = ONE production buffer: it dispatches the canonical sticky
# shapes, so the timed run recompiles nothing (steady_state_new_shapes
# proves it). Two-buffer warmups blew the driver's wall budget (r03).
WARM_READS = int(os.environ.get("BENCH_WARM_READS", "0"))
CPP_THREADS = int(os.environ.get("BENCH_CPP_THREADS", "0"))  # 0 = all cores
PROFILE = os.environ.get("BENCH_PROFILE", "snp")         # snp | mixed
RANK = os.environ.get("BENCH_RANK",
                      os.environ.get("GRAMTOOLS_TPU_RANK", "dense"))
SKIP_E2E = os.environ.get("BENCH_SKIP_E2E") == "1"
# hard wall budget for runs under a timeout. At BUDGET seconds -- or on
# SIGTERM -- whatever has been measured so far is printed as the one
# JSON line and the process exits 0. Every phase below updates RESULT
# incrementally.
BUDGET_S = int(os.environ.get("BENCH_BUDGET_S", "460"))

T0 = time.time()
RESULT = {
    "metric": "quasimap_e2e_reads_per_sec_per_chip",
    "value": None,
    "unit": f"reads/s (150bp, {GENOME_MB}Mb {PROFILE} graph, "
            f"full device mapping path)",
    "vs_baseline": None,
    "phase_elapsed_s": {},
    "compile_cache_writes": 0,
}
_EMITTED = False


def _phase_done(name):
    """Record per-phase elapsed + a progress line, so a run cut by its
    time limit still says how far it got."""
    RESULT["phase_elapsed_s"][name] = round(_elapsed(), 1)
    print(f"# phase {name} done at t={_elapsed():.1f}s", file=sys.stderr,
          flush=True)


def _hook_cache_telemetry():
    """Count persistent-compile-cache writes (a write = a cache miss
    that paid a full XLA compile)."""
    import logging

    class _H(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "persistent compilation cache" in msg and "Writing" in msg:
                RESULT["compile_cache_writes"] += 1

    lg = logging.getLogger("jax._src.compilation_cache")
    lg.setLevel(logging.DEBUG)
    lg.addHandler(_H())


def _emit():
    global _EMITTED
    if _EMITTED:
        return
    _EMITTED = True
    # primary metric preference: e2e rate, else scan-only rate
    if RESULT["value"] is None and RESULT.get("scan_reads_per_sec"):
        RESULT["value"] = RESULT["scan_reads_per_sec"]
    cpp = RESULT.get("cpp_omp_baseline_reads_per_sec")
    if RESULT["vs_baseline"] is None and cpp and RESULT["value"]:
        RESULT["vs_baseline"] = round(RESULT["value"] / cpp, 2)
    print(json.dumps(RESULT), flush=True)


def _deadline(signum, frame):
    RESULT["partial"] = True
    RESULT["elapsed_at_deadline_s"] = round(time.time() - T0, 1)
    print(f"# bench deadline hit ({signum}); emitting partial result",
          file=sys.stderr, flush=True)
    _emit()
    os._exit(0)


def _elapsed():
    return time.time() - T0


def _remaining():
    return BUDGET_S - _elapsed()

# Peak device-memory bytes/s by jax device_kind (NVIDIA data sheets:
# H100 SXM5 80GB HBM3 3.35 TB/s, H100 PCIe 80GB 2.0 TB/s, H100 NVL
# 94GB 3.9 TB/s). A kind not listed is an error, not a default.
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


# --------------------------------------------------------------------------
# synthetic graphs
# --------------------------------------------------------------------------

def build_synthetic_mtb_graph(rng, genome_len, num_sites):
    """Linear PRG: random genome with evenly spread biallelic SNPs."""
    seq = rng.randint(1, 5, size=genome_len).astype(np.uint32)
    positions = np.sort(rng.choice(np.arange(1, genome_len - 1),
                                   size=num_sites, replace=False))
    out = np.empty(genome_len + 4 * num_sites, dtype=np.uint32)
    cursor = 0
    prev = 0
    for i, pos in enumerate(positions):
        site = 5 + 2 * i
        chunk = seq[prev:pos]
        out[cursor : cursor + chunk.size] = chunk
        cursor += chunk.size
        ref_base = seq[pos]
        alt_base = ref_base % 4 + 1
        out[cursor : cursor + 5] = [site, ref_base, site + 1, alt_base,
                                    site + 1]
        cursor += 5
        prev = pos + 1
    chunk = seq[prev:]
    out[cursor : cursor + chunk.size] = chunk
    cursor += chunk.size
    return out[:cursor]


def build_mixed_graph(rng, genome_len, num_sites):
    """Linear PRG with SNPs, deletions, insertions, multi-allelic and
    nested sites (BENCH_PROFILE=mixed): exercises direct-deletion jump
    targets, adjacent-marker chains and larger per-step marker fan-out."""
    seq = rng.randint(1, 5, size=genome_len).astype(np.uint32)
    # keep >=12bp between variant anchors so ref spans never collide
    positions = 12 + np.sort(rng.choice(
        np.arange((genome_len - 24) // 12), size=num_sites,
        replace=False)) * 12
    kinds = rng.choice(5, size=num_sites,
                       p=[0.70, 0.10, 0.10, 0.05, 0.05])
    out = []
    marker = 5
    prev = 0
    for pos, kind in zip(positions, kinds):
        out.append(seq[prev:pos])
        m = marker
        if kind == 0:    # SNP
            ref = [int(seq[pos])]
            alts = [[int(seq[pos]) % 4 + 1]]
            marker += 2
        elif kind == 1:  # deletion (direct-deletion allele)
            dl = int(rng.randint(1, 6))
            ref = [int(b) for b in seq[pos : pos + dl]]
            alts = [[]]
            marker += 2
        elif kind == 2:  # insertion
            ref = [int(seq[pos])]
            ins = [int(b) for b in rng.randint(1, 5, size=rng.randint(1, 9))]
            alts = [[int(seq[pos])] + ins]
            marker += 2
        elif kind == 3:  # multi-allelic SNP
            b = int(seq[pos])
            ref = [b]
            alts = [[(b + j) % 4 + 1] for j in range(3)]
            marker += 2
        else:            # nested: alt carries an inner biallelic SNP
            b = int(seq[pos])
            mi = m + 2
            inner_ref = b % 4 + 1
            inner_alt = (b + 1) % 4 + 1
            ref = [b, b % 4 + 1]
            alts = [[b, mi, inner_ref, mi + 1, inner_alt, mi + 1,
                     (b + 2) % 4 + 1]]
            marker += 4
        site = [m] + ref
        for a in alts:
            site += [m + 1] + a
        site += [m + 1]
        out.append(np.asarray(site, dtype=np.uint32))
        prev = pos + max(len(ref) if kind == 1 else 1, 1)
    out.append(seq[prev:])
    return np.concatenate(out)


# --------------------------------------------------------------------------
# haplotype path sampling (profile-agnostic)
# --------------------------------------------------------------------------

def sample_haplotypes(prg_ints, end_positions, rng, n_paths):
    """Splices random-allele haplotype sequences out of a linear PRG,
    recursing into nested sites."""
    ints = np.asarray(prg_ints, dtype=np.int64)
    n = ints.size
    is_marker = ints > 4
    # next marker position at-or-after each index
    next_marker = np.full(n + 1, n, dtype=np.int64)
    mpos = np.flatnonzero(is_marker)
    if mpos.size:
        idx = np.searchsorted(mpos, np.arange(n), side="left")
        next_marker[:n] = np.where(idx < mpos.size, mpos[np.minimum(
            idx, mpos.size - 1)], n)
    entries = {int(ints[p]): int(p) for p in mpos if ints[p] % 2 == 1}
    # per-site allele spans (between the entry and end markers, split at
    # top-level even-marker positions, which for value m+1 are exactly
    # the positions holding m+1 -- nested sites use different markers);
    # end_positions is keyed by the even (allele) marker m+1
    spans = {}
    for m, entry in entries.items():
        end = end_positions[m + 1]
        seps = [int(p) for p in range(entry + 1, end + 1)
                if ints[p] == m + 1]
        lo = entry + 1
        sp = []
        for s in seps:
            sp.append((lo, s))
            lo = s + 1
        spans[m] = sp

    def walk(lo, hi, parts, r):
        i = lo
        while i < hi:
            v = int(ints[i])
            if v > 4:
                m = v if v % 2 == 1 else v - 1
                sp = spans[m]
                a, b = sp[r.randint(len(sp))]
                walk(a, b, parts, r)
                i = end_positions[m + 1] + 1
            else:
                j = min(int(next_marker[i]), hi)
                parts.append(ints[i:j])
                i = j

    paths = []
    for _ in range(n_paths):
        parts = []
        walk(0, n, parts, rng)
        paths.append(np.concatenate(parts).astype(np.uint8))
    return paths


def sample_reads(rng, paths, n_reads, read_len):
    reads = np.empty((n_reads, read_len), dtype=np.uint8)
    for i in range(n_reads):
        path = paths[rng.randint(len(paths))]
        start = rng.randint(0, path.size - read_len)
        reads[i] = path[start : start + read_len]
    return reads


def write_fastq(path, reads):
    lut = np.frombuffer(b"NACGT", dtype="S1")
    with open(path, "w") as fh:
        qual = "I" * reads.shape[1]
        for i, r in enumerate(reads):
            seq = lut[r].tobytes().decode()
            fh.write(f"@r{i}\n{seq}\n+\n{qual}\n")


# --------------------------------------------------------------------------
# roofline accounting
# --------------------------------------------------------------------------

def scan_gather_bytes_per_batch(phases, n_outcomes, rank):
    """Analytic HBM bytes moved by one scan batch: the gather/scatter
    terms of _build_log_step over the PADDED phase shapes (gathers run
    on padded pools; occupancy tells how much of that was live work)."""
    B = n_outcomes
    occ_row = 96 + 4 if rank == "packed" else 16   # packed: 96B rec + off
    total = 0
    for n_steps, pool, hits, *_ in phases:
        per_step = (
            2 * pool * occ_row          # LF occ rows (lo, hi+1)
            + pool * 4                  # base gather by read id
            + hits * 4                  # marker rank -> locus
            + 2 * hits * B * 4          # jump outcome intervals
            + 2 * hits * B * occ_row    # newborn LF occ rows
            + 2 * 4 * (2 * pool + hits * B) * 4  # repack r/w of 4 arrays
        )
        total += n_steps * per_step
    return total


def hbm_peak_bytes(device_kind: str) -> float:
    """Published peak memory bandwidth of one device of this kind."""
    try:
        return HBM_PEAK[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak bandwidth on record for device kind {device_kind!r}; "
            f"add it to bench.HBM_PEAK with its source") from None


def gpu_name_and_power_limit() -> str:
    """`name, power.limit` of the first GPU as nvidia-smi prints them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def require_gpu_backend():
    """Refuse to measure on anything but the GPU, unless a CPU run was
    asked for explicitly (JAX_PLATFORMS=cpu, the CI smoke)."""
    import jax

    backend = jax.default_backend()
    if backend == "gpu":
        return
    if backend == "cpu" and os.environ.get("JAX_PLATFORMS") == "cpu":
        return
    raise SystemExit(f"bench.py measures on the GPU; JAX backend is "
                     f"{backend!r} (set JAX_PLATFORMS=cpu for a CPU smoke)")


# --------------------------------------------------------------------------
# workload cache
# --------------------------------------------------------------------------

def _workload_cache_key():
    """Key covers the params AND the generator code: a changed builder
    regenerates instead of serving a stale workload."""
    import hashlib
    import inspect

    src = "".join(inspect.getsource(f) for f in (
        build_synthetic_mtb_graph, build_mixed_graph, sample_haplotypes))
    blob = f"{GENOME_MB}|{NUM_SITES}|{READ_LEN}|{KMER_SIZE}|{PROFILE}|{src}"
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _load_or_build_workload():
    """Synthetic graph + index + kmer index + haplotype paths, cached on
    disk in the checkout (~55 s rebuild -> seconds of pickle load)."""
    import pickle

    from gramtools_tpu.index.fm import FMIndex
    from gramtools_tpu.prg.graph import build_cov_graph
    from gramtools_tpu.prg.linearise import PrgString
    from gramtools_tpu.mapping.search import PrgIndex
    from gramtools_tpu.index.kmer_index_vec import build_kmer_index_vectorised

    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ".bench_cache")
    path = os.path.join(cache_dir, f"wl_{_workload_cache_key()}.pkl")
    if os.path.exists(path) and not os.environ.get("BENCH_NO_WL_CACHE"):
        try:
            t = time.time()
            with open(path, "rb") as fh:
                wl = pickle.load(fh)
            print(f"# workload cache hit ({path}): {time.time()-t:.1f}s",
                  file=sys.stderr)
            RESULT["workload_cache"] = "hit"
            return wl
        except Exception as e:
            print(f"# workload cache unreadable ({e}); rebuilding",
                  file=sys.stderr)
    RESULT["workload_cache"] = "miss"
    rng = np.random.RandomState(42)
    genome_len = int(GENOME_MB * 1e6)
    t0 = time.time()
    print(f"# building synthetic graph: {GENOME_MB}Mb, {NUM_SITES} sites, "
          f"profile={PROFILE}", file=sys.stderr)
    if PROFILE == "mixed":
        prg_ints = build_mixed_graph(rng, genome_len, NUM_SITES)
    else:
        prg_ints = build_synthetic_mtb_graph(rng, genome_len, NUM_SITES)
    prg = PrgString(prg_ints)
    graph = build_cov_graph(prg)
    fm = FMIndex.build(prg_ints)
    end_positions = dict(prg.end_positions)
    idx = PrgIndex(prg_ints, graph, fm, end_positions)
    print(f"# index built in {time.time()-t0:.1f}s; fm size {fm.size}",
          file=sys.stderr)
    t_k = time.time()
    kmer_index = build_kmer_index_vectorised(idx, KMER_SIZE)
    print(f"# kmer index k={KMER_SIZE}: {kmer_index.num_kmers()} kmers, "
          f"{kmer_index.lo.size} states, {time.time()-t_k:.1f}s",
          file=sys.stderr)
    paths = sample_haplotypes(prg_ints, end_positions, rng, n_paths=8)
    wl = (prg_ints, idx, kmer_index, end_positions, paths,
          rng.get_state())
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(wl, fh, protocol=5)
        os.replace(tmp, path)
        print(f"# workload cached -> {path}", file=sys.stderr)
    except Exception as e:
        print(f"# workload cache write failed: {e}", file=sys.stderr)
    return wl


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def main():
    signal.signal(signal.SIGALRM, _deadline)
    signal.signal(signal.SIGTERM, _deadline)
    signal.alarm(max(BUDGET_S, 30))
    import jax
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gramtools_tpu.common.jax_setup import enable_compile_cache
    enable_compile_cache()
    _hook_cache_telemetry()
    require_gpu_backend()
    dev = jax.devices()[0]
    RESULT["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}
    if dev.platform == "gpu":
        RESULT["gpu_name_power_limit"] = gpu_name_and_power_limit()

    from gramtools_tpu.mapping.device_index import DeviceIndex

    prg_ints, idx, kmer_index, end_positions, paths, rng_state = \
        _load_or_build_workload()
    rng = np.random.RandomState(42)
    rng.set_state(rng_state)
    _phase_done("workload")

    out = RESULT     # phases below fill the result line incrementally

    # ---- compiled C++/OpenMP baseline FIRST (host-only, cheap) --------
    # so vs_baseline is populated even if the device phases hit the
    # deadline. The PRIMARY baseline is the full-pipeline run
    # (gram_tpu_cpu_quasimap_e2e): raw reads in, both orientations
    # screened + seeded + scanned + selected + tallied on all host cores
    # -- the same per-read work the device e2e path is timed on, so
    # vs_baseline compares equal work (BASELINE.md: the reference `gram`
    # binary cannot be built offline; this re-implements its mapping
    # path over this package's index tables). The scan-only rate
    # (pre-seeded, one orientation) is reported alongside as the raw
    # kernel comparison.
    from gramtools_tpu.index.native import (cpu_quasimap_baseline,
                                            cpu_quasimap_e2e_baseline)
    from gramtools_tpu.mapping.jump_table import build_jump_table
    cpp_rps = None
    jt = build_jump_table(idx)
    bl_n = int(os.environ.get("BENCH_BASELINE_READS", 2 * BATCH))
    bl_reads = sample_reads(rng, paths, bl_n, READ_LEN)
    bl_seeds = rng.randint(0, 2 ** 32, size=bl_n).astype(np.uint32)
    n_sites_tally = (int(np.max(prg_ints[prg_ints > 4])) - 3) // 2 if (
        prg_ints > 4).any() else 1

    def _measure_cpp_e2e():
        """The 2-core OpenMP baseline is sensitive to ANY concurrent
        host activity (background device-touch thread, pickle flush):
        measured 7.4k-37.5k reads/s for the same binary. Measured once
        up front (so vs_baseline survives a deadline) and re-measured
        on a quiet host at the end, keeping the MAX -- the baseline
        must not be flattered down by our own noise."""
        t3 = time.time()
        r = cpu_quasimap_e2e_baseline(
            idx, jt, kmer_index, bl_reads, bl_seeds, n_sites=n_sites_tally,
            num_threads=CPP_THREADS)
        return (None if r is None else (bl_n / (time.time() - t3), int(r[1])))

    bl = _measure_cpp_e2e()
    for _ in range(2):      # best-of-3: the 2-core rate swings 5x with
        b2 = _measure_cpp_e2e()     # host noise
        if b2 is not None and (bl is None or b2[0] > bl[0]):
            bl = b2
    if bl is not None:
        cpp_rps = bl[0]
        out["cpp_omp_baseline_reads_per_sec"] = round(cpp_rps, 1)
        out["cpp_threads"] = CPP_THREADS or os.cpu_count()
        out["baseline_host_cores"] = CPP_THREADS or os.cpu_count()
        out["baseline_scope"] = ("full pipeline: 2 orientations, kmer "
                                 "screen, seed, scan, select, tally")
        out["baseline_mapped_reads"] = bl[1]
        print(f"# C++/OpenMP e2e baseline ({out['cpp_threads']} threads): "
              f"{cpp_rps:.0f} reads/s ({bl[1]}/{bl_n} mapped)",
              file=sys.stderr)

    # scan-only secondary baseline (pre-seeded, one orientation)
    bl_scan = bl_reads[:BATCH]
    steps = READ_LEN - KMER_SIZE
    owner_bl, lo_bl, hi_bl, *_ = kmer_index.seed_batch(
        bl_scan[:, READ_LEN - KMER_SIZE:])
    order = np.argsort(owner_bl, kind="stable")
    seed_ptr = np.zeros(BATCH + 1, dtype=np.int64)
    np.add.at(seed_ptr, owner_bl + 1, 1)
    seed_ptr = np.cumsum(seed_ptr)
    bl_rl = np.ascontiguousarray(bl_scan[:, :steps][:, ::-1]).astype(
        np.int32)
    n_steps_arr = np.full(BATCH, steps, dtype=np.int32)
    t3 = time.time()
    bl_result = cpu_quasimap_baseline(
        idx, jt, bl_rl, n_steps_arr, seed_ptr,
        lo_bl[order], hi_bl[order], num_threads=CPP_THREADS)
    t4 = time.time()
    if bl_result is not None:
        scan_bl_rps = BATCH / (t4 - t3)
        out["cpp_omp_scan_only_reads_per_sec"] = round(scan_bl_rps, 1)
        if cpp_rps is None:     # e2e baseline unavailable: fall back
            cpp_rps = scan_bl_rps
            out["cpp_omp_baseline_reads_per_sec"] = round(cpp_rps, 1)
            out["cpp_threads"] = CPP_THREADS or os.cpu_count()
            out["baseline_host_cores"] = CPP_THREADS or os.cpu_count()
            out["baseline_scope"] = "scan only (pre-seeded, 1 orientation)"
        print(f"# C++/OpenMP scan-only ({CPP_THREADS or os.cpu_count()} "
              f"threads): {scan_bl_rps:.0f} reads/s", file=sys.stderr)

    # ---- scan-only rate + occupancy + roofline ------------------------
    # This device phase runs FIRST: it is one small jit program that
    # compiles faster than the fused record program, so a device number
    # lands in the result line early; the e2e phase then upgrades value
    # to the full-pipeline rate.
    import jax.numpy as jnp
    from functools import partial
    from gramtools_tpu.mapping.search_jax_log import (
        LogConfig, _log_search_phases, _log_search_probe, _occ_rows_for,
        auto_phases, empty_log_carry)

    @partial(jax.jit, static_argnames=("phases", "num_reads", "rank"))
    def _scan_digest(di, reads_T, carry, phases, num_reads, blocks=None,
                     rank="dense"):
        """Scan + 1-scalar checksum: the timed loop fetches this digest
        per batch, which waits for the full computation while moving 4
        bytes instead of the bulky outputs."""
        carry, (lp, le) = _log_search_phases(
            di, reads_T, carry, phases, num_reads,
            occ_rows=_occ_rows_for(di, blocks, rank))
        rid, lo, hi, pref, ovf = carry
        total = (jnp.sum(rid) + jnp.sum(lo) + jnp.sum(hi) + jnp.sum(pref)
                 + jnp.sum(ovf.astype(jnp.int32)) + jnp.sum(lp)
                 + jnp.sum(le))
        return total.astype(jnp.int32)

    di = DeviceIndex.build(idx)
    blocks = None
    if RANK == "packed":
        from gramtools_tpu.ops.rank import build_packed_occ
        import dataclasses
        blocks = jnp.asarray(build_packed_occ(idx.fm))
        di = dataclasses.replace(di, occ=jnp.zeros((1, 4), jnp.int32))

    # DISTINCT reads per timed batch, as production sees them
    pool = int(os.environ.get("BENCH_POOL", 4 * BATCH))
    hits = int(os.environ.get("BENCH_HITS", BATCH // 2))
    cfg = LogConfig(pool=pool, hits=hits)
    steps = READ_LEN - KMER_SIZE
    batch_args = []
    phases = None
    for bi in range(BATCHES + 1):           # +1 warmup batch
        reads = sample_reads(rng, paths, BATCH, READ_LEN)
        carry = empty_log_carry(BATCH, cfg)
        owner, s_lo, s_hi, *_ = kmer_index.seed_batch(
            reads[:, READ_LEN - KMER_SIZE:])
        n_states = min(owner.size, cfg.pool)
        read_id, lo, hi, pref, _ = carry
        read_id[:n_states] = owner[:n_states]
        lo[:n_states] = s_lo[:n_states]
        hi[:n_states] = s_hi[:n_states]
        pref[:n_states] = -np.arange(1, n_states + 1, dtype=np.int32)
        if phases is None:
            phases = auto_phases(steps, BATCH, cfg, n_seed_states=n_states)
            pool0 = phases[0][1]
            print(f"# scan batch: {np.unique(owner[:n_states]).size}/{BATCH}"
                  f" seeded, {n_states} states, phases={phases}",
                  file=sys.stderr)
        carry = tuple(a[:pool0] for a in carry[:4]) + (carry[4],)
        reads_T = np.ascontiguousarray(
            reads[:, :steps][:, ::-1].T).astype(np.int32)
        batch_args.append((jnp.asarray(reads_T), jax.device_put(carry)))

    t_c = time.time()
    digest = _scan_digest(di, *batch_args[0], tuple(phases), BATCH,
                          blocks=blocks, rank=RANK)
    int(digest)
    print(f"# scan warmup/compile: {time.time()-t_c:.1f}s", file=sys.stderr)
    t1 = time.time()
    acc = 0
    for bi in range(1, BATCHES + 1):
        digest = _scan_digest(di, *batch_args[bi], tuple(phases), BATCH,
                              blocks=blocks, rank=RANK)
        acc ^= int(digest)   # FETCH per batch: forces the execution
    t2 = time.time()
    scan_rps = BATCH * BATCHES / (t2 - t1)
    # stats probe (occupancy/overflow), once, outside the timing
    res = _log_search_probe(di, *batch_args[0], tuple(phases), BATCH,
                            blocks=blocks, rank=RANK)
    live = np.asarray(res[2])
    occupancy = [round(float(l) / p, 4)
                 for l, p in zip(live, [e[1] for e in phases])]
    n_overflow = int(np.asarray(res[0][4]).sum())

    bytes_per_batch = scan_gather_bytes_per_batch(phases, di.n_outcomes,
                                                  RANK)
    batch_s = (t2 - t1) / BATCHES
    gb_per_s = bytes_per_batch / batch_s
    kind = jax.devices()[0].device_kind
    peak = hbm_peak_bytes(kind) if jax.default_backend() == "gpu" else None
    out["scan_reads_per_sec"] = round(scan_rps, 1)
    out["scan_overflow_reads"] = n_overflow
    out["pool_occupancy_per_phase"] = occupancy
    out["gather_bytes_per_batch"] = bytes_per_batch
    out["gather_GBps"] = round(gb_per_s / 1e9, 2)
    out["device_kind"] = kind
    if peak:
        out["hbm_roofline_fraction"] = round(gb_per_s / peak, 4)
    print(f"# scan: {scan_rps:.0f} reads/s, {gb_per_s/1e9:.1f} GB/s of "
          f"{'%.0f' % (peak/1e9) if peak else '?'} GB/s peak, "
          f"occupancy={occupancy}, overflow={n_overflow}", file=sys.stderr)

    # vs_baseline_scan: like-for-like kernel comparison against the C++
    # scan-only rate; value provisionally = scan rate (the e2e phase
    # overwrites it with the full-pipeline rate)
    scan_bl = out.get("cpp_omp_scan_only_reads_per_sec")
    if scan_bl:
        out["vs_baseline_scan"] = round(scan_rps / scan_bl, 2)
    if out["value"] is None:
        out["value"] = round(scan_rps, 1)
        out["value_source"] = "scan_only"
        if scan_bl:
            out["vs_baseline"] = out["vs_baseline_scan"]
    _phase_done("scan")

    # ---- end-to-end device mapping path -------------------------------
    if not SKIP_E2E:
        # throughput-mode buffer (quasimap.DEVICE_BUFFER_SIZE): the
        # production default for device engines
        os.environ.setdefault(
            "GRAMTOOLS_TPU_BUFFER", os.environ.get("BENCH_BUFFER", "20000"))
        os.environ.setdefault("GRAMTOOLS_TPU_DEVICE_RECORD", "1")
        os.environ["GRAMTOOLS_TPU_TIMERS"] = "1"
        if RANK != "dense":
            os.environ["GRAMTOOLS_TPU_RANK"] = RANK
        from gramtools_tpu.common.rng import (RandomInclusiveInt,
                                              first_raw_draws)
        from gramtools_tpu.mapping.coverage import Coverage
        from gramtools_tpu.mapping.quasimap import (READS_BUFFER_SIZE,
                                                    QuasimapStats,
                                                    iter_read_buffers)
        from gramtools_tpu.mapping.search_jax_log import LogBatchedEngine

        engine = LogBatchedEngine(idx, KMER_SIZE)
        size = READS_BUFFER_SIZE
        stats = QuasimapStats()
        coverage = Coverage.empty(idx)
        master = RandomInclusiveInt(42)

        def _draw():
            seeds = master.raw_block(size)
            return seeds, first_raw_draws(np.asarray(seeds, dtype=np.uint32))

        def _upd(done, secs):
            out["value"] = round(done / secs, 1)
            out["value_source"] = "e2e"
            out["e2e_seconds"] = round(secs, 3)
            out["e2e_reads_measured"] = done
            if cpp_rps:
                out["vs_baseline"] = round(out["value"] / cpp_rps, 2)
                out["vs_baseline_e2e"] = out["vs_baseline"]

        with tempfile.TemporaryDirectory() as td:
            fq = os.path.join(td, "reads.fastq")
            write_fastq(fq, sample_reads(rng, paths, size + E2E_READS,
                                         READ_LEN))
            buffers = iter_read_buffers(fq, size)
            # warmup: ONE production buffer through the full pipeline --
            # it dispatches the canonical sticky shapes, so the timed run
            # recompiles nothing (steady_state_new_shapes proves it)
            t_w = time.time()
            warm_buf = next(buffers)
            seeds_w, fr_w = _draw()
            tok = engine.scan_submit(warm_buf, kmer_index, KMER_SIZE, stats,
                                     first_raws=fr_w)
            engine.record_complete(tok, seeds_w, fr_w, stats, coverage)
            warm_s = time.time() - t_w
            out["e2e_compile_warmup_seconds"] = round(warm_s, 1)
            print(f"# e2e warmup ({len(warm_buf)} reads, incl. compile): "
                  f"{warm_s:.1f}s; shapes={len(engine.dispatch_shapes)}",
                  file=sys.stderr)
            _phase_done("e2e_warmup")
            engine.timers.clear()
            warm_shapes = len(engine.dispatch_shapes)
            # timed PIPELINED loop (submit N+1 before completing N, the
            # production quasimap_reads structure); the result line
            # updates after EVERY completed buffer, so a deadline
            # mid-run reports the finished prefix instead of null
            done = 0
            in_flight = None
            t_e = time.time()
            for buffer in buffers:
                seeds, frs = _draw()
                token = engine.scan_submit(buffer, kmer_index, KMER_SIZE,
                                           stats, first_raws=frs)
                if in_flight is not None:
                    n_buf, tok_f, seeds_f, frs_f = in_flight
                    engine.record_complete(tok_f, seeds_f, frs_f, stats,
                                           coverage)
                    done += n_buf
                    _upd(done, time.time() - t_e)
                in_flight = (len(buffer), token, seeds, frs)
            if in_flight is not None:
                n_buf, tok_f, seeds_f, frs_f = in_flight
                engine.record_complete(tok_f, seeds_f, frs_f, stats,
                                       coverage)
                done += n_buf
            engine.flush_device_coverage()   # once per run, as production
            _upd(done, time.time() - t_e)
            new_shapes = len(engine.dispatch_shapes) - warm_shapes
        out["device_mapped"] = engine.device_mapped
        out["host_fallbacks"] = engine.host_fallbacks
        out["device_retried"] = engine.device_retried
        out["stage_seconds"] = {k: round(v, 3)
                                for k, v in sorted(engine.timers.items())}
        out["steady_state_new_shapes"] = new_shapes  # 0 = no recompiles
        out["fallback_reasons"] = dict(engine.fallback_reasons)
        print(f"# e2e: {out['value']:.0f} reads/s "
              f"({engine.device_mapped} dev, {engine.host_fallbacks} host, "
              f"{engine.device_retried} retried, {new_shapes} new shapes); "
              f"stages: {out['stage_seconds']}", file=sys.stderr)
        _phase_done("e2e")

    # re-measure the C++ baseline on the now-quiet host; keep the MAX
    # (see _measure_cpp_e2e) and recompute the ratios against it
    if _remaining() > 20:
        bl2 = _measure_cpp_e2e()
        if bl2 is not None and (cpp_rps is None or bl2[0] > cpp_rps):
            cpp_rps = bl2[0]
            out["cpp_omp_baseline_reads_per_sec"] = round(cpp_rps, 1)
            print(f"# C++/OpenMP e2e baseline (re-measured, quiet): "
                  f"{cpp_rps:.0f} reads/s", file=sys.stderr)
        if cpp_rps and out.get("value"):
            out["vs_baseline"] = round(out["value"] / cpp_rps, 2)
            if out.get("value_source") == "e2e":
                out["vs_baseline_e2e"] = out["vs_baseline"]
            if out.get("scan_reads_per_sec") and out.get(
                    "cpp_omp_scan_only_reads_per_sec"):
                out["vs_baseline_scan"] = round(
                    out["scan_reads_per_sec"]
                    / out["cpp_omp_scan_only_reads_per_sec"], 2)
    # Scope note for the ratios: the device e2e rate covers the FULL
    # production path (read IO, both orientations, kmer screen, scan,
    # selection, coverage recording) and vs_baseline compares it to the
    # C++/OpenMP full-pipeline rate on all host cores (equal work);
    # vs_baseline_scan is the pre-seeded one-orientation kernel
    # comparison.
    signal.alarm(0)
    _emit()


if __name__ == "__main__":
    try:
        main()
    except BaseException as e:  # still emit the partial result line
        if isinstance(e, (KeyboardInterrupt, SystemExit)):
            raise
        import traceback
        traceback.print_exc()
        RESULT["error"] = f"{type(e).__name__}: {e}"
        _emit()
        sys.exit(0 if RESULT.get("value") else 1)

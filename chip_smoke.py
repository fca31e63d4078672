#!/usr/bin/env python3
"""Proof that gramtools-tpu runs its main path on one NVIDIA GPU.

    python3 chip_smoke.py                # one GPU; every phase below
    python3 chip_smoke.py --four-cards   # four GPUs; mesh vs one card only

The deployment is the reference's own: haploid M. tuberculosis
genotyping, a 4.4 Mb graph with 100,000 biallelic SNP sites, k = 10,
and 200,000 reads of 150 bp sampled from haplotype paths (~7x depth),
all generated from --seed. Phases, one line of findings each:

  device   nvidia-smi name and power limit, jax.devices(), XLA flags;
           fails unless JAX's backend is the GPU
  tests    the `gpu`-marked tests (pytest -m gpu), in a child process
           that runs before this process opens the GPU
  main     `gramtools-tpu build`, then `genotype --engine device` on all
           reads: reads/s, first-buffer (cold compile) seconds, new
           shapes after the first buffer (must be 0), device/host counts
  oracle   (a) the device scan's final SA intervals on 10,000 reads equal
           the native C++ scan's (index/native.py); (b) on a 5,000-read
           subset `genotype --engine device` and `--engine host` write
           byte-identical outputs (VCF up to ##fileDate). Every value
           compared is an integer, so the tolerance is exact.
  packed   the engine with packed rank gives the same scan as dense rank

Any failed phase raises, and the process exits non-zero without the
result line. The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
where N is the number of GPUs the phases used: 1, or 4 with --four-cards.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

GENOME_LEN = 4_400_000
NUM_SITES = 100_000
READ_LEN = 150
KMER_SIZE = 10
N_READS = 200_000
N_PATHS = 8
ORACLE_READS = 10_000
MIN_COMPARED_ROWS = 8_192
SUBSET_READS = 5_000
PLATFORM = "gpu"        # where every device-engine run must have mapped

# outputs compared byte for byte between two genotype runs
COMPARED_FILES = ("genotype/genotyped.json",
                  "genotype/personalised_reference.fasta",
                  "coverage/allele_sum_coverage",
                  "coverage/grouped_allele_counts_coverage.json",
                  "coverage/allele_base_coverage.json")
VCF = "genotype/genotyped.vcf.gz"


def say(phase: str, **findings):
    print(f"[{phase}] " + "; ".join(f"{k}={v}" for k, v in findings.items()),
          flush=True)


# --------------------------------------------------------------------------
# workload
# --------------------------------------------------------------------------

def reference_of(prg_ints: np.ndarray) -> np.ndarray:
    """The reference path of a biallelic SNP PRG (bench's
    build_synthetic_mtb_graph): every site [m, ref, m+1, alt, m+1]
    becomes its ref base."""
    ints = np.asarray(prg_ints)
    keep = np.ones(ints.size, dtype=bool)
    entry = np.flatnonzero((ints > 4) & (ints % 2 == 1))
    for off in (0, 2, 3, 4):
        keep[entry + off] = False
    return ints[keep]


def make_workload(workdir: Path, seed: int, n_reads: int):
    """Writes prg, ref.fa and reads.fastq under workdir from the seed.
    Returns the (n_reads, READ_LEN) uint8 read matrix (codes 1-4)."""
    from bench import (build_synthetic_mtb_graph, sample_haplotypes,
                       sample_reads, write_fastq)
    from gramtools_tpu.prg.linearise import PrgString

    rng = np.random.RandomState(seed)
    prg_ints = build_synthetic_mtb_graph(rng, GENOME_LEN, NUM_SITES)
    prg = PrgString(prg_ints)
    workdir.mkdir(parents=True, exist_ok=True)
    prg.write(workdir / "prg")
    ref = np.frombuffer(b"NACGT", dtype="S1")[reference_of(prg_ints)]
    (workdir / "ref.fa").write_text(">ref\n" + ref.tobytes().decode() + "\n")
    paths = sample_haplotypes(prg_ints, dict(prg.end_positions), rng,
                              n_paths=N_PATHS)
    reads = sample_reads(rng, paths, n_reads, READ_LEN)
    write_fastq(workdir / "reads.fastq", reads)
    return reads


def cli(*argv):
    from gramtools_tpu.cli import run

    rc = run([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"gramtools-tpu {argv[0]} returned {rc}")


def genotype(workdir: Path, reads: Path, out: str, engine: str, seed: int):
    """`gramtools-tpu genotype` in-process; returns (seconds, report)."""
    t = time.perf_counter()
    cli("genotype", "--gram_dir", workdir / "gram",
        "--genotype_dir", workdir / out, "--reads", reads,
        "--sample_id", "smoke", "--engine", engine, "--seed", seed,
        "--force")
    secs = time.perf_counter() - t
    report = json.loads((workdir / out / "genotype_report.json").read_text())
    return secs, report


def compare_outputs(dir_a: Path, dir_b: Path) -> list:
    """Names of the genotype outputs that differ between two runs: the
    jVCF, personalised reference and coverage dumps byte for byte, the
    VCF after gunzip with its ##fileDate line left out."""
    diff = [rel for rel in COMPARED_FILES
            if (dir_a / rel).read_bytes() != (dir_b / rel).read_bytes()]

    def vcf_body(d):
        with gzip.open(d / VCF, "rt") as fh:
            return [l for l in fh if not l.startswith("##fileDate")]

    if vcf_body(dir_a) != vcf_body(dir_b):
        diff.append(VCF)
    return diff


# --------------------------------------------------------------------------
# scan oracle
# --------------------------------------------------------------------------

def device_scan(engine, reads: np.ndarray, kmer_index):
    """The engine's packed scan (retry pass included) over a read
    matrix. Returns (rows, per-row interval sets, rows the device left
    to the host)."""
    from gramtools_tpu.mapping.quasimap import QuasimapStats, ReadBatch

    (_, rows, carry, _, _, _, host_rows) = engine._scan_rows(
        ReadBatch(reads), kmer_index, engine.kmer_size, QuasimapStats())
    rid, lo, hi, _, ovf = carry
    ivs = {}
    for r, a, b in zip(rid.tolist(), lo.tolist(), hi.tolist()):
        if r >= 0:
            ivs.setdefault(r, set()).add((a, b))
    left = set(host_rows) | set(np.flatnonzero(ovf[:len(rows)]).tolist())
    return rows, ivs, left


def native_scan(idx, kmer_index, rows, iv_cap: int = 1024):
    """index/native.cpu_quasimap_baseline over the same oriented rows:
    per-row final interval sets, or None when a row's state count
    exceeds iv_cap."""
    from gramtools_tpu.index.native import cpu_quasimap_baseline
    from gramtools_tpu.mapping.jump_table import build_jump_table

    k = kmer_index.kmer_size
    mat = np.stack([r for _, r in rows])
    steps = mat.shape[1] - k
    owner, s_lo, s_hi, *_ = kmer_index.seed_batch(mat[:, steps:])
    order = np.argsort(owner, kind="stable")
    seed_ptr = np.zeros(len(rows) + 1, dtype=np.int64)
    np.add.at(seed_ptr, owner + 1, 1)
    out = cpu_quasimap_baseline(
        idx, build_jump_table(idx),
        np.ascontiguousarray(mat[:, :steps][:, ::-1]).astype(np.int32),
        np.full(len(rows), steps, np.int32), np.cumsum(seed_ptr),
        s_lo[order], s_hi[order], iv_cap=iv_cap)
    if out is None:
        raise RuntimeError("native C++ scan unavailable (g++ build failed?)")
    n_states, _, iv = out
    return [set(map(tuple, iv[i, :n].tolist())) if n <= iv_cap else None
            for i, n in enumerate(n_states.tolist())]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device():
    """The card's name and power limit, before JAX touches it; fails
    where no NVIDIA GPU is present."""
    from bench import gpu_name_and_power_limit

    print(gpu_name_and_power_limit(), flush=True)


def phase_jax(expect_count: int):
    import jax

    from gramtools_tpu.common.jax_setup import enable_compile_cache

    enable_compile_cache()
    backend = jax.default_backend()
    devices = jax.devices()
    say("device", backend=backend, devices=devices,
        xla_flags=repr(os.environ.get("XLA_FLAGS", "")))
    if backend != "gpu":
        raise SystemExit(f"JAX backend is {backend!r}, not the GPU")
    if len(devices) < expect_count:
        raise SystemExit(f"{len(devices)} GPUs, {expect_count} needed")
    return devices


def phase_tests():
    """The `gpu`-marked tests, run before this process opens the GPU so
    that only one process holds the card at a time."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "tests/"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    say("tests", rc=proc.returncode, summary=tail[0],
        seconds=round(time.perf_counter() - t, 1))
    if proc.returncode != 0 or "passed" not in tail[0]:
        sys.stderr.write(proc.stdout[-6000:] + proc.stderr[-4000:])
        raise RuntimeError("gpu-marked tests failed")


def check_genotype_run(workdir: Path, out: str, report: dict):
    """A device-engine genotype run wrote every output, mapped on this
    process's accelerator (platform and device kind in its report) and
    kept reads on the device."""
    import jax

    for rel in COMPARED_FILES + (VCF,):
        if not (workdir / out / rel).is_file():
            raise RuntimeError(f"{out}: {rel} missing")
    proc = report["processes"]["genotype"]
    where = (proc["platform"], proc["device_kind"])
    if where != (PLATFORM, jax.devices()[0].device_kind):
        raise RuntimeError(f"{out}: mapped on {where!r}")
    eng = proc["engine"]
    if eng["device_mapped"] <= 0:
        raise RuntimeError(f"{out}: device_mapped = 0")
    return proc, eng


def phase_main(workdir: Path, seed: int):
    t = time.perf_counter()
    reads = make_workload(workdir, seed, N_READS)
    t_gen = time.perf_counter() - t
    t = time.perf_counter()
    cli("build", "--gram_dir", workdir / "gram", "--prg", workdir / "prg",
        "--ref", workdir / "ref.fa", "--kmer_size", KMER_SIZE, "--force")
    t_build = time.perf_counter() - t
    secs, report = genotype(workdir, workdir / "reads.fastq", "geno",
                            "device", seed)
    proc, eng = check_genotype_run(workdir, "geno", report)
    say("main", reads=N_READS, generate_s=round(t_gen, 1),
        build_s=round(t_build, 1), genotype_s=round(secs, 1),
        e2e_reads_per_s=round(N_READS / secs, 1),
        mapping_steady_reads_per_s=round(
            eng.get("steady_reads_per_second", 0.0), 1),
        first_buffer_compile_s=round(eng["first_buffer_seconds"], 1),
        steady_state_new_shapes=eng["steady_state_new_shapes"],
        device_mapped=eng["device_mapped"],
        host_fallbacks=eng["host_fallbacks"],
        device_retried=eng["device_retried"],
        fallback_reasons=json.dumps(eng["fallback_reasons"]),
        device_kind=repr(proc["device_kind"]))
    if eng["steady_state_new_shapes"] != 0:
        raise RuntimeError("steady state compiled new shapes")
    return reads


def phase_oracle(workdir: Path, reads: np.ndarray, seed: int):
    from gramtools_tpu.index.build import load_all
    from gramtools_tpu.mapping.search_jax_log import LogBatchedEngine

    # (a) device scan == native C++ scan, exact
    idx, kmer_index = load_all(workdir / "gram")
    engine = LogBatchedEngine(idx, KMER_SIZE)
    sub = reads[:ORACLE_READS]
    rows, ivs, left = device_scan(engine, sub, kmer_index)
    native = native_scan(idx, kmer_index, rows)
    compared = [r for r in range(len(rows))
                if r not in left and native[r] is not None]
    bad = [r for r in compared if ivs.get(r, set()) != native[r]]
    say("oracle", check="a: device scan vs native C++ scan",
        reads=len(sub), rows=len(rows), compared_rows=len(compared),
        left_to_host=len(left), mismatched_rows=len(bad),
        tolerance="exact (SA intervals are integers)")
    if bad or len(compared) < MIN_COMPARED_ROWS:
        raise RuntimeError(f"scan oracle failed: {len(bad)} rows differ, "
                           f"{len(compared)} compared")

    # (b) device genotype == host genotype on a subset, byte for byte
    fq = workdir / "subset.fastq"
    with open(workdir / "reads.fastq") as src, open(fq, "w") as dst:
        for _ in range(4 * SUBSET_READS):
            dst.write(src.readline())
    dev_s, dev_rep = genotype(workdir, fq, "sub_device", "device", seed)
    check_genotype_run(workdir, "sub_device", dev_rep)
    host_s, _ = genotype(workdir, fq, "sub_host", "host", seed)
    diff = compare_outputs(workdir / "sub_device", workdir / "sub_host")
    say("oracle", check="b: genotype device vs host", reads=SUBSET_READS,
        device_s=round(dev_s, 1), host_s=round(host_s, 1),
        differing_files=diff or "none",
        tolerance="exact (counts and calls; VCF without ##fileDate)")
    if diff:
        raise RuntimeError(f"device and host genotype differ: {diff}")
    return idx, kmer_index, engine, rows, ivs, left


def phase_packed(idx, kmer_index, reads, dense_engine, rows, ivs, left):
    from gramtools_tpu.mapping.search_jax_log import LogBatchedEngine

    os.environ["GRAMTOOLS_TPU_RANK"] = "packed"
    try:
        engine = LogBatchedEngine(idx, KMER_SIZE)
    finally:
        del os.environ["GRAMTOOLS_TPU_RANK"]
    sub = reads[:ORACLE_READS]
    p_rows, p_ivs, p_left = device_scan(engine, sub, kmer_index)
    times = {}
    for name, eng in (("dense", dense_engine), ("packed", engine)):
        t = time.perf_counter()
        device_scan(eng, sub, kmer_index)
        times[name] = time.perf_counter() - t
    same = (len(p_rows) == len(rows) and p_left == left and p_ivs == ivs)
    say("packed", rows=len(p_rows), same_as_dense=same,
        dense_scan_call_s=round(times["dense"], 3),
        packed_scan_call_s=round(times["packed"], 3))
    if not same:
        raise RuntimeError("packed-rank scan differs from dense-rank scan")


def phase_four_cards(workdir: Path, seed: int) -> int:
    """The mesh genotype and its one-card twin; returns the number of
    GPUs the mesh run used."""
    make_workload(workdir, seed, N_READS)
    cli("build", "--gram_dir", workdir / "gram", "--prg", workdir / "prg",
        "--ref", workdir / "ref.fa", "--kmer_size", KMER_SIZE, "--force")
    fq = workdir / "reads.fastq"
    os.environ["GRAMTOOLS_TPU_MESH_DEVICES"] = "4"
    try:
        mesh_s, mesh_rep = genotype(workdir, fq, "geno_mesh4", "device",
                                    seed)
    finally:
        del os.environ["GRAMTOOLS_TPU_MESH_DEVICES"]
    mproc, meng = check_genotype_run(workdir, "geno_mesh4", mesh_rep)
    one_s, one_rep = genotype(workdir, fq, "geno_one", "device", seed)
    check_genotype_run(workdir, "geno_one", one_rep)
    diff = compare_outputs(workdir / "geno_mesh4", workdir / "geno_one")
    say("four-cards", reads=N_READS, mesh_devices=mproc["device_count"],
        mesh_genotype_s=round(mesh_s, 1), one_card_genotype_s=round(one_s, 1),
        mesh_first_buffer_s=round(meng["first_buffer_seconds"], 1),
        mesh_steady_reads_per_s=round(
            meng.get("steady_reads_per_second", 0.0), 1),
        mesh_device_mapped=meng["device_mapped"],
        differing_files=diff or "none")
    if mproc["device_count"] != 4:
        raise RuntimeError("mesh run did not use 4 devices")
    if diff:
        raise RuntimeError(f"4-card and 1-card genotype differ: {diff}")
    return mproc["device_count"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU mesh genotype and its 1-GPU "
                         "comparison")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--workdir", type=Path, default=None,
                    help="keep the workload and outputs here (default: a "
                         "temporary directory, removed at exit)")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    phase_device()
    if not args.four_cards:
        phase_tests()
    devices = phase_jax(n_cards)
    with tempfile.TemporaryDirectory() as tmp:
        workdir = args.workdir or Path(tmp)
        if args.four_cards:
            used = phase_four_cards(workdir, args.seed)
        else:
            reads = phase_main(workdir, args.seed)
            oracle = phase_oracle(workdir, reads, args.seed)
            phase_packed(oracle[0], oracle[1], reads, *oracle[2:])
            used = 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": used}}), flush=True)


if __name__ == "__main__":
    main()

"""`genotype` command: quasimap + infer + outputs.

Parity: gramtools/commands/genotype/genotype.py and the backend
commands::genotype::run (libgramtools src/genotype/genotype.cpp:24-122),
merged into one in-process pipeline.
"""
from __future__ import annotations

import collections
import json
import logging

from ..index.build import load_all
from ..infer.json_prg import make_json_prg, write_json_prg
from ..infer.personalised_ref import get_personalised_ref, write_personalised_ref
from ..infer.runner import LevelGenotyper
from ..infer.segment_tracker import SegmentTracker
from ..infer.vcf_write import write_vcf
from ..mapping.coverage import dump_all
from ..mapping.quasimap import quasimap_reads
from ..mapping.read_stats import ReadStats
from ..common.vcf import parse_vcf
from ..common.seq import load_fasta
from . import report
from .paths import GenotypePaths
from .seq_region_map import SearchableSeqRegionsMap, SeqRegionMapper

log = logging.getLogger("gramtools_tpu")

PLOIDY = {"haploid": 1, "diploid": 2}


def run(args):
    geno_paths = GenotypePaths(args.genotype_dir, args.force)
    geno_paths.setup(args.gram_dir, args.reads)

    log.info("Start process: genotype")
    geno_report = report.new_report()

    build_report = _load_build_report(geno_paths)
    kmer_size = build_report["kmer_size"]

    _execute_genotype(geno_report, "genotype", geno_paths, args, kmer_size)
    geno_report["ploidy"] = args.ploidy

    _check_read_stats(geno_report, "check_read_stats", geno_paths)
    _make_rebasing_map(geno_paths)

    command_hash_paths = report.hash_command_paths(dict(geno_paths.items()))
    report.save_report(geno_report, geno_paths, command_hash_paths)
    log.info("Success! Genotyping process report in %s", geno_paths.report)


def _load_build_report(geno_paths):
    build_path = geno_paths.gram_dir / "build_report.json"
    if not build_path.exists():
        raise SystemExit(
            f"Build report not found: {build_path}. Try re-running build?")
    with open(build_path) as fh:
        build_report = json.load(fh)
    if not build_report["success"]:
        raise SystemExit(f"Build was not completed successfully: see {build_path}")
    return build_report


@report.with_report
def _execute_genotype(geno_report, action, geno_paths, args, kmer_size):
    """The backend pipeline (genotype.cpp:24-122), with phase timing
    (TimerReport parity: genotype.cpp:26-121)."""
    from ..common.timers import TimerReport

    timer = TimerReport()
    read_files = [str(p) for p in geno_paths.reads_files]
    read_stats = ReadStats()
    read_stats.compute_base_error_rate(read_files[0])

    log.info("Loading PRG and kmer index data")
    with timer.phase("Load data"):
        idx, kmer_index = load_all(geno_paths.gram_dir)

    engine = None
    engine_choice = getattr(args, "engine", "auto")
    if engine_choice == "auto":
        import jax
        engine_choice = "device" if jax.default_backend() != "cpu" else "host"
        log.info("Engine auto-selected: %s (jax backend: %s)", engine_choice,
                 jax.default_backend())
    if engine_choice == "device":
        import os
        from ..mapping.search_jax_log import LogBatchedEngine
        mesh = None
        n_mesh = int(os.environ.get("GRAMTOOLS_TPU_MESH_DEVICES", "0"))
        if n_mesh > 1:
            from ..parallel.mesh import make_mesh
            mesh = make_mesh(n_mesh)
            log.info("Using mesh device mapping engine (%d shards)", n_mesh)
        else:
            log.info("Using batched device mapping engine (genealogy log)")
        engine = LogBatchedEngine(idx, kmer_size, mesh=mesh)

    log.info("Running quasimap")
    # device engines default to throughput-mode buffers (one compiled
    # program per ~40k-row dispatch); the host engine keeps the
    # reference's 5,000-read buffer so the selection-RNG stream is
    # bit-identical to the reference binary's
    buffer_size = None
    if engine is not None:
        from ..mapping.quasimap import DEVICE_BUFFER_SIZE
        buffer_size = DEVICE_BUFFER_SIZE
    with timer.phase("Quasimap"):
        stats, coverage = quasimap_reads(read_files, kmer_index, idx, kmer_size,
                                         seed=args.seed, engine=engine,
                                         max_threads=getattr(args, "max_threads", 1),
                                         buffer_size=buffer_size)
        read_stats.compute_coverage_depth(coverage, idx)
    read_stats.serialise(geno_paths.read_stats)
    log.info("Mapping stats: %s", stats.as_dict())
    process_report = collections.OrderedDict(
        [("mapping_stats", stats.as_dict())])
    process_report.update(_engine_device(engine_choice, engine))
    if engine is not None:
        process_report["engine"] = engine.run_summary()
        log.info("Engine: %d device-mapped, %d host fallbacks, %d retried",
                 engine.device_mapped, engine.host_fallbacks,
                 engine.device_retried)
    geno_report["processes"][action] = process_report

    with timer.phase("Coverage dumps"):
        dump_all(coverage, idx, geno_paths.allele_sum_cov, geno_paths.pb_cov,
                 geno_paths.gped_cov)

    log.info("Running genotyping model")
    ploidy = PLOIDY[args.ploidy]
    debug_fpath = str(geno_paths.debug_info) if args.debug else None
    with timer.phase("Genotyping"):
        genotyper = LevelGenotyper(idx, coverage, read_stats, ploidy,
                                   get_gcp=True, debug_fpath=debug_fpath)
        sites = genotyper.genotyped_records

    tracker = SegmentTracker.from_file(geno_paths.gram_dir / "prg_coords.tsv")

    with timer.phase("Outputs"):
        log.info("Producing json vcf")
        prg_json = make_json_prg(idx, sites, tracker, args.sample_id,
                                 "made by gramtools genotype")
        write_json_prg(prg_json, geno_paths.geno_json)

        log.info("Producing personalised reference")
        tracker.reset()
        p_refs = get_personalised_ref(idx, sites, tracker)
        write_personalised_ref(
            p_refs,
            f"{args.sample_id} personalised reference made by gramtools genotype",
            geno_paths.pers_ref)

        log.info("Producing vcf")
        tracker.reset()
        write_vcf(idx, sites, tracker, args.sample_id, geno_paths.geno_vcf)
    timer.report()


def _engine_device(engine_choice: str, engine) -> dict:
    """Which engine mapped the reads and on what device: the JAX
    platform and device kind of the device engine's first device, or
    the host CPU for the scalar host engine (which never touches JAX)."""
    if engine is None:
        return {"mapping_engine": engine_choice, "platform": "cpu",
                "device_kind": "host", "device_count": 1}
    if engine.mesh is not None:
        devices = list(engine.mesh.devices.flat)
    else:
        import jax
        devices = jax.devices()[:1]
    return {"mapping_engine": engine_choice,
            "platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices)}


@report.with_report
def _check_read_stats(geno_report, action, geno_paths):
    with open(geno_paths.read_stats) as f:
        read_stats = json.load(f)
    no_cov = read_stats["Read_depth"]["num_sites_noCov"]
    total = read_stats["Read_depth"]["num_sites_total"]
    if total and no_cov / total > 0.5:
        log.warning(
            "More than 50%% of all variant sites have no coverage (%s out of %s)."
            " Possible reasons include: reads not quality-trimmed; low "
            "sequencing depth.", no_cov, total)


def _make_rebasing_map(geno_paths):
    """genotype.py:131-145. For diploid runs the personalised-reference
    records are ploidy-qualified ("chrom_1", "chrom_2"); sizes are mapped
    back to the base chrom names (first haplotype's length)."""
    chrom_sizes = {}
    for name, seq in load_fasta(geno_paths.pers_ref).items():
        chrom_sizes.setdefault(name, len(seq))
    _, base_records = parse_vcf(geno_paths.geno_vcf)
    record_chroms = {r.chrom for r in base_records}
    if record_chroms - set(chrom_sizes):
        stripped = {}
        for name, size in chrom_sizes.items():
            base = name.rsplit("_", 1)[0] if "_" in name else name
            stripped.setdefault(base, size)
        chrom_sizes = stripped
    region_map = SeqRegionMapper(base_records, chrom_sizes).get_map()
    SearchableSeqRegionsMap(region_map).dump_to(
        geno_paths.rebasing_map, dump_sequences=False)

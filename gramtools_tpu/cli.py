"""gramtools-tpu command line interface.

Parity: gramtools/gramtools_main.py:32-108 (subcommand registry, common
--debug/--force parent parser, logging setup).
"""
from __future__ import annotations

import argparse
import logging
import sys


def _setup_logging(debug: bool):
    log = logging.getLogger("gramtools_tpu")
    if not log.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        log.addHandler(handler)
    log.setLevel(logging.DEBUG if debug else logging.INFO)


def _common_parser() -> argparse.ArgumentParser:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--debug", help="Run in debug mode", action="store_true")
    common.add_argument("--force", help="Overwrite an existing output directory",
                        action="store_true")
    return common


def root_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="gramtools-tpu")
    subparsers = parser.add_subparsers(title="subcommands", dest="subparser_name",
                                      metavar="{build, genotype, discover, simulate}")
    common = _common_parser()
    _setup_build(common, subparsers)
    _setup_genotype(common, subparsers)
    _setup_discover(common, subparsers)
    _setup_simulate(common, subparsers)
    return parser


def _setup_build(common, subparsers):
    parser = subparsers.add_parser("build", parents=[common])
    parser.add_argument("-o", "--gram_dir", required=True,
                        help="Directory containing the built prg.")
    parser.add_argument("--ref", "--reference", dest="reference", required=True,
                        help="Reference genome fasta, can be gzipped.")
    variation = parser.add_mutually_exclusive_group(required=True)
    variation.add_argument("--vcf", nargs="+", action="append",
                           help="File(s) containing variant information.")
    variation.add_argument("--prgs_bed", type=str,
                           help="Bed file of variant regions (MSA or .prg per region)")
    variation.add_argument("--prg", type=str, help="Use an already-constructed prg")
    parser.add_argument("--kmer_size", type=int, default=10,
                        help="Kmer size for indexing the prg (max 14).")
    parser.add_argument("--max_threads", type=int, default=1)
    parser.add_argument("--no_vcf_clustering", action="store_true",
                        help=argparse.SUPPRESS)


def _setup_genotype(common, subparsers):
    parser = subparsers.add_parser("genotype", parents=[common])
    parser.add_argument("-i", "--gram_dir", required=True,
                        help="Directory containing the built prg")
    parser.add_argument("-o", "--genotype_dir", required=True,
                        help="Directory to hold this command's outputs.")
    parser.add_argument("--reads", required=True, nargs="+", action="append",
                        help="One or more read files (fasta/fastq, optionally gzipped)")
    parser.add_argument("--sample_id", required=True,
                        help="Name of the sample currently genotyped")
    parser.add_argument("--ploidy", choices=["haploid", "diploid"],
                        default="haploid")
    parser.add_argument("--max_threads", type=int, default=1)
    parser.add_argument("--seed", type=int, default=None,
                        help="Fixes seed for mapped read selection")
    parser.add_argument("--engine", choices=["host", "device", "auto"],
                        default="auto",
                        help="Mapping engine: 'host' (scalar, reference "
                        "semantics), 'device' (batched JAX search on "
                        "the GPU, host fallback for edge cases), or "
                        "'auto' (device when an accelerator backend is "
                        "present, host otherwise)")


def _setup_discover(common, subparsers):
    parser = subparsers.add_parser("discover", parents=[common])
    parser.add_argument("-i", "--genotype_dir", required=True,
                        help="Directory of a previous genotype run")
    parser.add_argument("-o", "--discovery_dir", required=True,
                        help="Directory to hold this command's outputs")
    parser.add_argument("--discov_vcf", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--caller", choices=("native", "cortex"),
                        default="native",
                        help="Variant caller: built-in pileup caller "
                             "(default) or py-cortex-api if installed")
    parser.add_argument("--mem_height", type=int, default=argparse.SUPPRESS,
                        help=argparse.SUPPRESS)


def _setup_simulate(common, subparsers):
    parser = subparsers.add_parser("simulate", parents=[common])
    parser.add_argument("--prg", required=True, help="A prg built with build")
    parser.add_argument("-o", "--output_dir", default=".")
    parser.add_argument("-n", "--max_num_paths", type=int, default=100,
                        help="Number of paths through the prg to simulate")
    parser.add_argument("--sample_id", default="sim",
                        help="Name for the output files")
    parser.add_argument("-i", "--induce_genotypes", default="",
                        help="Fasta of sequences to thread through the prg")
    parser.add_argument("--seed", type=int, default=None,
                        help="Fixes seed for random path sampling")


def run(argv=None):
    parser = root_parser()
    args = parser.parse_args(argv)
    if args.subparser_name is None:
        parser.print_help()
        return 1
    _setup_logging(args.debug)

    if args.subparser_name == "build":
        from .commands import build_command
        build_command.run(args)
    elif args.subparser_name == "genotype":
        from .commands import genotype_command
        genotype_command.run(args)
    elif args.subparser_name == "discover":
        from .commands import discover_command
        discover_command.run(args)
    elif args.subparser_name == "simulate":
        from .commands import simulate_command
        simulate_command.run(args)
    return 0


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()

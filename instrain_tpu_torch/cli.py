"""
Command-line interface of the port: the `profile` subcommand of
instrain_tpu's CLI (reference: inStrain/argumentParser.py:55-398), with
the same flags plus --device. Flags whose feature is not ported yet are
accepted by the parser and raise an error that names the ROADMAP.md item
(profile/pipeline.py:check_supported); none is ignored.

    instrain_tpu_torch profile BAM FASTA -o OUT --device cuda \\
        --skip_genome_wide --skip_plot_generation
"""

from __future__ import annotations

import argparse
import sys

from . import __version__
from .config import ProfileConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="instrain_tpu_torch",
        description="Strain-level metagenome profiling on an NVIDIA GPU "
                    "(PyTorch/CUDA port of instrain_tpu)")
    sub = parser.add_subparsers(dest="operation")

    p = sub.add_parser(
        "profile",
        help="BAM + FASTA -> strain profile (SNVs, linkage, scaffold "
             "metrics)",
        description="Read filtering -> pileup -> site-stats and rarefied "
                    "clonality kernels -> SNV/scaffold/linkage tables.")
    p.add_argument("bam", help="sorted BAM/SAM mapping")
    p.add_argument("fasta", help="FASTA the reads were mapped to")
    p.add_argument("-o", "--output", default="inStrain",
                   help="output profile directory (default: fasta "
                        "basename)")
    p.add_argument("--use_full_fasta_header", action="store_true",
                   help="key scaffolds by the whole FASTA header line, "
                        "not the first word")
    p.add_argument("--force_compress", action="store_true",
                   help="gzip all output tables")

    g = p.add_argument_group("SYSTEM PARAMETERS")
    g.add_argument("-p", "--processes", default=6, type=int,
                   help="host threads for the native BAM decoder")
    g.add_argument("-d", "--debug", action="store_true", default=False,
                   help="write a runtime/failure summary to "
                        "<out>/log/runtime_summary.txt")
    g.add_argument("--version", action="version",
                   version=f"instrain_tpu_torch version {__version__}")
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the site-stats kernels run: cuda (needs a "
                        "GPU; no fallback) or cpu (their plain PyTorch "
                        "versions)")

    g = p.add_argument_group("READ FILTERING OPTIONS")
    g.add_argument("-l", "--min_read_ani", default=0.95, type=float,
                   help="minimum read-pair identity (1 - NM/length, "
                        "strictly greater) for a pair to count")
    g.add_argument("--min_mapq", default=-1, type=int,
                   help="minimum mapQ of the better mate (strictly "
                        "greater)")
    g.add_argument("--max_insert_relative", default=3, type=float,
                   help="max insert size as a multiple of the median "
                        "insert across all pairs")
    g.add_argument("--min_insert", default=50, type=int,
                   help="minimum insert size")
    g.add_argument("--pairing_filter", default="paired_only",
                   choices=["paired_only", "non_discordant", "all_reads"],
                   help="which reads enter profiling")
    g.add_argument("--priority_reads", default=None,
                   help="fastq(.gz) or list of read names exempt from "
                        "the pairing filter")
    g.add_argument("--maximum_reads", default=None, type=int,
                   help="deterministic template-level subsample to "
                        "about this many records before profiling")
    g.add_argument("--detailed_mapping_info", action="store_true",
                   default=False,
                   help="also store a per-read filter report")

    g = p.add_argument_group("VARIANT CALLING OPTIONS")
    g.add_argument("-c", "--min_cov", default=5, type=int,
                   help="minimum coverage for a position to be "
                        "variant-callable")
    g.add_argument("-f", "--min_freq", default=0.05, type=float,
                   help="minimum allele frequency for a base to be "
                        "'present'")
    g.add_argument("-fdr", "--fdr", default=1e-6, type=float,
                   help="null-model false discovery rate")
    g.add_argument("--null_model", default="analytic",
                   help="'analytic' (exact binomial) or the path to an "
                        "inStrain-format NullModel.txt")

    p.add_argument("-g", "--gene_file", default=None,
                   help="genes to profile (not ported yet: raises)")
    p.add_argument("-s", "--stb", nargs="*", default=[],
                   help="scaffold-to-bin file(s) (used by "
                        "--min_genome_coverage)")
    p.add_argument("--mm_level", action="store_true", default=False,
                   help="accepted for compatibility; the port's profile "
                        "tables are the non-redundant view")
    p.add_argument("--skip_mm_profiling", action="store_true",
                   default=False,
                   help="collapse the read-mismatch axis (all reads "
                        "count at level 0)")

    g = p.add_argument_group("PROFILE OPTIONS")
    g.add_argument("--database_mode", action="store_true",
                   help="preset for huge references: min_read_ani 0.92, "
                        "skip_mm_profiling, min_genome_coverage 1")
    g.add_argument("--min_scaffold_reads", default=1, type=int,
                   help="minimum mapped pairs for a scaffold to be "
                        "profiled")
    g.add_argument("--min_genome_coverage", default=0, type=float,
                   help="skip genomes below this estimated coverage "
                        "(needs -s)")
    g.add_argument("--min_snp", default=20, type=int,
                   help="minimum connecting read pairs to compute linkage "
                        "for an SNV pair")
    g.add_argument("--store_everything", action="store_true",
                   help="also store raw pileup counts and linkage capture")
    g.add_argument("--scaffolds_to_profile", default=None,
                   help="file listing the only scaffolds to profile")
    g.add_argument("--rarefied_coverage", default=50, type=int,
                   help="subsample depth for rarefied nucleotide "
                        "diversity")
    g.add_argument("--window_length", default=10000, type=int,
                   help="genome window size for linkage")
    g.add_argument("--skip_genome_wide", action="store_true",
                   help="do not aggregate to genome_info (required: "
                        "genome-wide aggregation is not ported yet)")
    g.add_argument("--skip_plot_generation", action="store_true",
                   help="do not draw the figures (required: plots are "
                        "not ported yet)")
    g.add_argument("--engine", default="auto",
                   choices=["auto", "dense", "hybrid", "batch", "pallas"],
                   help="kernel path: dense (site stats on the device, "
                        "dense outputs to the host), hybrid (plus the "
                        "device compaction, so only table-ready outputs "
                        "come back; a scaffold whose padded M x L exceeds "
                        "2^27 cells runs dense), batch (hybrid over chunks "
                        "of many scaffolds per launch), or auto: on "
                        "--device cuda batch from 16 kept scaffolds on and "
                        "hybrid below, dense on --device cpu (pallas is "
                        "not ported: use dense)")
    g.add_argument("--mesh_devices", default=0, type=int,
                   help="multi-GPU sharding (not ported yet: raises "
                        "above 1)")
    g.add_argument("--distributed", action="store_true",
                   help="multi-host run (not ported yet: raises)")
    return parser


def profile_config_from_args(args) -> ProfileConfig:
    cfg = ProfileConfig(
        output=args.output, use_full_fasta_header=args.use_full_fasta_header,
        force_compress=args.force_compress, processes=args.processes,
        database_mode=args.database_mode,
        min_scaffold_reads=args.min_scaffold_reads,
        min_genome_coverage=args.min_genome_coverage,
        min_snp=args.min_snp, store_everything=args.store_everything,
        scaffolds_to_profile=args.scaffolds_to_profile,
        rarefied_coverage=args.rarefied_coverage,
        window_length=args.window_length,
        skip_genome_wide=args.skip_genome_wide,
        skip_plot_generation=args.skip_plot_generation,
        skip_mm_profiling=args.skip_mm_profiling, mm_level=args.mm_level,
        gene_file=args.gene_file, stb=args.stb,
        detailed_mapping_info=args.detailed_mapping_info,
        debug=args.debug, engine=args.engine,
        mesh_devices=args.mesh_devices, device=args.device)
    cfg.filter.min_read_ani = args.min_read_ani
    cfg.filter.min_mapq = args.min_mapq
    cfg.filter.max_insert_relative = args.max_insert_relative
    cfg.filter.min_insert = args.min_insert
    cfg.filter.pairing_filter = args.pairing_filter
    cfg.filter.priority_reads = args.priority_reads
    cfg.filter.maximum_reads = args.maximum_reads
    cfg.variant.min_cov = args.min_cov
    cfg.variant.min_freq = args.min_freq
    cfg.variant.fdr = args.fdr if args.fdr != 0 else 1e-6
    cfg.variant.null_model = args.null_model
    return cfg


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.operation is None:
        parser.print_help()
        return 0

    from .obs.logging import setup_logger
    from .profile.pipeline import check_supported, profile, unported
    from .store.profile_dir import ProfileDir

    if args.distributed:
        raise unported("--distributed", "item 7: multiple GPUs and hosts")
    cfg = profile_config_from_args(args)
    check_supported(cfg)
    output = args.output
    if output == "inStrain":
        output = args.fasta.split(".")[0].split("/")[-1]
    cfg.output = output
    isdir = ProfileDir(output)
    setup_logger(isdir.get_location("log") + "log.log")
    profile(args.bam, args.fasta, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())

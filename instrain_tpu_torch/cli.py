"""
Command-line interface of the port: every subcommand of instrain_tpu's
CLI (reference: inStrain/argumentParser.py:55-398) with the same flags
and defaults, plus --device where kernels run; no flag is ignored.
profile --mesh_devices N shards the kernels over N cards (or N shards of
the CPU), and profile --distributed runs one process of several, as
torchrun starts them:

    python -m torch.distributed.run --nproc_per_node 2 \
        -m instrain_tpu_torch.cli profile BAM FASTA -o OUT.IS --distributed

    instrain_tpu_torch profile BAM FASTA -o OUT.IS -s STB --device cuda
    instrain_tpu_torch compare -i A.IS B.IS -o OUT.RC -s STB --device cuda
    instrain_tpu_torch genome_wide -i OUT.IS -s STB
    instrain_tpu_torch profile_genes -i OUT.IS -g GENES.fna
    instrain_tpu_torch parse_annotations -i A.IS B.IS -a ANNO.csv -o OUT
    instrain_tpu_torch plot -i OUT.IS [-pl 1 3] [-g GENOME] [-mb 0.5]
    instrain_tpu_torch quick_profile BAM FASTA -s STB -o OUT
    instrain_tpu_torch filter_reads BAM FASTA -o OUT
    instrain_tpu_torch other --run_statistics OUT.IS | --old_IS PICKLE
    instrain_tpu_torch check_deps

plot, quick_profile, filter_reads, other and check_deps run on the host
only (matplotlib, numpy, pandas): they take no --device.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import __version__
from .config import CompareConfig, ProfileConfig


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

    add_system(p)
    add_device(p)
    add_readfilter(p)
    add_variant(p)

    p.add_argument("-g", "--gene_file", default=None,
                   help="prodigal .fna / GenBank genes file: also profile "
                        "each gene (coverage, diversity, SNV types, "
                        "dN/dS) on the host")
    add_stb(p)
    add_mm(p)

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
                   help="do not aggregate to genome_info at the end")
    g.add_argument("--skip_plot_generation", action="store_true",
                   help="do not draw the figures (a plotting failure, "
                        "such as a missing matplotlib, is logged and the "
                        "run goes on)")
    g.add_argument("--engine", default="auto",
                   choices=["auto", "dense", "hybrid", "batch", "pallas"],
                   help="kernel path: dense (site stats on the device, "
                        "dense outputs to the host), hybrid (plus the "
                        "device compaction, so only table-ready outputs "
                        "come back; a scaffold whose padded M x L exceeds "
                        "2^27 cells runs dense), batch (hybrid over chunks "
                        "of many scaffolds per launch), pallas (the "
                        "dense engine with clonality rounded as the JAX "
                        "package's Pallas core rounds it; hybrid under a "
                        "mesh), or auto: on --device cuda batch from 16 "
                        "kept scaffolds on and hybrid below, dense on "
                        "--device cpu")
    g.add_argument("--mesh_devices", default=0, type=int,
                   help="shard the profile kernels over N cards of a 1-D "
                        "mesh (hybrid: each scaffold's positions; batch: "
                        "its chunks), the cards LOCAL_RANK*N ... "
                        "LOCAL_RANK*N+N-1 under torchrun, else N from the "
                        "current one; raises if they do not exist. On "
                        "--device cpu, N shards of the CPU. 0 = one device")
    g.add_argument("--distributed", action="store_true",
                   help="one process of a multi-process run (torchrun's "
                        "RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; gloo): "
                        "each process decodes and profiles only the "
                        "scaffolds it owns (ranged through the .bai with "
                        "paired_only), the results meet in one gather, and "
                        "process 0 writes the profile. The card is "
                        "cuda:LOCAL_RANK where it is set")

    p = sub.add_parser(
        "compare",
        help="compare >=2 profiles mapped to the same FASTA "
             "(popANI/conANI, clustering, pooling)",
        description="Pairwise scaffold comparisons between profiles: "
                    "coverage overlap (the overlap_counts kernel), "
                    "conANI/popANI per mm level, genome rollup, strain "
                    "clustering, SNV pooling.")
    p.add_argument("-i", "--input", nargs="*", required=True,
                   help="two or more profile directories (same FASTA)")
    p.add_argument("-o", "--output", default="instrainComparer",
                   help="output comparison directory")
    add_system(p)
    add_device(p)
    add_stb(p)
    add_variant(p)
    g = p.add_argument_group("OTHER OPTIONS")
    g.add_argument("--database_mode", action="store_true",
                   help="only compare scaffolds of genomes detected "
                        "(breadth_minCov >= --breadth) in each profile")
    g.add_argument("--breadth", default=0.5, type=float,
                   help="genome breadth_minCov needed for database_mode")
    g.add_argument("-sc", "--scaffolds", default=None,
                   help="file listing the only scaffolds to compare")
    g.add_argument("--genome", default=None,
                   help="only compare scaffolds of this genome (needs -s)")
    g.add_argument("--store_coverage_overlap", action="store_true",
                   help="store the per-pair coverage-overlap arrays")
    g.add_argument("--store_mismatch_locations", action="store_true",
                   help="store every pairwise SNP location")
    g.add_argument("--include_self_comparisons", action="store_true",
                   help="also compare each profile against itself")
    g.add_argument("--skip_plot_generation", action="store_true",
                   help="do not draw the dendrogram figure (drawn with "
                        "-s)")
    g.add_argument("--group_length", default=10000000, type=int,
                   help="genome bp per comparison batch (bounds RAM)")
    g.add_argument("--force_compress", action="store_true",
                   help="gzip all output tables")
    g.add_argument("-ani", "--ani_threshold", default=0.99999, type=float,
                   help="popANI threshold for strain clustering")
    g.add_argument("-cov", "--coverage_treshold", default=0.1, type=float,
                   help="minimum percent_compared for clustering edges")
    g.add_argument("--clusterAlg", default="average",
                   choices=["single", "complete", "average", "weighted",
                            "centroid", "median", "ward"],
                   help="scipy hierarchy linkage method")
    g.add_argument("-bams", "--bams", nargs="*", default=[],
                   help="the profiles' BAMs (same order as -i): enables "
                        "cross-sample SNV pooling")
    g.add_argument("--skip_popANI", action="store_true",
                   help="stop after coverage overlap (no SNP comparing)")
    g.add_argument("--engine", default="auto",
                   choices=["auto", "host", "device"],
                   help="overlap-count engine: device = the overlap_counts "
                        "kernel on --device (its plain version on cpu), "
                        "host = numpy popcount (the same integers); auto "
                        "takes the kernel on cuda from n^2 * Mg * L >= "
                        "2^33 on")

    p = sub.add_parser(
        "genome_wide",
        help="(re)aggregate scaffold metrics to genomes (incl. iRep)",
        description="Roll scaffold profiles up to genome_info using a "
                    "scaffold-to-bin mapping.")
    p.add_argument("-i", "--IS", required=True,
                   help="an existing profile directory")
    # accepted but unused, as in the reference (argumentParser.py:287-298)
    p.add_argument("--store_everything", action="store_true")
    add_stb(p)
    add_mm(p)
    add_system(p)

    p = sub.add_parser(
        "profile_genes",
        help="(re)run gene profiling over an existing profile",
        description="Load covT/clonT/SNVs from a stored profile and "
                    "compute per-gene metrics for -g (on the host).")
    p.add_argument("-i", "--IS", required=True,
                   help="an existing profile directory")
    p.add_argument("-g", "--gene_file", default=None,
                   help="prodigal .fna / GenBank genes file")
    p.add_argument("--store_everything", action="store_true",
                   help="store extra per-gene intermediates")
    add_system(p)

    p = sub.add_parser(
        "parse_annotations",
        help="aggregate per-gene annotations across samples",
        description="Combine gene annotation CSVs (gene,anno) with "
                    "profiled gene abundances into per-sample annotation "
                    "tables.")
    p.add_argument("-i", "--input", nargs="*", required=True,
                   help="profile directories (with genes profiled)")
    p.add_argument("-a", "--annotations", nargs="*", required=True,
                   help="gene annotation CSVs (columns: gene, anno)")
    p.add_argument("-o", "--output", default="annotation_output",
                   help="output directory")
    add_system(p)
    p.add_argument("-b", "--min_genome_breadth", default=0.5, type=float,
                   help="skip genes of genomes below this breadth")
    p.add_argument("-g", "--min_gene_breadth", default=0.8, type=float,
                   help="skip genes below this breadth")
    p.add_argument("--store_rawdata", action="store_true",
                   help="also store the gene -> annotations dictionary")

    p = sub.add_parser(
        "plot",
        help="draw the numbered figures from a profile",
        description="Generate figures 1-10 (or a subset) as PDFs under "
                    "<profile>/figures/ (host matplotlib).")
    p.add_argument("-i", "--IS", required=True,
                   help="an existing profile (or compare) directory")
    p.add_argument("-pl", "--plots", nargs="*", default="a",
                   help="plot numbers to draw, or 'a' for all")
    p.add_argument("-mb", "--minimum_breadth", default=0.5, type=float,
                   help="skip genomes below this breadth")
    p.add_argument("-g", "--genomes", nargs="*", default=None,
                   help="only plot these genomes")
    add_system(p)

    p = sub.add_parser(
        "quick_profile",
        help="fast coverage/breadth screen (no variant calling)",
        description="Coverage pass of the native decoder producing "
                    "per-genome coverage/breadth and scaffold lists (the "
                    "coverM workflow, without coverM).")
    p.add_argument("bam", help="sorted BAM mapping")
    p.add_argument("fasta", help="FASTA the reads were mapped to")
    add_stb(p)
    p.add_argument("-o", "--output", default="QuickProfile",
                   help="output directory")
    p.add_argument("--breadth_cutoff", default=0.5, type=float,
                   help="genome breadth to be listed in the output")
    p.add_argument("--stringent_breadth_cutoff", default=0.0, type=float,
                   help="per-scaffold breadth prefilter (0 = off)")
    add_system(p)

    p = sub.add_parser(
        "filter_reads",
        help="standalone read-filtering report",
        description="Run only the read filter and write mapping_info.csv.")
    p.add_argument("bam", help="sorted BAM mapping")
    p.add_argument("fasta", help="FASTA the reads were mapped to")
    p.add_argument("-o", "--output", default="filter_reads_output",
                   help="output directory")
    add_system(p)
    add_readfilter(p)

    p = sub.add_parser(
        "other",
        help="utilities: legacy-profile conversion, runtime reports",
        description="Maintenance utilities over existing outputs.")
    p.add_argument("--old_IS", default=None,
                   help="convert a v0.x pickle profile to the current "
                        "directory format (unpickles it: trusted files "
                        "only)")
    p.add_argument("--run_statistics", default=None,
                   help="profile directory or log file: print the "
                        "runtime/failure report")
    add_system(p)

    sub.add_parser(
        "check_deps",
        help="print dependency/device health",
        description="Report versions, the CUDA devices, nvcc, and whether "
                    "the CUDA kernels and the native decoder are built "
                    "for this checkout's sources (builds nothing).")
    return parser


def add_system(p):
    g = p.add_argument_group("SYSTEM PARAMETERS")
    g.add_argument("-p", "--processes", default=6, type=int,
                   help="host threads for the native BAM decoder")
    g.add_argument("-d", "--debug", action="store_true", default=False,
                   help="write a runtime/failure summary to "
                        "<out>/log/runtime_summary.txt")
    g.add_argument("--version", action="version",
                   version=f"instrain_tpu_torch version {__version__}")


def add_device(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the kernels run: cuda (needs a GPU; no "
                        "fallback) or cpu (their plain PyTorch versions)")


def add_readfilter(p):
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


def add_stb(p):
    p.add_argument("-s", "--stb", nargs="*", default=[],
                   help="scaffold-to-bin file(s) (tsv) or genome fastas; "
                        "default treats all scaffolds as one genome")


def add_mm(p):
    p.add_argument("--mm_level", action="store_true", default=False,
                   help="emit genome tables at every mismatch level "
                        "instead of the non-redundant view")
    p.add_argument("--skip_mm_profiling", action="store_true",
                   default=False,
                   help="collapse the read-mismatch axis (all reads "
                        "count at level 0)")


def add_variant(p):
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


def select_local_cards(device: str, mesh_devices: int) -> None:
    """Under torchrun (LOCAL_RANK set) on --device cuda, make this
    process's first card current: cuda:LOCAL_RANK, or with --mesh_devices
    N the first of cards LOCAL_RANK*N ... LOCAL_RANK*N+N-1 (the mesh takes
    N cards from the current one on). Raises if those cards do not exist;
    never shares or wraps."""
    local = os.environ.get("LOCAL_RANK")
    if local is None or device != "cuda":
        return
    import torch
    n = max(mesh_devices, 1)
    first = int(local) * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if first + n > have:
        raise ValueError(f"need {first + n} devices, have {have}")
    torch.cuda.set_device(first)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.operation is None:
        parser.print_help()
        return 0

    from .obs.logging import setup_logger
    from .store.profile_dir import ProfileDir

    if args.operation == "profile":
        from .parallel import distributed
        from .profile.pipeline import check_supported, profile, writes_profile
        cfg = profile_config_from_args(args)
        check_supported(cfg)
        select_local_cards(args.device, args.mesh_devices)
        output = args.output
        if output == "inStrain":
            output = args.fasta.split(".")[0].split("/")[-1]
        cfg.output = output
        if args.distributed:
            distributed.init_distributed()
        try:
            if writes_profile(cfg):
                isdir = ProfileDir(output)
                setup_logger(isdir.get_location("log") + "log.log")
            else:
                setup_logger(None)      # a peer of process 0: console
            profile(args.bam, args.fasta, cfg)
        finally:
            distributed.shutdown_distributed()

    elif args.operation == "compare":
        from .compare.pipeline import check_supported, compare
        cfg = CompareConfig(
            output=args.output, processes=args.processes, stb=args.stb,
            min_cov=args.min_cov, min_freq=args.min_freq, fdr=args.fdr,
            null_model=args.null_model, database_mode=args.database_mode,
            breadth=args.breadth, scaffolds=args.scaffolds,
            genome=args.genome,
            store_coverage_overlap=args.store_coverage_overlap,
            store_mismatch_locations=args.store_mismatch_locations,
            include_self_comparisons=args.include_self_comparisons,
            skip_plot_generation=args.skip_plot_generation,
            group_length=args.group_length,
            force_compress=args.force_compress,
            ani_threshold=args.ani_threshold,
            coverage_treshold=args.coverage_treshold,
            clusterAlg=args.clusterAlg, bams=args.bams or [],
            skip_popANI=args.skip_popANI, engine=args.engine,
            device=args.device)
        check_supported(cfg)
        out = ProfileDir(args.output)
        setup_logger(out.get_location("log") + "log.log")
        compare(args.input, cfg)

    elif args.operation == "genome_wide":
        from .profile.genome import genome_wide
        isdir = ProfileDir(args.IS)
        setup_logger(isdir.get_location("log") + "log.log")
        genome_wide(isdir, stb=args.stb, mm_level=args.mm_level,
                    skip_mm_profiling=args.skip_mm_profiling)

    elif args.operation == "profile_genes":
        from .profile.genes import profile_genes_from_store
        isdir = ProfileDir(args.IS)
        setup_logger(isdir.get_location("log") + "log.log")
        profile_genes_from_store(isdir, args.gene_file,
                                 store_everything=args.store_everything)

    elif args.operation == "parse_annotations":
        from .compare.annotations import parse_annotations
        parse_annotations(args.input, args.annotations, args.output,
                          min_genome_breadth=args.min_genome_breadth,
                          min_gene_breadth=args.min_gene_breadth,
                          store_rawdata=args.store_rawdata)

    elif args.operation == "plot":
        from .plotting.controller import make_plots
        isdir = ProfileDir(args.IS)
        setup_logger(isdir.get_location("log") + "log.log")
        make_plots(isdir, plots=args.plots, genomes=args.genomes,
                   minimum_breadth=args.minimum_breadth)

    elif args.operation == "quick_profile":
        from .profile.quick_profile import quick_profile
        quick_profile(args.bam, args.fasta, stb=args.stb,
                      output=args.output,
                      breadth_cutoff=args.breadth_cutoff,
                      stringent_breadth_cutoff=args.stringent_breadth_cutoff,
                      threads=args.processes)

    elif args.operation == "filter_reads":
        filter_reads_report(args)

    elif args.operation == "other":
        if args.run_statistics:
            from .obs.logging import report_run_stats
            logloc = args.run_statistics
            if os.path.isdir(logloc):
                logloc = os.path.join(logloc, "log", "log.log")
            report_run_stats(logloc)
        if args.old_IS:
            from .store.legacy import convert_legacy_profile
            convert_legacy_profile(args.old_IS)

    elif args.operation == "check_deps":
        print(gen_dependency_report())
    return 0


def filter_reads_report(args) -> None:
    """filter_reads: decode, filter and write <output>/mapping_info.csv
    (instrain_tpu/cli.py:475-492)."""
    from .config import ReadFilterConfig
    from .io import fasta as fasta_io
    from .io.bam import decode_bam
    from .profile.filter_reads import filter_reads, write_mapping_info
    os.makedirs(args.output, exist_ok=True)
    seqs = fasta_io.read_fasta(args.fasta)
    bam = decode_bam(args.bam, ref_seqs=seqs, threads=args.processes,
                     baq=False)
    fcfg = ReadFilterConfig(
        min_read_ani=args.min_read_ani, min_mapq=args.min_mapq,
        max_insert_relative=args.max_insert_relative,
        min_insert=args.min_insert, pairing_filter=args.pairing_filter,
        priority_reads=args.priority_reads)
    ps = filter_reads(bam, fcfg, scaffolds=list(seqs.keys()))
    write_mapping_info(ps.mapping_info,
                       os.path.join(args.output, "mapping_info.csv"),
                       ps.filter_values)


def gen_dependency_report() -> str:
    """The port's version, its host packages, the CUDA devices, nvcc, and
    whether each native library is built for this checkout's sources
    (reference: utils.gen_dependency_report, utils.py:35-94). Builds
    nothing and imports no jax."""
    from . import build
    lines = [f"instrain_tpu_torch version {__version__}"]
    for mod in ["torch", "numpy", "pandas", "scipy", "h5py", "matplotlib"]:
        try:
            m = __import__(mod)
        except ImportError:
            lines.append(f"{mod:12s} MISSING")
            continue
        extra = ""
        if mod == "torch":
            extra = f", CUDA build {m.version.cuda or 'none (CPU only)'}"
        lines.append(f"{mod:12s} OK (version "
                     f"{getattr(m, '__version__', '?')}{extra})")
    try:
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        lines.append(f"CUDA available: {torch.cuda.is_available()} "
                     f"({n} device(s))")
        lines += [f"CUDA device {i}: {torch.cuda.get_device_name(i)}"
                  for i in range(n)]
    except ImportError:
        lines.append("CUDA available: False (no torch)")
    nvcc = build._nvcc()
    lines.append(f"nvcc: {nvcc or 'MISSING (the CUDA kernels cannot be '
                                   'built)'}")
    built = build.built_libraries()
    for name, what in (("instrain_kernels", "CUDA kernels"),
                       ("instrain_io", "native decoder")):
        path = built[name]
        lines.append(f"{what} ({name}): " + (
            f"built for the current sources ({path})" if path else
            "not built for the current sources (builds at first use)"))
    return "\n".join(lines)


if __name__ == "__main__":
    sys.exit(main())

"""
The `profile` operation: BAM + FASTA -> profile directory — the
counterpart of instrain_tpu/profile/pipeline.py, single process, with the
dense, hybrid and batch engines.

Steps (reference: controller.py:144-169): decode the BAM natively, filter
read pairs, then per scaffold build the pileup counts, run the site-stats
and rarefied-clonality kernels on the chosen device (cfg.device) — and,
with the hybrid and batch engines, the device compaction (K4), so that
only table-ready outputs come back; the batch engine (K5) runs many
scaffolds per launch, the hybrid engine one — build the SNV, scaffold
and linkage tables on the host (linkage of scaffolds with many captured
pairs through the device LD kernel, K6), store the profile directory and
its TSVs, and (unless --skip_genome_wide) roll the scaffolds up to
genomes (profile/genome.py). With -g, each scaffold's genes are profiled
on the host from what its engine brought back (profile/genes.py), inside
the tables step. Unless --skip_plot_generation, the figures are drawn
from the stored profile at the end (plotting/controller.py: host
matplotlib, no device work); a plotting failure is logged and the run
goes on.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import torch

from ..config import ProfileConfig
from ..io import fasta as fasta_io
from ..io.bam import decode_bam
from ..kernels.cuda_sitestats import KernelError
from ..obs.logging import (get_worker_log, log_checkpoint, log_failure,
                           report_run_stats)
from ..store import generate as gen
from ..store.profile_dir import ProfileDir
from . import compact as compact_mod
from . import genes as genes_mod
from . import genome as genome_mod
from . import linkage as linkage_mod
from . import tables
from .filter_reads import filter_reads
from .pileup import (ScaffoldStats, _bucket, build_scaffold_pileup,
                     make_luts, run_site_stats)

# Phase accounting: set to a dict ({} works) to accumulate wall seconds
# per phase (decode, filter, pileup, kernels, tables, store, genome,
# plots) of a profile run, and in "genes" the gene file's parse and the
# gene calls (the calls lie inside "tables"); None adds no timers.
# chip_smoke.py reads it.
PHASES: Optional[Dict[str, float]] = None


class _phase:
    """Context manager accumulating wall seconds into PHASES[key]."""

    def __init__(self, key: str):
        self.key = key

    def __enter__(self):
        if PHASES is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if PHASES is not None:
            PHASES[self.key] = (PHASES.get(self.key, 0.0) +
                                time.perf_counter() - self.t0)
        return False


def unported(what: str, item: str) -> NotImplementedError:
    """The error for an option this port does not implement yet."""
    return NotImplementedError(
        f"{what} is not ported to instrain_tpu_torch yet "
        f"(ROADMAP.md Queue 1, {item})")


def check_supported(cfg: ProfileConfig) -> None:
    """Raise for every option of `profile` that this port does not run,
    instead of ignoring it."""
    if cfg.engine not in ("auto", "dense", "hybrid", "batch"):
        # not a missing module: the Pallas TPU core has its Hopper
        # counterpart in the dense engine's site_stats kernel
        raise NotImplementedError(
            f"--engine {cfg.engine} is the JAX package's Pallas TPU path; "
            f"its counterpart here is --engine dense (ROADMAP.md, Queue "
            f"2: K1)")
    if cfg.mesh_devices and cfg.mesh_devices > 1:
        raise unported("--mesh_devices", "item 7: multiple GPUs and hosts")


def resolve_device(name: str) -> torch.device:
    """cfg.device -> torch.device. "cuda" needs a GPU: no CPU fallback."""
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown device {name!r} (cuda or cpu)")


# The hybrid and batch engines hold a scaffold's whole padded [Mp, 4, Lp]
# working set on the device in one launch; above this many padded cells
# the JAX package sends the scaffold to the position-chunked dense engine
# (instrain_tpu/profile/pipeline.py:475-481, :584-594). The port keeps
# its bound, although the card holds more: the engine decides the clonR
# draws' keys on scaffolds over 1 Mb.
HYBRID_MAX_CELLS = 1 << 27


# --engine auto runs the batch engine on a GPU from this many kept
# scaffolds on (instrain_tpu/profile/pipeline.py:239-246)
BATCH_MIN_SCAFFOLDS = 16


def resolve_run_engine(cfg_engine: str, device: torch.device,
                       n_scaffolds: int) -> str:
    """The engine of a run of n_scaffolds kept scaffolds, as the JAX
    package picks it (pipeline.py:239-246, :255, :305-306): auto is dense
    on the CPU, and on a GPU batch from BATCH_MIN_SCAFFOLDS scaffolds on
    and hybrid below; batch with one scaffold runs hybrid."""
    engine = cfg_engine
    if engine == "auto":
        if device.type == "cpu":
            return "dense"
        engine = ("batch" if n_scaffolds >= BATCH_MIN_SCAFFOLDS
                  else "hybrid")
    if engine == "batch" and n_scaffolds <= 1:
        engine = "hybrid"
    return engine


# The int16 pileup builder of the JAX package's hybrid engine falls back
# to the unpadded int32 one when an exact-mm count exceeds this
# (instrain_tpu/profile/pileup.py:121-126)
INT16_MAX = 32767


def resolve_engine(cfg_engine: str, device: torch.device, M: int, L: int,
                   skip_mm: bool = False, counts=None) -> str:
    """The engine one scaffold of [M, L] runs outside the batch engine, as
    the JAX package picks it (pipeline.py:451-453, :458-481): auto is dense
    on the CPU and hybrid on a GPU; hybrid goes dense when the extent of
    the pileup the JAX package builds exceeds HYBRID_MAX_CELLS. That
    pileup is unpadded, M * L, under skip_mm (M is then 1) or when an
    exact-mm count of `counts` (the scaffold's [M, 4, L] pileup; only its
    max() is read, and only when the padded extent is over the bound)
    exceeds INT16_MAX; else padded, max(ceil8(M), 8) *
    max(ceil4096(L), 4096)."""
    engine = cfg_engine
    if engine == "auto":
        engine = "dense" if device.type == "cpu" else "hybrid"
    if engine != "hybrid":
        return engine
    cells = max(_bucket(M, 8), 8) * max(_bucket(L, 4096), 4096)
    if cells > HYBRID_MAX_CELLS and (
            skip_mm or (counts is not None and counts.max() > INT16_MAX)):
        cells = M * L
    return "dense" if cells > HYBRID_MAX_CELLS else engine


@dataclass
class ScaffoldProfileResult:
    name: str
    length: int
    stats: ScaffoldStats
    snp_table: pd.DataFrame
    cumulative_snv_table: pd.DataFrame
    cumulative_scaffold_table: pd.DataFrame
    linkage_table: pd.DataFrame
    gene_results: Optional[tuple] = None


def profile(bam_path: str, fasta_path: str, cfg: ProfileConfig,
            output: Optional[str] = None) -> ProfileDir:
    """Run the profile operation; returns the profile directory."""
    check_supported(cfg)
    device = resolve_device(cfg.device)
    cfg.apply_database_mode()
    isdir = ProfileDir(output or cfg.output)

    # per-run DEBUG file log (reference: controller.setup_logger writes
    # <out>/log/log.log)
    fh = logging.FileHandler(isdir.get_location("log") + "log.log")
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)-8s %(message)s",
        datefmt="%y-%m-%d %H:%M:%S"))
    root = logging.getLogger("")
    old_level = root.level
    if old_level > logging.DEBUG:
        root.setLevel(logging.DEBUG)
    root.addHandler(fh)
    try:
        return _profile_impl(bam_path, fasta_path, cfg, isdir, device)
    finally:
        root.removeHandler(fh)
        root.setLevel(old_level)
        fh.close()


def _profile_impl(bam_path: str, fasta_path: str, cfg: ProfileConfig,
                  isdir: ProfileDir, device: torch.device) -> ProfileDir:
    log_checkpoint("main_profile", "filter_reads", "start")
    registry = fasta_io.ScaffoldRegistry.from_fasta(
        fasta_path, window_length=cfg.window_length,
        use_full_header=cfg.use_full_fasta_header,
        scaffolds_to_profile=fasta_io.load_scaff_list(
            cfg.scaffolds_to_profile))
    ref_seqs = {n: fasta_io.CODE2BASE[np.minimum(registry.codes[n], 4)]
                for n in registry.names}
    with _phase("decode"):
        bam = decode_bam(bam_path, ref_seqs=ref_seqs,
                         threads=cfg.processes, baq=False)
    with _phase("filter"):
        if cfg.filter.maximum_reads:
            _subsample_bam(bam, cfg.filter.maximum_reads, cfg.seed)
        pairs = filter_reads(bam, cfg.filter, scaffolds=registry.names)

    # read-filtering results (reference: controller.py:260-322)
    with _phase("store"):
        _store_read_results(isdir, bam, pairs, bam_path, fasta_path,
                            registry, cfg)
    total_pairs = int(pairs.mapping_info["filtered_pairs"].iloc[0])
    if total_pairs == 0:
        raise RuntimeError(
            "No paired reads remain after filtering; consider "
            "--pairing_filter or --use_full_fasta_header")
    log_checkpoint("main_profile", "filter_reads", "end")

    # scaffold selection (reference: profile/fasta.py:87-136)
    log_checkpoint("main_profile", "profile_scaffolds", "start")
    s2p = pairs.scaffold2pairs
    keep = [n for n in registry.names
            if s2p.get(n, 0) >= cfg.min_scaffold_reads]
    if cfg.min_genome_coverage > 0:
        keep = _filter_genome_coverage(keep, registry, s2p,
                                       pairs.mean_pair_length, cfg)
    keep.sort(key=lambda n: s2p.get(n, 0), reverse=True)

    null_lut, freq_lut = make_luts(cfg.variant)
    null_t = torch.as_tensor(null_lut, dtype=torch.int32, device=device)
    freq_t = torch.as_tensor(freq_lut, dtype=torch.int32, device=device)

    gene_data = None
    if cfg.gene_file is not None:
        with _phase("genes"):
            gene_data = genes_mod.parse_genes(cfg.gene_file)

    engine = resolve_run_engine(cfg.engine, device, len(keep))
    if engine == "dense":
        finals = []
        for name in keep:
            logging.debug(get_worker_log("SplitProfile", name, "start"))
            res = _profile_one_scaffold(bam, pairs, registry, name, cfg,
                                        null_t, freq_t, device, gene_data)
            logging.debug(get_worker_log("SplitProfile", name, "end"))
            if res is not None:
                with _phase("tables"):
                    finals.append(_finalize_result(res, cfg))
    else:
        finals = _profile_scaffolds_compact(bam, pairs, registry, keep, cfg,
                                            engine, null_t, freq_t, device,
                                            gene_data)
    with _phase("store"):
        _store_results(isdir, finals, cfg, gene_data)
        log_checkpoint("main_profile", "profile_scaffolds", "end")
        # outputs (reference: controller.py:352-360)
        for t in ["SNVs", "scaffold_info", "linkage", "gene_info",
                  "mapping_info"]:
            gen.generate(isdir, t, force_compress=cfg.force_compress)
    if not cfg.skip_genome_wide:
        # instrain_tpu/profile/pipeline.py:391-396
        log_checkpoint("main_profile", "genome_wide", "start")
        with _phase("genome"):
            genome_mod.genome_wide(isdir, stb=cfg.stb, mm_level=cfg.mm_level,
                                   skip_mm_profiling=cfg.skip_mm_profiling)
        log_checkpoint("main_profile", "genome_wide", "end")
    if not cfg.skip_plot_generation:
        # instrain_tpu/profile/pipeline.py:398-403
        with _phase("plots"):
            try:
                from ..plotting.controller import make_plots
                make_plots(isdir, plots="a")
            except Exception as e:  # plots must never fail a profile run
                logging.error(f"Plotting failed: {e}")
    if cfg.debug:
        # runtime/failure report (reference: controller.py:121-129 +
        # logUtils.report_run_stats)
        logloc = isdir.get_location("log") + "log.log"
        report_run_stats(logloc, printToo=False,
                         output=isdir.get_location("log") +
                         "runtime_summary.txt")
    return isdir


def _store_read_results(isdir, bam, pairs, bam_path, fasta_path, registry,
                        cfg):
    isdir.store("object_type", "profile", "value",
                "Type of SNVprofile (profile or compare)")
    isdir.store("bam_loc", bam_path, "value", "Location of .bam file")
    isdir.store("mapping_info", pairs.mapping_info, "pandas",
                "Report on reads")
    isdir.store("mapping_info_values",
                {k: str(v) for k, v in pairs.filter_values.items()},
                "dictionary", "Filter values used for mapping_info")
    isdir.store("fasta_loc", fasta_path, "value",
                "Location of .fasta file used during profile")
    isdir.store("scaffold2length", registry.s2l, "dictionary",
                "Dictionary of scaffold 2 length")
    if cfg.detailed_mapping_info:
        from .filter_reads import detailed_mapping_info
        isdir.store("detailed_mapping_info",
                    detailed_mapping_info(pairs.info, pairs.passed,
                                          bam.ref_names, bam.qnames),
                    "pandas", "Details report on reads")
    rdic = pairs.rdic(skip_mm=cfg.skip_mm_profiling)
    isdir.store("Rdic", rdic,
                "pickle" if cfg.skip_mm_profiling else "dictionary",
                "list of filtered read pairs" if cfg.skip_mm_profiling
                else "Read pair -> mismatches")


def is_device_error(e: BaseException) -> bool:
    """A kernel fault or any CUDA runtime error: never contained."""
    if isinstance(e, (KernelError, torch.cuda.OutOfMemoryError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and "CUDA" in str(e)


def _contain(name: str, e: Exception) -> None:
    """Log a scaffold's failure and drop the scaffold (reference:
    profile_utilities.py:92-112 SplitException / MergeError); a kernel or
    CUDA fault is re-raised: it fails the run instead of hiding behind a
    dropped scaffold while the run exits 0."""
    if is_device_error(e):
        raise e
    log_failure("SplitException", name, str(e))
    logging.error(f"whole scaffold exception- {name}")


def _inject_failure(name: str, cfg) -> None:
    """The fault-injection hook of the per-scaffold engines (reference:
    FailureScaffoldHeaderTesting magic name, profile_utilities.py:
    137-139)."""
    if name == "FailureScaffoldHeaderTesting" and cfg.debug:
        raise AssertionError("injected failure for testing")


def _profile_one_scaffold(bam, pairs, registry, name, cfg, null_lut,
                          freq_lut, device, gene_data):
    """One scaffold through the dense engine, its failure contained."""
    try:
        return _profile_one_scaffold_inner(bam, pairs, registry, name, cfg,
                                           null_lut, freq_lut, device,
                                           gene_data)
    except Exception as e:
        _contain(name, e)
        return None


def _profile_one_scaffold_inner(bam, pairs, registry, name, cfg, null_lut,
                                freq_lut, device, gene_data):
    _inject_failure(name, cfg)
    rid = bam.name_to_ref_id.get(name)
    if rid is None:
        return None
    L = registry.length_of(name)
    with _phase("pileup"):
        pileup = _build_pileup(bam, pairs, rid, L, cfg)
        if pileup is None:
            return None
    ref_codes = registry.codes[name]
    with _phase("kernels"):
        stats = run_site_stats(pileup, ref_codes, null_lut, freq_lut,
                               min_cov=cfg.variant.min_cov,
                               rarefied_coverage=cfg.rarefied_coverage,
                               seed=cfg.seed, device=device)
    with _phase("tables"):
        return _result_from_stats(name, L, stats, ref_codes, cfg, device,
                                  gene_data)


def _build_pileup(bam, pairs, rid, L, cfg):
    """The scaffold's pileup; with skip_mm_profiling, its mm axis
    collapsed: every pair counts at level 0."""
    pileup = build_scaffold_pileup(bam, pairs, rid, L)
    if pileup is not None and cfg.skip_mm_profiling:
        pileup.counts = pileup.counts.sum(axis=0, keepdims=True,
                                          dtype=np.int32)
        pileup.mm_values = np.array([0])
        pileup.qid2mmidx = np.where(pileup.qid2mmidx >= 0, 0,
                                    -1).astype(np.int32)
    return pileup


def _oversize(pairs, rid, L, cfg) -> bool:
    """Whether the batch engine sends a scaffold to the position-chunked
    dense path, by the JAX package's estimate before the pileup is built
    (pipeline.py:584-594): max(ceil8(n_mm), 8) * max(ceil4096(L), 4096)
    padded cells over HYBRID_MAX_CELLS, with n_mm the distinct mm values
    of the scaffold's pairs; never with skip_mm_profiling."""
    if cfg.skip_mm_profiling:
        return False
    qids, mms = pairs.r2m_for_scaffold(rid)
    n_mm = len(np.unique(mms)) if len(qids) else 0
    return (max(_bucket(max(n_mm, 1), 8), 8) * max(_bucket(L, 4096), 4096)
            > HYBRID_MAX_CELLS)


def _profile_scaffolds_compact(bam, pairs, registry, keep, cfg, engine,
                               null_lut, freq_lut, device,
                               gene_data) -> List[Dict]:
    """The batch and hybrid engines, through one streaming loop
    (compact.run_site_stats_compact_stream): pileups are built as the
    engine asks for them, and each chunk's scaffolds are turned into
    tables as soon as its outputs land, while the next chunk runs. Batch
    (instrain_tpu/profile/pipeline.py:541-780) fills chunks of many
    scaffolds; hybrid (:440-500) makes each scaffold a chunk of its own.
    Scaffolds over the one-launch bound run the position-chunked dense
    path afterwards: for batch by the JAX package's estimate before the
    pileup (_oversize), for hybrid by the pileup's own extent
    (resolve_engine). A scaffold whose pileup or tables fail is logged and
    dropped; a kernel or CUDA fault fails the run. With gene_data, a
    chunk's genes are profiled here too, while the next chunk runs.
    Returns the finalized payloads in `keep` order."""
    metas: Dict[int, tuple] = {}
    dense: List[tuple] = []
    finals: Dict[int, Dict] = {}

    def items():
        for name in keep:
            logging.debug(get_worker_log("SplitProfile", name, "start"))
            rid = bam.name_to_ref_id.get(name)
            if rid is None:
                continue
            L = registry.length_of(name)
            with _phase("pileup"):
                try:
                    if engine == "hybrid":
                        _inject_failure(name, cfg)
                    oversize = (engine == "batch" and
                                _oversize(pairs, rid, L, cfg))
                    pu = _build_pileup(bam, pairs, rid, L, cfg)
                except Exception as e:
                    _contain(name, e)
                    continue
            if pu is None:
                continue
            if engine == "hybrid":
                oversize = resolve_engine(
                    engine, device, pu.counts.shape[0], L,
                    skip_mm=cfg.skip_mm_profiling, counts=pu.counts
                ) == "dense"
            i = len(metas)
            metas[i] = (name, L, registry.codes[name])
            if oversize:
                dense.append((i, pu))
            else:
                yield i, pu, registry.codes[name]

    def handle(i, stats):
        name, L, ref_codes = metas[i]
        with _phase("tables"):
            try:
                finals[i] = _finalize_result(_result_from_stats(
                    name, L, stats, ref_codes, cfg, device, gene_data), cfg)
            except Exception as e:
                _contain(name, e)
        logging.debug(get_worker_log("SplitProfile", name, "end"))

    kw = dict(min_cov=cfg.variant.min_cov,
              rarefied_coverage=cfg.rarefied_coverage, seed=cfg.seed)
    chunk_cells = compact_mod.CHUNK_CELLS if engine == "batch" else 0
    for i, stats in compact_mod.run_site_stats_compact_stream(
            items(), null_lut, freq_lut, with_dense=True, device=device,
            max_chunk_cells=chunk_cells, phase=_phase, **kw):
        handle(i, stats)
    for i, pu in dense:
        with _phase("kernels"):
            stats = run_site_stats(pu, metas[i][2], null_lut, freq_lut,
                                   device=device, **kw)
        handle(i, stats)
    return [finals[i] for i in sorted(finals)]


def _result_from_stats(name, L, stats, ref_codes, cfg, device, gene_data):
    """SNP / SNV / coverage tables, linkage and, where the scaffold has
    genes, the gene tables for one scaffold, from compact or dense
    stats."""
    if isinstance(stats, compact_mod.CompactStats):
        snp, csnv = compact_mod.snp_tables_compact(stats, ref_codes)
        ctable = compact_mod.coverage_table_compact(stats)
    else:
        snp = tables.snp_table(stats, ref_codes)
        csnv = tables.cumulative_snv_table(snp)
        ctable = tables.coverage_table(stats, snp)
    ws = linkage_mod.window_starts_for(L, cfg.window_length)
    ld = linkage_mod.calculate_linkage(stats, ws, min_snp=int(cfg.min_snp),
                                      seed=cfg.seed, device=device)
    gene_results = None
    if gene_data is not None and name in gene_data.scaff2genes:
        with _phase("genes"):
            try:
                gene_results = genes_mod.profile_genes_for_scaffold(
                    name, gene_data, stats, csnv)
            except Exception as e:
                # host code only: a gene failure does not drop the
                # scaffold (reference: profile_utilities.py:388-396)
                log_failure("GeneException", name, str(e))
    return ScaffoldProfileResult(
        name=name, length=L, stats=stats, snp_table=snp,
        cumulative_snv_table=csnv, cumulative_scaffold_table=ctable,
        linkage_table=ld, gene_results=gene_results)


_SPECIAL_DESCR = {
    "covT": "Scaffold -> mm -> position based coverage",
    "clonT": "Scaffold -> mm -> position based clonality",
    "clonTR": "Scaffold -> mm -> rarefied position based clonality",
}


def _finalize_result(r: ScaffoldProfileResult, cfg) -> Dict:
    """A ScaffoldProfileResult as a plain payload: tables, the
    covT/clonT views and the linkage capture (the stats object holds
    views into native decoder memory and is dropped here)."""
    out = dict(
        name=r.name, length=r.length,
        snp_table=r.snp_table,
        cumulative_snv_table=r.cumulative_snv_table,
        cumulative_scaffold_table=r.cumulative_scaffold_table,
        linkage_table=r.linkage_table,
        covT=tables.covT_view(r.stats),
        clonT=tables.clonT_view(r.stats),
        clonTR=tables.clonT_view(r.stats, rarefied=True),
        reads_to_snvs=_reads_to_snvs(r.stats),
        gene_results=r.gene_results,
    )
    if cfg.store_everything:
        out["counts_sum"] = r.stats.pileup.counts.sum(axis=0).T
    return out


def _store_results(isdir: ProfileDir, finals: List[Dict], cfg, gene_data):
    """reference: profile_utilities.gen_snv_profile (614-717)."""
    def cat(dfs):
        dfs = [d for d in dfs if d is not None and len(d)]
        return (pd.concat(dfs).reset_index(drop=True) if dfs
                else pd.DataFrame())

    isdir.store("scaffold_list", [r["name"] for r in finals], "list",
                "1d list of scaffolds that were profiled")
    mi = isdir.get("mapping_info")
    s2fp = mi.set_index("scaffold")["filtered_pairs"].to_dict()
    isdir.store("window_table", pd.DataFrame(
        {"scaffold": [r["name"] for r in finals],
         "end": [r["length"] for r in finals],
         "start": [0] * len(finals),
         "filtered_pairs": [s2fp.get(r["name"], 0) for r in finals]}),
        "pandas", "Windows profiled over")
    isdir.store("raw_linkage_table",
                cat([r["linkage_table"] for r in finals]),
                "pandas", "Raw table of linkage information")
    raw_snp = cat([r["snp_table"] for r in finals])
    isdir.store("raw_snp_table",
                raw_snp.drop(columns=[c for c in ("var_freq", "con_freq",
                                                  "ref_freq")
                                      if c in raw_snp.columns]),
                "pandas", "Contains raw SNP information on a mm level")
    isdir.store("cumulative_scaffold_table",
                cat([r["cumulative_scaffold_table"] for r in finals]),
                "pandas", "Cumulative coverage on mm level")
    isdir.store("cumulative_snv_table",
                cat([r["cumulative_snv_table"] for r in finals]),
                "pandas", "Cumulative SNP on mm level")

    for attr, descr in _SPECIAL_DESCR.items():
        isdir.store(attr, {r["name"]: r[attr] for r in finals},
                    "special", descr)

    if cfg.store_everything:
        # per-scaffold summed ACTG pileup counts (reference: counts_table,
        # gen_snv_profile 709-715 — [L, 4] per scaffold)
        isdir.store("counts_table", [r["counts_sum"] for r in finals],
                    "pickle",
                    "1d numpy array of 2D counts tables for each scaffold")
        isdir.store("read_to_snvs",
                    {r["name"]: r["reads_to_snvs"] for r in finals},
                    "pickle", "Scaffold -> mm -> read -> SNVs")

    # linkage capture structure (reference stores it for pooling/debug)
    isdir.store("scaffold_2_mm_2_read_2_snvs",
                {r["name"]: r["reads_to_snvs"] for r in finals}, "pickle",
                "scaffold -> mm -> read -> SNVs (linkage capture)")

    if gene_data is not None:
        # instrain_tpu/profile/pipeline.py:866-880
        genes_mod.store_gene_tables(
            isdir, cfg.gene_file, gene_data,
            [cat([r["gene_results"][i] for r in finals
                  if r["gene_results"] is not None]) for i in range(4)])


def _reads_to_snvs(stats: ScaffoldStats) -> Dict[int, Dict[str, list]]:
    """mm -> qname_id -> ['pos:base'] for captured linkage reads."""
    from collections import defaultdict
    from .linkage import counted_snv_events
    pos, base, mm_idx, qn = counted_snv_events(stats)
    if len(pos) == 0:
        return {}
    mm = stats.pileup.mm_values[mm_idx]
    out: Dict[int, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
    bchar = "ACTG"
    for p, b, m, q in zip(pos.tolist(), base.tolist(), mm.tolist(),
                          qn.tolist()):
        out[m][q].append(f"{p}:{bchar[b]}")
    return {m: dict(v) for m, v in out.items()}


def _subsample_bam(bam, maximum_reads: int, seed: int):
    """
    Deterministic template-level subsampling to ~maximum_reads records
    (the reference shells out to samtools view -s; samtools_ops.py:159-164).
    Record-table entries of dropped qnames are removed; the native event
    buffers stay consistent because pair selection drives every
    downstream native call.
    """
    n = bam.n_records
    if n <= maximum_reads:
        return
    frac = maximum_reads / n
    n_q = bam.n_qnames
    rng = np.random.default_rng(seed)
    keep_q = rng.random(n_q) < frac
    keep = keep_q[bam.qname_id]
    for f in ("ref_id", "pos", "flag", "mapq", "nm", "qname_id",
              "qlen_infer", "ref_start", "ref_end", "tlen", "mate_pos",
              "mate_ref", "ev_off", "ev_len", "pileup_ok"):
        setattr(bam, f, getattr(bam, f)[keep])
    logging.info(f"Subsampled to {bam.n_records} of {n} records "
                 f"(--maximum_reads {maximum_reads})")


def _filter_genome_coverage(keep, registry, s2p, read_length, cfg):
    """reference: profile/fasta.py:109-136."""
    from ..io.stb import load_scaff2bin
    stb = load_scaff2bin(cfg.stb)
    genome_pairs: Dict[str, int] = {}
    genome_len: Dict[str, int] = {}
    for name in keep:
        g = stb.get(name)
        if g is None:
            continue
        genome_pairs[g] = genome_pairs.get(g, 0) + s2p.get(name, 0)
        genome_len[g] = genome_len.get(g, 0) + registry.length_of(name)
    bad_genomes = {g for g in genome_pairs
                   if genome_pairs[g] * read_length / genome_len[g] <
                   cfg.min_genome_coverage}
    return [n for n in keep
            if stb.get(n) is not None and stb[n] not in bad_genomes]

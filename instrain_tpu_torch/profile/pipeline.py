"""
The `profile` operation: BAM + FASTA -> profile directory — the
counterpart of instrain_tpu/profile/pipeline.py, with the dense, pallas,
hybrid and batch engines, on one device, over a mesh of devices
(--mesh_devices, parallel/mesh.py) or over several processes
(--distributed, parallel/distributed.py).

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

With --mesh_devices N > 1 the hybrid engine splits each scaffold's
positions over N devices and the batch engine sends its chunks to them in
turn (profile/compact.py); the tables are the one-device run's, byte for
byte. Under --distributed each process owns a share of the scaffolds:
with a .bai and the paired_only filter it decodes only those (ranged),
filters them with two gathers of the globally coupled quantities
(filter_reads_distributed), and otherwise decodes and filters everything;
it profiles only its scaffolds, and the payloads meet in one gather,
after which process 0 (or, with distributed_store "all", every process)
writes the profile directory. Every process runs the same collectives in
the same order, whatever it owns.

Under the batch engine (more than one kept scaffold) the stores overlap
the device loop, as in the JAX package (instrain_tpu/profile/
pipeline.py:255-301): the read-filter results are written on a thread of
their own (instrain-store-reads), and covT, clonT and clonTR go to
SpecialStreamWriters scaffold by scaffold from another
(instrain-hd5-stream) as each chunk's tables are built; the writers
register their attributes after the loop, before the other results.
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import torch

from ..config import ProfileConfig
from ..io import fasta as fasta_io
from ..io.bam import decode_bam
from ..kernels.cuda_sitestats import KernelError
from ..obs import spans
from ..obs.logging import (get_worker_log, log_checkpoint, log_failure,
                           report_run_stats)
from ..parallel import distributed as dist_mod
from ..parallel.mesh import Mesh, make_mesh, resolve_device
from ..store import generate as gen
from ..store.profile_dir import ProfileDir, SpecialStreamWriter
from . import compact as compact_mod
from . import genes as genes_mod
from . import genome as genome_mod
from . import linkage as linkage_mod
from . import tables
from .filter_reads import filter_reads, filter_reads_distributed
from .pileup import (ScaffoldStats, _bucket, build_scaffold_pileup,
                     build_scaffold_pileup_padded, make_luts,
                     run_site_stats)

# Phase accounting: benchmark/run.py and chip_smoke.py set this to a dict
# before a run and read it after. profile() hands it to spans.start_run,
# so the dict is taken at the run's start, and each span of the run adds
# its seconds to it by name (the names: obs/spans.py's docstring). None
# records nothing.
PHASES: Optional[Dict[str, float]] = None


def _start_thread(name: str, target):
    """Run target() on a daemon thread called `name`. Returns join(raising
    =True), which waits for it and then raises what target raised, if
    anything (raising False: drops it)."""
    errors: List[BaseException] = []

    def run():
        try:
            target()
        except BaseException as e:  # noqa: BLE001 -- raised by join()
            errors.append(e)

    thread = threading.Thread(target=run, name=name, daemon=True)
    thread.start()

    def join(raising: bool = True):
        thread.join()
        if errors and raising:
            raise errors[0]
    return join


def _start_special_writes(stream: Dict[str, "SpecialStreamWriter"]):
    """The thread that hands each scaffold's covT/clonT/clonTR views to
    the writers of `stream` (instrain_tpu/profile/pipeline.py:623-658).
    Returns (put, finish): put((name, {attr: view})) queues one scaffold,
    finish(raising=True) waits for every queued write. One scaffold's
    failed write is logged as a SpecialWriteError and costs that
    scaffold's datasets, never the run: it is host I/O."""
    todo: "queue.Queue" = queue.Queue()

    def run():
        while True:
            item = todo.get()
            if item is None:
                return
            name, views = item
            try:
                with spans.span("special_stream"):
                    for attr, writer in stream.items():
                        writer.write(name, views[attr])
            except Exception as e:
                log_failure("SpecialWriteError", name, str(e))
                logging.error(f"special stream write failed for {name}: "
                              f"{e}")

    join = _start_thread("instrain-hd5-stream", run)

    def finish(raising: bool = True):
        todo.put(None)
        join(raising)
    return todo.put, finish


ENGINES = ("auto", "dense", "hybrid", "batch", "pallas")


def check_supported(cfg: ProfileConfig) -> None:
    """Raise for an option value of `profile` that no engine runs,
    instead of ignoring it."""
    if cfg.engine not in ENGINES:
        raise ValueError(f"engine {cfg.engine!r} (one of {ENGINES})")
    if cfg.distributed_store not in ("primary", "all"):
        raise ValueError(f"distributed_store {cfg.distributed_store!r} "
                         f"(primary or all)")


# The hybrid and batch engines hold a scaffold's whole padded [Mp, 4, Lp]
# working set on the device in one launch; above this many padded cells
# the JAX package sends the scaffold to the position-chunked dense engine
# (instrain_tpu/profile/pipeline.py:475-481, :584-594). The port keeps
# its bound, although the card holds more: the engine decides the clonR
# draws' keys on scaffolds over 1 Mb. Over a mesh of n devices the bound
# is n times this (:474-482, :594).
HYBRID_MAX_CELLS = 1 << 27


# --engine auto runs the batch engine on a GPU from this many kept
# scaffolds on (instrain_tpu/profile/pipeline.py:239-246)
BATCH_MIN_SCAFFOLDS = 16


def resolve_run_engine(cfg_engine: str, device: torch.device,
                       n_scaffolds: int, shards: int = 1) -> str:
    """The engine of a run of n_scaffolds kept scaffolds (those the
    process owns) over `shards` devices, as the JAX package picks it
    (pipeline.py:239-246, :255, :305-306, :447-450): auto is dense on the
    CPU without a mesh, and otherwise batch from BATCH_MIN_SCAFFOLDS
    scaffolds on and hybrid below (never pallas); over a mesh, dense and
    pallas run hybrid (position-sharded); batch with one scaffold runs
    hybrid. Pallas is the dense engine, scaffold by scaffold, with clon
    rounded as the Pallas core rounds it."""
    engine = cfg_engine
    if engine == "auto":
        if device.type == "cpu" and shards == 1:
            return "dense"
        engine = ("batch" if n_scaffolds >= BATCH_MIN_SCAFFOLDS
                  else "hybrid")
    elif engine in ("dense", "pallas") and shards > 1:
        engine = "hybrid"
    if engine == "batch" and n_scaffolds <= 1:
        engine = "hybrid"
    return engine


def resolve_engine(cfg_engine: str, device: torch.device, M: int, L: int,
                   skip_mm: bool = False, shards: int = 1,
                   int16: bool = True) -> str:
    """The engine one scaffold of [M, L] runs outside the batch engine, as
    the JAX package picks it (pipeline.py:451-453, :458-481): auto is dense
    on the CPU and hybrid on a GPU; hybrid goes dense when the extent of
    the pileup the JAX package builds exceeds HYBRID_MAX_CELLS times the
    shards it is split over. That pileup is padded, max(ceil8(M), 8) *
    max(ceil4096(L), 4096), where the padded int16 builder kept it
    (`int16`, the builder's outcome: pileup.true_M is set); else unpadded,
    M * L: under skip_mm (M is then 1) and where an exact-mm count
    overflowed int16."""
    engine = cfg_engine
    if engine == "auto":
        engine = "dense" if device.type == "cpu" else "hybrid"
    if engine != "hybrid":
        return engine
    if int16 and not skip_mm:
        cells = max(_bucket(M, 8), 8) * max(_bucket(L, 4096), 4096)
    else:
        cells = M * L
    return "dense" if cells > HYBRID_MAX_CELLS * shards else engine


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


def writes_profile(cfg: ProfileConfig) -> bool:
    """Whether this process writes the profile directory: in a run of one
    process, yes; of several, process 0, or every process under
    distributed_store "all" (each then needs a directory of its own)."""
    return (dist_mod.process_count() == 1 or cfg.distributed_store == "all"
            or dist_mod.process_index() == 0)


def profile(bam_path: str, fasta_path: str, cfg: ProfileConfig,
            output: Optional[str] = None,
            mesh: Optional[Mesh] = None) -> Optional[ProfileDir]:
    """Run the profile operation; returns the profile directory (None in
    a process of a distributed run that writes none: writes_profile).
    `mesh` (parallel/mesh.make_mesh, whose devices may repeat) takes the
    place of cfg.mesh_devices; the device of the dense path and of
    linkage is then its first."""
    spans.start_run(PHASES)
    try:
        check_supported(cfg)
        device = resolve_device(cfg.device)
        if mesh is not None:
            device = mesh.devices[0]
        elif cfg.mesh_devices and cfg.mesh_devices > 1:
            # the cards from the current one on (the CLI makes
            # cuda:LOCAL_RANK * N current under torchrun), or N shards of
            # the CPU
            mesh = make_mesh(cfg.mesh_devices, device_type=device.type)
        cfg.apply_database_mode()
        if not writes_profile(cfg):
            # a peer of process 0: it profiles its share and sends it, and
            # touches no file of the directory process 0 writes
            return _profile_impl(bam_path, fasta_path, cfg, None, device,
                                 mesh)
        isdir = ProfileDir(output or cfg.output)

        # per-run DEBUG file log (reference: controller.setup_logger
        # writes <out>/log/log.log)
        with spans.span("registry"):
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
            return _profile_impl(bam_path, fasta_path, cfg, isdir, device,
                                 mesh)
        finally:
            with spans.span("registry"):
                root.removeHandler(fh)
                root.setLevel(old_level)
                fh.close()
    finally:
        spans.end_run()


def _profile_impl(bam_path: str, fasta_path: str, cfg: ProfileConfig,
                  isdir: Optional[ProfileDir], device: torch.device,
                  mesh: Optional[Mesh]) -> Optional[ProfileDir]:
    log_checkpoint("main_profile", "filter_reads", "start")
    with spans.span("registry"):
        registry = fasta_io.ScaffoldRegistry.from_fasta(
            fasta_path, window_length=cfg.window_length,
            use_full_header=cfg.use_full_fasta_header,
            scaffolds_to_profile=fasta_io.load_scaff_list(
                cfg.scaffolds_to_profile))
        ref_seqs = {n: fasta_io.CODE2BASE[np.minimum(registry.codes[n], 4)]
                    for n in registry.names}
    # several processes: each decodes only the scaffolds it owns, where
    # the plan allows it (instrain_tpu/profile/pipeline.py:117-137)
    multi_host = dist_mod.process_count() > 1
    rank = dist_mod.process_index()
    owned = (_plan_sharded_decode(bam_path, registry, cfg) if multi_host
             else None)
    with spans.span("decode"):
        bam = decode_bam(bam_path, ref_seqs=ref_seqs,
                         threads=cfg.processes, baq=False, scaffolds=owned)
    if owned is not None:
        if bam.ranged:
            logging.info(f"sharded decode: host {rank} ranged-decoded "
                         f"{len(owned)} of {len(registry.names)} scaffolds")
        else:
            logging.info("ranged decode unavailable; this host decoded the "
                         "full BAM (filtering stays sharded)")
    with spans.span("filter"):
        if owned is not None:
            pairs = filter_reads_distributed(
                bam, cfg.filter, registry.names, owned,
                skip_mm=cfg.skip_mm_profiling)
        else:
            if cfg.filter.maximum_reads:
                _subsample_bam(bam, cfg.filter.maximum_reads, cfg.seed)
            pairs = filter_reads(bam, cfg.filter, scaffolds=registry.names)

    # several processes: under "primary" (the default) only process 0
    # writes the profile directory, its read results included, also on
    # the zero-pair abort; "all": every process writes a whole one
    primary_peer = isdir is None

    def store_reads():
        # read-filtering results (reference: controller.py:260-322)
        _store_read_results(isdir, bam, pairs, bam_path, fasta_path,
                            registry, cfg)

    total_pairs = int(pairs.mapping_info["filtered_pairs"].iloc[0])
    if total_pairs == 0:
        # the mapping report is written before the abort, so that the run
        # can be looked into (the reference's controller.py:260-322 stores
        # before its 314-317 abort)
        if not primary_peer:
            with spans.span("store"):
                store_reads()
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
    keep_local = keep
    if multi_host:
        # the decode's owner, or (replicated decode) the canonical
        # assignment by filtered pairs (:199-222)
        mine = set(owned if owned is not None else dist_mod.my_scaffolds(
            {n: s2p.get(n, 0) for n in keep}))
        keep_local = [n for n in keep if n in mine]
        logging.info(f"multi-host: process {rank} of "
                     f"{dist_mod.process_count()} owns {len(keep_local)} of "
                     f"{len(keep)} scaffolds")

    with spans.span("registry"):
        null_lut, freq_lut = make_luts(cfg.variant)
        null_t = torch.as_tensor(null_lut, dtype=torch.int32, device=device)
        freq_t = torch.as_tensor(freq_lut, dtype=torch.int32, device=device)

    gene_data = None
    if cfg.gene_file is not None:
        with spans.span("genes"), spans.span("genes.parse"):
            gene_data = genes_mod.parse_genes(cfg.gene_file)

    shards = mesh.size if mesh is not None else 1
    engine = resolve_run_engine(cfg.engine, device, len(keep_local), shards)
    if mesh is not None:
        logging.info(f"Sharding the profile kernels over {shards} devices "
                     f"({'positions' if engine == 'hybrid' else 'chunks'})")
    # the batch engine (only with more than one kept scaffold:
    # resolve_run_engine) overlaps the stores with its device loop
    # (instrain_tpu/profile/pipeline.py:255-301): the read results on a
    # thread of their own, started here, and covT/clonT/clonTR through
    # stream writers fed as each scaffold's tables are built. With several
    # processes the payloads keep their views for the gather, and the
    # gathered scaffolds go through the same writers afterwards.
    join_reads, stream = None, {}
    if not primary_peer and engine == "batch":
        def reads_thread():
            with spans.span("store_reads"):
                store_reads()
        join_reads = _start_thread("instrain-store-reads", reads_thread)
        stream = {k: isdir.open_special_stream(k, d)
                  for k, d in _SPECIAL_DESCR.items()}
    elif not primary_peer:
        with spans.span("store"):
            store_reads()
    try:
        if engine in ("dense", "pallas"):
            finals = []
            for name in keep_local:
                logging.debug(get_worker_log("SplitProfile", name, "start"))
                res = _profile_one_scaffold(bam, pairs, registry, name, cfg,
                                            null_t, freq_t, device,
                                            gene_data, engine == "pallas")
                logging.debug(get_worker_log("SplitProfile", name, "end"))
                if res is not None:
                    with spans.span("tables"):
                        finals.append(_finalize_result(res, cfg, bam.qnames))
        else:
            finals = _profile_scaffolds_compact(
                bam, pairs, registry, keep_local, cfg, engine, null_t,
                freq_t, device, gene_data, mesh, stream=stream,
                keep_special_payload=multi_host)
        if join_reads is not None:
            with spans.span("store"), spans.span("store.wait"):
                join_reads()
        if multi_host:
            mine = {r["name"] for r in finals}
            with spans.span("gather"):
                finals = _gather_results(
                    finals, keep, unpack=not primary_peer and not stream)
            if primary_peer:
                # this process's scaffolds are in the gather: process 0
                # writes
                log_checkpoint("main_profile", "profile_scaffolds", "end")
                return None
        if stream:
            with spans.span("store"):
                # this process's scaffolds were written in the loop; the
                # gathered ones now, and every view leaves the payloads
                # (instrain_tpu/profile/pipeline.py:358-369)
                for fin in finals if multi_host else ():
                    for attr, writer in stream.items():
                        view = fin.pop(attr)
                        if fin["name"] not in mine:
                            writer.write(fin["name"], _unpack_view(view))
                order = [r["name"] for r in finals]
                for writer in stream.values():
                    writer.close(order)
    except BaseException:
        # no thread outlives the run, and no writer registers a
        # half-written attribute
        if join_reads is not None:
            join_reads(raising=False)
        for writer in stream.values():
            writer.abort()
        raise
    with spans.span("store"):
        _store_results(isdir, finals, cfg, gene_data,
                       prewritten=frozenset(stream))
        log_checkpoint("main_profile", "profile_scaffolds", "end")
        # outputs (reference: controller.py:352-360)
        with spans.span("store.outputs"):
            for t in ["SNVs", "scaffold_info", "linkage", "gene_info",
                      "mapping_info"]:
                gen.generate(isdir, t, force_compress=cfg.force_compress)
    if not cfg.skip_genome_wide:
        # instrain_tpu/profile/pipeline.py:391-396
        log_checkpoint("main_profile", "genome_wide", "start")
        with spans.span("genome"):
            genome_mod.genome_wide(isdir, stb=cfg.stb, mm_level=cfg.mm_level,
                                   skip_mm_profiling=cfg.skip_mm_profiling)
        log_checkpoint("main_profile", "genome_wide", "end")
    if not cfg.skip_plot_generation:
        # instrain_tpu/profile/pipeline.py:398-403
        with spans.span("plots"):
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
                          freq_lut, device, gene_data, pallas=False):
    """One scaffold through the dense engine (clon as the Pallas core
    rounds it where `pallas`), its failure contained."""
    try:
        return _profile_one_scaffold_inner(bam, pairs, registry, name, cfg,
                                           null_lut, freq_lut, device,
                                           gene_data, pallas)
    except Exception as e:
        _contain(name, e)
        return None


def _profile_one_scaffold_inner(bam, pairs, registry, name, cfg, null_lut,
                                freq_lut, device, gene_data, pallas=False):
    _inject_failure(name, cfg)
    rid = bam.name_to_ref_id.get(name)
    if rid is None:
        return None
    L = registry.length_of(name)
    with spans.span("pileup"):
        pileup = _build_pileup(bam, pairs, rid, L, cfg, padded=False)
        if pileup is None:
            return None
    ref_codes = registry.codes[name]
    with spans.span("kernels"):
        stats = run_site_stats(pileup, ref_codes, null_lut, freq_lut,
                               min_cov=cfg.variant.min_cov,
                               rarefied_coverage=cfg.rarefied_coverage,
                               seed=cfg.seed, device=device,
                               pallas=pallas)
    with spans.span("tables"):
        return _result_from_stats(name, L, stats, ref_codes, cfg, device,
                                  gene_data)


def _build_pileup(bam, pairs, rid, L, cfg, padded: bool):
    """The scaffold's pileup: int16 and bucket-padded from the native
    padded builder where `padded` (the hybrid and batch engines' sparse
    wire; int32 where an exact-mm count overflows int16), else int32, as
    the JAX package builds it (instrain_tpu/profile/pipeline.py:454-461,
    :588-601). With skip_mm_profiling, int32 with its mm axis collapsed:
    every pair counts at level 0."""
    if padded and not cfg.skip_mm_profiling:
        return build_scaffold_pileup_padded(bam, pairs, rid, L)
    pileup = build_scaffold_pileup(bam, pairs, rid, L)
    if pileup is not None and cfg.skip_mm_profiling:
        pileup.counts = pileup.counts.sum(axis=0, keepdims=True,
                                          dtype=np.int32)
        pileup.mm_values = np.array([0])
        pileup.qid2mmidx = np.where(pileup.qid2mmidx >= 0, 0,
                                    -1).astype(np.int32)
    return pileup


def _oversize(pairs, rid, L, cfg, shards: int = 1) -> bool:
    """Whether the batch engine sends a scaffold to the position-chunked
    dense path, by the JAX package's estimate before the pileup is built
    (pipeline.py:584-594): max(ceil8(n_mm), 8) * max(ceil4096(L), 4096)
    padded cells over HYBRID_MAX_CELLS times the mesh's shards, with n_mm
    the distinct mm values of the scaffold's pairs; never with
    skip_mm_profiling."""
    if cfg.skip_mm_profiling:
        return False
    qids, mms = pairs.r2m_for_scaffold(rid)
    n_mm = len(np.unique(mms)) if len(qids) else 0
    return (max(_bucket(max(n_mm, 1), 8), 8) * max(_bucket(L, 4096), 4096)
            > HYBRID_MAX_CELLS * shards)


def _profile_scaffolds_compact(bam, pairs, registry, keep, cfg, engine,
                               null_lut, freq_lut, device, gene_data,
                               mesh: Optional[Mesh] = None,
                               stream: Optional[Dict] = None,
                               keep_special_payload: bool = False
                               ) -> List[Dict]:
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
    chunk's genes are profiled here too, while the next chunk runs. With a
    mesh, hybrid splits each scaffold's positions over its devices and
    batch sends its chunks to them in turn, under a one-launch bound as
    many times larger; the dense path runs on `device`.

    With `stream` ({attr: SpecialStreamWriter} for covT, clonT and
    clonTR), each scaffold's three views go to a thread that writes them
    (_start_special_writes) as soon as its tables are built, the
    diverted dense scaffolds' too, and leave its payload unless
    `keep_special_payload` (they must cross processes); that thread is
    joined before this returns or raises.
    Returns the finalized payloads in `keep` order."""
    shards = mesh.size if mesh is not None else 1
    metas: Dict[int, tuple] = {}
    dense: List[tuple] = []
    finals: Dict[int, Dict] = {}
    put_views = finish_writes = None
    if stream:
        put_views, finish_writes = _start_special_writes(stream)

    def items():
        for name in keep:
            logging.debug(get_worker_log("SplitProfile", name, "start"))
            rid = bam.name_to_ref_id.get(name)
            if rid is None:
                continue
            L = registry.length_of(name)
            with spans.span("pileup"):
                try:
                    if engine == "hybrid":
                        _inject_failure(name, cfg)
                    oversize = (engine == "batch" and
                                _oversize(pairs, rid, L, cfg, shards))
                    pu = _build_pileup(bam, pairs, rid, L, cfg,
                                       padded=not oversize)
                except Exception as e:
                    _contain(name, e)
                    continue
            if pu is None:
                continue
            if engine == "hybrid":
                oversize = resolve_engine(
                    engine, device, pu.counts_exact.shape[0], L,
                    skip_mm=cfg.skip_mm_profiling, shards=shards,
                    int16=pu.true_M is not None) == "dense"
            i = len(metas)
            metas[i] = (name, L, registry.codes[name])
            if oversize:
                dense.append((i, pu))
            else:
                yield i, pu, registry.codes[name]

    def handle(i, stats):
        name, L, ref_codes = metas[i]
        with spans.span("tables"):
            try:
                finals[i] = _finalize_result(_result_from_stats(
                    name, L, stats, ref_codes, cfg, device, gene_data), cfg,
                    bam.qnames)
            except Exception as e:
                _contain(name, e)
        if put_views is not None and i in finals:
            fin = finals[i]
            put_views((name, {attr: fin[attr] if keep_special_payload
                              else fin.pop(attr) for attr in stream}))
        logging.debug(get_worker_log("SplitProfile", name, "end"))

    kw = dict(min_cov=cfg.variant.min_cov,
              rarefied_coverage=cfg.rarefied_coverage, seed=cfg.seed)
    chunk_cells = compact_mod.CHUNK_CELLS if engine == "batch" else 0
    try:
        for i, stats in compact_mod.run_site_stats_compact_stream(
                items(), null_lut, freq_lut, device=device,
                max_chunk_cells=chunk_cells, mesh=mesh, **kw):
            handle(i, stats)
        for i, pu in dense:
            with spans.span("kernels"):
                stats = run_site_stats(pu, metas[i][2], null_lut, freq_lut,
                                       device=device, **kw)
            handle(i, stats)
    except BaseException:
        if finish_writes is not None:
            finish_writes(raising=False)
        raise
    if finish_writes is not None:
        with spans.span("store"), spans.span("store.wait"):
            finish_writes()
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
    with spans.span("tables.linkage"):
        ld = linkage_mod.calculate_linkage(stats, ws,
                                          min_snp=int(cfg.min_snp),
                                          seed=cfg.seed, device=device)
    gene_results = None
    if gene_data is not None and name in gene_data.scaff2genes:
        with spans.span("genes"):
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


def _finalize_result(r: ScaffoldProfileResult, cfg, qnames) -> Dict:
    """A ScaffoldProfileResult as a plain payload: tables, the
    covT/clonT views and the linkage capture, its reads by name (the
    stats object holds views into native decoder memory and is dropped
    here). The payload is what crosses processes in a distributed run."""
    with spans.span("tables.views"):
        out = dict(
            name=r.name, length=r.length,
            snp_table=r.snp_table,
            cumulative_snv_table=r.cumulative_snv_table,
            cumulative_scaffold_table=r.cumulative_scaffold_table,
            linkage_table=r.linkage_table,
            covT=tables.covT_view(r.stats),
            clonT=tables.clonT_view(r.stats),
            clonTR=tables.clonT_view(r.stats, rarefied=True),
            reads_to_snvs=_reads_to_snvs(r.stats, qnames),
            gene_results=r.gene_results,
        )
        if cfg.store_everything:
            out["counts_sum"] = r.stats.pileup.counts_exact.sum(axis=0).T
    return out


def _store_results(isdir: ProfileDir, finals: List[Dict], cfg, gene_data,
                   prewritten=frozenset()):
    """The profile's results (reference: profile_utilities.gen_snv_profile,
    614-717). `prewritten` names the special attributes (covT, clonT,
    clonTR) that the batch engine's stream writers already wrote and
    registered, and which the payloads no longer hold: they are skipped
    (instrain_tpu/profile/pipeline.py:808-847)."""
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
        if attr not in prewritten:
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
        with spans.span("store.genes"):
            genes_mod.store_gene_tables(
                isdir, cfg.gene_file, gene_data,
                [cat([r["gene_results"][i] for r in finals
                      if r["gene_results"] is not None])
                 for i in range(4)])


def _reads_to_snvs(stats: ScaffoldStats,
                   qnames) -> Dict[int, Dict[str, list]]:
    """mm -> read name -> ['pos:base'] for captured linkage reads
    (reference: update_linked_reads, keyed by the read's name). The JAX
    package keys them by the decoder's qname_id, which depends on what
    the decode covered (a ranged decode numbers reads anew)."""
    from collections import defaultdict
    from .linkage import counted_snv_events
    pos, base, mm_idx, qn = counted_snv_events(stats)
    if len(pos) == 0:
        return {}
    mm = stats.pileup.mm_values[mm_idx]
    # a str object of its own per read and scaffold: a name with reads on
    # two scaffolds is then two objects in one process as in two, and the
    # stored pickle (which refers back to repeated objects) has the same
    # bytes wherever each scaffold was profiled
    names = {q: qnames[q].encode().decode() for q in set(qn.tolist())}
    out: Dict[int, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
    bchar = "ACTG"
    for p, b, m, q in zip(pos.tolist(), base.tolist(), mm.tolist(),
                          qn.tolist()):
        out[m][names[q]].append(f"{p}:{bchar[b]}")
    return {m: dict(v) for m, v in out.items()}


def _pack_view(view):
    """A covT/clonT view as numpy pairs (int32 positions, values): the
    form it crosses processes in."""
    return {mm: (s.index.values.astype(np.int32), s.values)
            for mm, s in view.items()}


def _unpack_view(packed):
    """A packed view as Series again, each array with numpy's own dtype
    object: unpickling made new ones, which a pickle of the view would
    write out each time, where it refers back to the shared one (so a
    pickled covT is the one-process run's bytes)."""
    return {mm: pd.Series(v.view(np.dtype(v.dtype.str)),
                          index=i.astype(np.int64))
            for mm, (i, v) in packed.items()}


def _gather_results(finals: List[Dict], keep: List[str],
                    unpack: bool = True) -> List[Dict]:
    """Every process's payloads on every process, in `keep` order (the
    one-process order), their covT/clonT views packed as numpy pairs
    while they cross (instrain_tpu/profile/pipeline.py:319-360); with
    unpack False (a process that will not write) they stay packed."""
    for fin in finals:
        for attr in _SPECIAL_DESCR:
            fin[attr] = _pack_view(fin[attr])
    finals = dist_mod.allgather_tables(finals)
    order = {n: i for i, n in enumerate(keep)}
    finals.sort(key=lambda r: order[r["name"]])
    if unpack:
        for fin in finals:
            for attr in _SPECIAL_DESCR:
                fin[attr] = _unpack_view(fin[attr])
    return finals


def _plan_sharded_decode(bam_path, registry, cfg) -> Optional[List[str]]:
    """The scaffolds this process decodes and profiles in a run of
    several processes, planned before any decode from the .bai's
    compressed byte extent of each reference (io/bai.py:read_ref_extents;
    a proxy for its reads) by assign_scaffolds_to_hosts
    (instrain_tpu/profile/pipeline.py:900-970). None (every process
    decodes and filters everything, and owns its share of the kept
    scaffolds by filtered pairs) where an option couples the scaffolds:
      - pairing_filter other than paired_only (non_discordant and
        all_reads look at a qname's records on every scaffold);
      - detailed_mapping_info (one table over every pair);
      - maximum_reads (its subsample is drawn over the whole BAM);
      - no .bai.
    The plan is a function of the BAM and the configuration; a gather of
    its digest, which every process runs, checks that all computed the
    same one, and where any differs or failed, every process replicates,
    so that the later collectives stay aligned."""
    import hashlib

    from ..io.bai import find_bai, read_bam_ref_names, read_ref_extents
    weights, bai = None, None
    if (cfg.filter.pairing_filter == "paired_only" and
            not cfg.detailed_mapping_info and not cfg.filter.maximum_reads):
        bai = find_bai(bam_path)
    if bai is not None:
        try:
            extents = read_ref_extents(bai)
            names = set(registry.names)
            weights = {n: int(extents[i]) if i < len(extents) else 0
                       for i, n in enumerate(read_bam_ref_names(bam_path))
                       if n in names} or None
        except Exception as e:
            logging.info(f"sharded decode unavailable ({e}); replicating")
    digest = ""
    if weights is not None:
        h = hashlib.sha256()
        for n in sorted(weights):
            h.update(f"{n}\0{weights[n]}\n".encode())
        digest = h.hexdigest()
    digests = dist_mod.allgather_tables([digest])
    if not digest or any(d != digest for d in digests):
        if digest:
            logging.info("sharded-decode plans differ across hosts; "
                         "replicating decode and filter everywhere")
        return None
    return dist_mod.assign_scaffolds_to_hosts(
        weights, dist_mod.process_count())[dist_mod.process_index()]


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

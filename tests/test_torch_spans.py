"""
The port's span recorder (instrain_tpu_torch/obs/spans.py) behind the
profile and compare runs' PHASES, on the CPU, over a batch-engine profile
with genome-wide, as tests/test_torch_stream.py runs the engine:

- every child span lies inside its parent's interval, on its thread, and
  is named `<parent>.<step>`; every PHASES total is the sum of its spans;
  the children of genome, tables, store and kernels add up to no more
  than their parent;
- with -g (a second profile, over synth_genes' genes), genes.parse,
  genes.coverage, genes.mutations and genes.counts lie inside a genes
  span (the parse's at the top level, each scaffold's inside tables) and
  store.genes inside store, each group adding up to no more than its
  parent;
- store_reads and special_stream run on the store threads, store.wait
  and registry on the main thread;
- with PHASES None nothing is recorded, and neither the clock nor
  torch.profiler.record_function is called;
- outside a run nothing is recorded, with PHASES a dict too: after a
  traced profile returns or raises, direct calls of the batch engine and
  genome_wide, and the genome_wide and profile_genes subcommands;
- under torch.profiler (CPU), the exported chrome trace holds a range for
  every main-thread span;
- the profile and compare runs' PHASES record through the same
  recorder (spans.start_run, spans.span);
- many threads recording at once lose no span and no second.

The CPU run has no CUDA event to wait on: a stand-in event on each chunk
makes the engine's kernels.wait span run.
"""

import json
import shutil
import sys
import threading
import types

import numpy as np
import pytest
import torch

from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.compare import pipeline as CP
from instrain_tpu_torch.kernels.cuda_sitestats import KernelError
from instrain_tpu_torch.kernels.nullmodel import analytic_null_thresholds
from instrain_tpu_torch.kernels.sitestats import freq_min_count_lut
from instrain_tpu_torch.obs import spans
from instrain_tpu_torch.profile import compact as PC
from instrain_tpu_torch.profile import pipeline as PP
from instrain_tpu_torch.profile.genome import genome_wide
from instrain_tpu_torch.profile.pileup import ScaffoldPileup
from instrain_tpu_torch.store.profile_dir import ProfileDir
from instrain_tpu_torch.synth import synth, synth_genes

FLAGS = ["--device", "cpu", "--engine", "batch", "--skip_plot_generation"]
STEPS = {"genome": {"genome.load", "genome.coverage", "genome.irep",
                    "genome.write"},
         "tables": {"tables.linkage", "tables.views"},
         "store": {"store.outputs", "store.wait"},
         "kernels": {"kernels.wait"}}
# the same steps in the profile with -g
GENE_STEPS = {"genes": {"genes.parse", "genes.coverage", "genes.mutations",
                        "genes.counts"},
              "tables": {"tables.linkage", "tables.views"},
              "store": {"store.outputs", "store.wait", "store.genes"}}


class _Event:
    """A chunk's copy event on the CPU, where the copy has landed."""

    def synchronize(self):
        pass


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    fasta, bam, _ = synth(str(d), S=6, L=3000, COV=30, seed=5)
    return d, fasta, bam


def _traced(d, fasta, bam, out, flags):
    """A batch profile with PHASES a dict, under torch.profiler: its
    PHASES, its spans, its run id and its chrome trace's ranges."""
    dispatch = PC._dispatch_chunk

    def with_event(*a, **k):
        chunk = dispatch(*a, **k)
        chunk.event = _Event()
        return chunk

    mp = pytest.MonkeyPatch()
    mp.setattr(PC, "_dispatch_chunk", with_event)
    PP.PHASES = {}
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            assert port_main(["profile", bam, fasta, "-o",
                              str(d / out)] + FLAGS + flags) == 0
        phases = PP.PHASES
    finally:
        PP.PHASES = None
        mp.undo()
    path = str(d / (out + ".trace.json"))
    prof.export_chrome_trace(path)
    with open(path) as f:
        ranges = [e["name"] for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and
                  e.get("ph") == "X"]
    return phases, list(spans.RECORD.spans), spans.RECORD.run, ranges


@pytest.fixture(scope="module")
def traced(data):
    d, fasta, bam = data
    return _traced(d, fasta, bam, "traced.IS", [])


@pytest.fixture(scope="module")
def genes_file(data):
    return synth_genes(data[1], seed=0)[0]


@pytest.fixture(scope="module")
def traced_genes(data, genes_file):
    """The traced profile with -g."""
    d, fasta, bam = data
    return _traced(d, fasta, bam, "genes.IS", ["-g", genes_file])


def test_children_inside_parents(traced):
    _, record, run, _ = traced
    assert record and all(s.run == run for s in record)
    assert all(0 < s.start_ns <= s.end_ns for s in record)
    children = [s for s in record if s.parent is not None]
    assert children
    for s in children:
        p = record[s.parent]
        assert s.name.startswith(p.name + "."), (s.name, p.name)
        assert s.thread == p.thread
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_phases_are_span_sums(traced):
    phases, record, _, _ = traced
    assert set(phases) == {s.name for s in record}
    for name, total in phases.items():
        assert total == pytest.approx(
            sum(s.seconds for s in record if s.name == name), rel=1e-12)


@pytest.mark.parametrize("parent", sorted(STEPS) +
                         [f"g:{p}" for p in sorted(GENE_STEPS)])
def test_steps_within_parent(request, parent):
    """`g:<parent>`: in the profile with -g."""
    with_genes = parent.startswith("g:")
    parent = parent[2:] if with_genes else parent
    phases = request.getfixturevalue(
        "traced_genes" if with_genes else "traced")[0]
    steps = {k for k in phases if k.startswith(parent + ".")}
    assert steps == (GENE_STEPS if with_genes else STEPS)[parent]
    assert sum(phases[k] for k in steps) <= phases[parent]


def test_gene_steps_inside_genes_spans(traced_genes):
    """Each genes.<step> span lies inside a genes span (children_inside_
    parents' rule); the parse's genes span is at the top level and each
    scaffold's inside tables; store.genes inside store."""
    _, record, _, _ = traced_genes
    parents = {}
    for s in record:
        if s.name.startswith("genes.") or s.name == "store.genes":
            p = record[s.parent]
            assert s.name.startswith(p.name + "."), (s.name, p.name)
            assert s.thread == p.thread
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            parents.setdefault(s.name, set()).add(
                None if p.parent is None else record[p.parent].name)
    assert parents == {"genes.parse": {None}, "genes.coverage": {"tables"},
                       "genes.mutations": {"tables"},
                       "genes.counts": {"tables"}, "store.genes": {None}}


@pytest.mark.parametrize("name,thread", [
    ("store_reads", "instrain-store-reads"),
    ("special_stream", "instrain-hd5-stream"),
    ("store.wait", "MainThread"),
    ("registry", "MainThread")])
def test_span_threads(traced, name, thread):
    _, record, _, _ = traced
    got = [s for s in record if s.name == name]
    assert got and all(s.thread == thread for s in got)
    if name != "store.wait":
        assert all(s.parent is None for s in got)


@pytest.mark.parametrize("name", ["registry", "genome.irep", "store.wait",
                                  "kernels.wait", "tables.views",
                                  "genes.parse", "genes.coverage",
                                  "genes.mutations", "genes.counts",
                                  "store.genes"])
def test_trace_ranges(request, name):
    """The gene steps' ranges in the profile with -g."""
    with_genes = name.startswith("genes") or name == "store.genes"
    _, record, _, ranges = request.getfixturevalue(
        "traced_genes" if with_genes else "traced")[:4]
    n = sum(s.name == name for s in record)
    assert n > 0 and ranges.count(name) == n


@pytest.mark.parametrize("genes", [False, True], ids=["plain", "genes"])
def test_off_records_nothing(request, data, monkeypatch, genes):
    d, fasta, bam = data
    flags = (["-g", request.getfixturevalue("genes_file")] if genes
             else [])
    calls = []

    def clock():
        calls.append("clock")
        return 0

    def record_function(*a, **k):
        calls.append("record_function")
        raise AssertionError("record_function called with PHASES None")

    monkeypatch.setattr(spans, "time",
                        types.SimpleNamespace(perf_counter_ns=clock))
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    assert PP.PHASES is None and CP.PHASES is None
    run = spans.RECORD.run
    assert port_main(["profile", bam, fasta, "-o",
                      str(d / f"off{len(flags)}.IS")] + FLAGS + flags) == 0
    assert spans.RECORD.run == run + 1
    assert spans.RECORD.spans == [] and calls == []


@pytest.mark.parametrize("ending", ["returned", "raised"])
def test_calls_after_a_run_record_nothing(data, traced, tmp_path,
                                          monkeypatch, ending):
    """After a traced profile returns, or raises (a kernel fault in the
    batch loop), a direct call of the batch engine on the CPU and of
    genome_wide on a stored profile records no span and leaves that run's
    PHASES as they were."""
    d, fasta, bam = data
    monkeypatch.setattr(PP, "PHASES", {})
    argv = ["profile", bam, fasta, "-o", str(tmp_path / "p.IS")] + FLAGS
    if ending == "raised":
        def kernel_fault(*a, **k):
            raise KernelError("site_stats: launch failed")

        with monkeypatch.context() as m:
            m.setattr(PC, "_dispatch_chunk", kernel_fault)
            with pytest.raises(KernelError):
                port_main(argv)
    else:
        assert port_main(argv) == 0
    phases, run = dict(PP.PHASES), spans.RECORD.run
    record = list(spans.RECORD.spans)
    assert phases and record and {s.run for s in record} == {run}

    rng = np.random.default_rng(0)
    pus, refs = [], []
    for k, L in enumerate((700, 1300)):
        counts = rng.integers(0, 12, (2, 4, L)).astype(np.int32)
        pus.append(ScaffoldPileup(name=f"s{k}", rid=k, length=L,
                                  mm_values=np.arange(2), counts=counts))
        refs.append(rng.integers(0, 4, L).astype(np.uint8))
    got = PC.run_site_stats_compact_batch(
        pus, refs, analytic_null_thresholds(max_coverage=1000),
        freq_min_count_lut(0.05, max_coverage=1000), device="cpu")
    assert [st.pileup for st in got] == pus
    stored = shutil.copytree(d / "traced.IS", tmp_path / "g.IS")
    genome_wide(ProfileDir(str(stored)))
    assert (tmp_path / "g.IS" / "output" / "g.IS_genome_info.tsv").exists()

    assert PP.PHASES == phases and spans.RECORD.run == run
    assert spans.RECORD.spans == record


@pytest.mark.parametrize("sub", ["genome_wide", "profile_genes"])
def test_subcommands_record_nothing(traced_genes, data, genes_file,
                                    tmp_path, monkeypatch, sub):
    """With PHASES a dict, the genome_wide and profile_genes subcommands,
    which run outside a profile run, record no span and add nothing to
    PHASES."""
    stored = str(shutil.copytree(data[0] / "genes.IS", tmp_path / "g.IS"))
    monkeypatch.setattr(PP, "PHASES", {})
    run, record = spans.RECORD.run, list(spans.RECORD.spans)
    argv = {"genome_wide": ["genome_wide", "-i", stored],
            "profile_genes": ["profile_genes", "-i", stored, "-g",
                              genes_file]}[sub]
    assert port_main(argv) == 0
    assert PP.PHASES == {} and spans.RECORD.run == run
    assert spans.RECORD.spans == record


@pytest.mark.parametrize("mod", [PP, CP], ids=["profile", "compare"])
def test_phase_records_through_one_recorder(monkeypatch, mod):
    """The run's PHASES, handed to spans.start_run as profile() and
    compare() hand it, take every span of every thread until
    spans.end_run."""
    monkeypatch.setattr(mod, "PHASES", {})
    run = spans.start_run(mod.PHASES)
    seen = {}

    def worker():
        with spans.span("thread"):
            seen["stack"] = list(spans._OPEN.stack)

    try:
        with spans.span("outer"):
            with spans.span("outer.inner"):
                t = threading.Thread(target=worker, name="worker")
                t.start()
                t.join(timeout=60)
    finally:
        spans.end_run()
    with spans.span("after"):
        pass
    got = {s.name: s for s in spans.RECORD.spans}
    assert set(got) == {"outer", "outer.inner", "thread"}
    assert got["outer"].parent is None and got["thread"].parent is None
    assert spans.RECORD.spans[got["outer.inner"].parent] is got["outer"]
    assert got["thread"].thread == "worker" and seen["stack"] == [2]
    assert all(s.run == run for s in got.values())
    assert set(mod.PHASES) == set(got)
    assert mod.PHASES["outer"] >= mod.PHASES["outer.inner"] > 0
    assert not hasattr(PP, "MARKS") and not hasattr(mod, "_phase")


def test_threads_lose_nothing(monkeypatch):
    """More threads than cores open nested spans at a shortened switch
    interval: every span is recorded once, with its parent on its own
    thread, and each PHASES total is the sum of its spans."""
    monkeypatch.setattr(PP, "PHASES", {})
    spans.start_run(PP.PHASES)
    n_threads, n_iter = 16, 200

    def work():
        for _ in range(n_iter):
            with spans.span("a"):
                with spans.span("a.b"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, name=f"w{i}")
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        spans.end_run()
    assert not any(t.is_alive() for t in threads)
    record = spans.RECORD.spans
    assert len(record) == 2 * n_threads * n_iter
    for s in record:
        if s.name == "a":
            assert s.parent is None
        else:
            p = record[s.parent]
            assert p.name == "a" and p.thread == s.thread
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    for name in ("a", "a.b"):
        assert PP.PHASES[name] == pytest.approx(
            sum(s.seconds for s in record if s.name == name), rel=1e-12)

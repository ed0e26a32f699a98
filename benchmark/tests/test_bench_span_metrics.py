"""The per-layer metrics of the program's child spans and store threads
(benchmark/metrics/*_us_per_pair.py over harness/steps.py), fed a
hand-built phases.Run: the right us per pair, None where no sample was
timed or the program recorded no such span, and the registry span left
out of other_us_per_pair."""

import pytest

import bench_helpers  # noqa: F401  (the repository root on sys.path)
from benchmark.harness import phases, registry

# metric -> the PHASES names it sums
READS = {
    "registry_us_per_pair": ("registry",),
    "engine_wait_us_per_pair": ("kernels.wait",),
    "tables_linkage_us_per_pair": ("tables.linkage",),
    "tables_views_us_per_pair": ("tables.views",),
    "store_outputs_us_per_pair": ("store.outputs",),
    "store_wait_us_per_pair": ("store.wait",),
    "store_threads_us_per_pair": ("store_reads", "special_stream"),
    "genome_load_us_per_pair": ("genome.load",),
    "genome_coverage_us_per_pair": ("genome.coverage",),
    "genome_irep_us_per_pair": ("genome.irep",),
    "genome_write_us_per_pair": ("genome.write",),
}


def _phases(scale):
    """Every span name the program records, with distinct seconds."""
    names = ["decode", "filter", "pileup", "kernels", "tables", "store",
             "genome"] + [n for ns in READS.values() for n in ns]
    return {n: scale * (i + 1) for i, n in enumerate(names)}


def _run():
    # two timed samples of 1,000 and 3,000 pairs, one untimed
    return phases.Run(samples=[
        phases.Sample(1000, 9.0, _phases(0.01), 70),
        phases.Sample(3000, 11.0, _phases(0.02), 70),
        phases.Sample(5000, 13.0)])


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader(metric):
    read = registry.metric_reader(metric)
    run = _run()
    want = sum((run.samples[0].phases[n] + run.samples[1].phases[n]) * 1e6
               / 4000 for n in READS[metric])
    assert read(run) == pytest.approx(want, rel=1e-12)
    # no sample timed
    assert read(phases.Run(samples=[phases.Sample(5000, 13.0)])) is None
    assert read(phases.Run()) is None
    # a program without these spans (the parent's PHASES)
    old = _run()
    for s in old.samples[:2]:
        for n in READS[metric]:
            del s.phases[n]
    assert read(old) is None


def test_registry_not_in_other():
    other = registry.metric_reader("other_us_per_pair")
    run = _run()
    without = _run()
    for s in without.samples[:2]:
        del s.phases["registry"]
    assert other(run) == other(without)
    assert "registry" not in phases.MAIN_PHASES

"""
`--engine pallas` of the port against the JAX package's.

The JAX package's `--engine pallas` runs its Pallas core (K1,
instrain_tpu/kernels/pallas_sitestats.py, interpret mode on the CPU) with
an XLA remainder in place of site_stats. The port's counterpart is the
dense engine's site_stats kernel in its pallas variant, which rounds clon
as the Pallas core does: XLA's CPU backend contracts the core's
left-to-right sum of squares into fma(p3, p3, fma(p2, p2, fma(p0, p0,
p1 * p1))), where site_stats' reduce gives fma(p1, p1, p0 * p0) innermost.

  - The plain site_stats in its pallas variant (and the kernel wrappers,
    which take it for CPU tensors) against site_stats_pallas_full: every
    key bit for bit, clon and clonR included.
  - `instrain_tpu_torch profile --engine pallas --device cpu` against
    `instrain_tpu profile --engine pallas` on a small synth input: the
    four TSVs byte for byte.
"""

import os

import numpy as np
import pytest
import torch

import jax

from instrain_tpu.cli import main as jax_main
from instrain_tpu.kernels import pallas_sitestats as JP
from instrain_tpu.kernels.nullmodel import analytic_null_thresholds
from instrain_tpu.kernels.sitestats import freq_min_count_lut
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.kernels import cuda_sitestats as C
from instrain_tpu_torch.kernels import sitestats as S
from instrain_tpu_torch.synth import synth

NULL_LUT = analytic_null_thresholds(max_coverage=500)
FREQ_LUT = freq_min_count_lut(0.05, max_coverage=500)
TABLES = ["SNVs", "scaffold_info", "linkage", "mapping_info"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread in this module: the plain rarefied draws run
    many small elementwise ops, which threads only make contend with the
    other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(M, L, seed):
    """tests/test_pallas.py's inputs: half the counts zero."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 8, (M, 4, L)).astype(np.int32)
    counts[rng.random((M, 4, L)) < 0.5] = 0
    refs = rng.integers(0, 5, L).astype(np.uint8)
    return counts, refs


def _assert_bits(want, got, what):
    assert set(want) == set(got), (what, set(want) ^ set(got))
    for k in sorted(want):
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        if a.dtype.kind == "f":
            assert a.dtype == b.dtype, (what, k)
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), \
                (what, k, int((a.view(np.uint32) !=
                               b.view(np.uint32)).sum()))
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), \
                (what, k)


@pytest.mark.parametrize("M,L,seed", [(1, 1, 0), (5, 1111, 3),
                                      (8, 2048, 0), (9, 4096, 1)])
def test_pallas_variant_matches_pallas_full(M, L, seed):
    """Every output bit for bit, against the JAX wrapper behind `--engine
    pallas` at min_covR 20; the dense order differs from it in clon at
    some cells of the larger inputs, so the variant is what makes it
    exact."""
    counts, refs = _inputs(M, L, seed)
    key = jax.random.PRNGKey(7 + seed)
    want = {k: np.asarray(v) for k, v in JP.site_stats_pallas_full(
        counts, refs, NULL_LUT, FREQ_LUT, key, min_cov=5, min_covR=20,
        rarefied_draws=20, tile=512, interpret=True).items()}
    c, r, nl, fl = (torch.from_numpy(np.ascontiguousarray(a))
                    for a in (counts, refs, NULL_LUT, FREQ_LUT))
    kw = dict(min_cov=5, min_covR=20, rarefied_draws=20)
    got = S.site_stats(c, r, nl, fl, np.asarray(key), pallas=True, **kw)
    _assert_bits(want, {k: v.numpy() for k, v in got.items()}, "plain")
    C.reset_launch_counts()
    wrapped = C.site_stats(c, r, nl, fl, C.single_segment(L, key, c.device),
                           pallas=True, **kw)
    _assert_bits(want, {k: v.numpy() for k, v in wrapped.items()},
                 "wrapper")
    assert C.launch_counts() == {"site_stats": 0, "clonR": 0}
    dense = S.site_stats(c, r, nl, fl, np.asarray(key), **kw)
    differ = (dense["clon"].view(torch.int32) !=
              got["clon"].view(torch.int32)).sum().item()
    if L >= 1111:
        assert differ > 0, "the dense order gave the Pallas bits"
    assert np.isfinite(want["clonR"]).any() or L == 1


@pytest.fixture(scope="module")
def pallas_runs(tmp_path_factory):
    """A few scaffolds of a few kb (interpret mode is slow), through both
    packages' `--engine pallas`."""
    d = tmp_path_factory.mktemp("pallas")
    fasta, bam, _ = synth(str(d), S=3, L=3000, COV=40, seed=4)
    flags = ["--engine", "pallas", "--skip_genome_wide",
             "--skip_plot_generation"]
    jax_dir, port_dir = str(d / "jax.IS"), str(d / "port.IS")
    assert jax_main(["profile", bam, fasta, "-o", jax_dir] + flags) == 0
    assert port_main(["profile", bam, fasta, "-o", port_dir, "--device",
                      "cpu"] + flags) == 0
    return jax_dir, port_dir


def _tsv(d, table):
    path = os.path.join(d, "output", f"{os.path.basename(d)}_{table}.tsv")
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("table", TABLES)
def test_pallas_profile_matches_jax(pallas_runs, table):
    jax_dir, port_dir = pallas_runs
    want = _tsv(jax_dir, table)
    assert _tsv(port_dir, table) == want
    assert len(want.splitlines()) > 1


def test_pallas_engine_rules():
    """--engine pallas is a per-scaffold engine, as in the JAX package:
    dense's chunks and never batch; hybrid over a mesh; auto never picks
    it; an unknown engine raises."""
    from instrain_tpu_torch.config import ProfileConfig
    from instrain_tpu_torch.profile import pipeline as PP
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for dev in (cpu, cuda):
        for n in (1, 16, 128):
            assert PP.resolve_run_engine("pallas", dev, n) == "pallas"
            assert PP.resolve_run_engine("pallas", dev, n, 2) == "hybrid"
            assert PP.resolve_run_engine("auto", dev, n) != "pallas"
    cfg = ProfileConfig()
    cfg.engine = "pallas"
    PP.check_supported(cfg)
    cfg.engine = "mosaic"
    with pytest.raises(ValueError, match="engine"):
        PP.check_supported(cfg)

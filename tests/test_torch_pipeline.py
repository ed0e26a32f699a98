"""
The port's profile path against the JAX package's dense engine on a
synthetic BAM: read-pair filtering, pileup counts, run_site_stats
(including position chunking), and the end-to-end profile directory —
`instrain_tpu_torch profile --device cpu` against `instrain_tpu profile
--engine dense`. Also: the options once unported (--engine pallas,
--mesh_devices, --distributed) run, a kernel fault is never contained per
scaffold, and instrain_tpu's ProfileDir reads the port's
directory.

Table tolerances (tests/test_compact.py:736-776): integers and strings
exact, nucl_diversity* 1e-6 relative, every other float 1e-9.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from instrain_tpu.cli import main as jax_main
from instrain_tpu.config import ReadFilterConfig as JaxFilterConfig
from instrain_tpu.io.bam import decode_bam as jax_decode
from instrain_tpu.profile import filter_reads as JF
from instrain_tpu.profile import pileup as JPU
from instrain_tpu.store.profile_dir import ProfileDir as JaxProfileDir
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.config import ReadFilterConfig, VariantConfig
from instrain_tpu_torch.io.bam import decode_bam as port_decode
from instrain_tpu_torch.kernels.cuda_sitestats import KernelError
from instrain_tpu_torch.profile import filter_reads as PF
from instrain_tpu_torch.profile import pileup as PPU
from instrain_tpu_torch.profile import pipeline as PP
from instrain_tpu_torch.store import profile_dir as PD
from instrain_tpu_torch.synth import synth

TABLES = ["SNVs", "scaffold_info", "linkage", "mapping_info"]
FLAGS = ["--skip_genome_wide", "--skip_plot_generation"]


@pytest.fixture(scope="module")
def synth_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    return synth(str(d), S=4, L=5000, COV=40, seed=3)


@pytest.fixture(scope="module")
def profiles(synth_data, tmp_path_factory):
    """One port (--device cpu) and one JAX (--engine dense) profile."""
    fasta, bam, _ = synth_data
    d = tmp_path_factory.mktemp("profiles")
    port_dir, jax_dir = str(d / "port.IS"), str(d / "jax.IS")
    assert port_main(["profile", bam, fasta, "-o", port_dir, "--device",
                      "cpu"] + FLAGS) == 0
    assert jax_main(["profile", bam, fasta, "-o", jax_dir, "--engine",
                     "dense"] + FLAGS) == 0
    return port_dir, jax_dir


def _pairs_and_pileups(decode, filt, pileup_mod, cfg, bam):
    b = decode(bam, baq=False)
    pairs = filt.filter_reads(b, cfg)
    pus = [pileup_mod.build_scaffold_pileup(b, pairs, rid, int(L))
           for rid, L in enumerate(b.ref_lens)]
    return b, pairs, pus


def test_filter_and_pileup_match_jax(synth_data):
    _, bam, _ = synth_data
    _, jp, jpus = _pairs_and_pileups(jax_decode, JF, JPU,
                                     JaxFilterConfig(), bam)
    _, pp, ppus = _pairs_and_pileups(port_decode, PF, PPU,
                                     ReadFilterConfig(), bam)
    for f in ("ref_id", "qname_id", "nm", "insert", "mapq", "length",
              "reads"):
        a, b = getattr(jp.info, f), getattr(pp.info, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(jp.passed, pp.passed)
    assert np.array_equal(jp.mm, pp.mm)
    pd.testing.assert_frame_equal(jp.mapping_info, pp.mapping_info)
    assert jp.filter_values == pp.filter_values
    assert jp.rdic() == pp.rdic()
    assert len(ppus) == 4
    for a, b in zip(jpus, ppus):
        assert a.name == b.name and a.rid == b.rid
        assert a.counts.dtype == b.counts.dtype == np.int32
        assert np.array_equal(a.counts, b.counts)
        assert np.array_equal(a.mm_values, b.mm_values)
        assert np.array_equal(a.qid2mmidx, b.qid2mmidx)
    assert sum(int(p.counts.sum()) for p in ppus) > 0


@pytest.mark.parametrize("max_chunk", [1 << 20, 2048, 1500])
def test_run_site_stats_matches_jax(synth_data, max_chunk):
    """Whole scaffolds and position chunks (each chunk under its own
    seed, positions counted from the chunk start)."""
    from instrain_tpu.config import VariantConfig as JaxVariantConfig
    fasta, bam, _ = synth_data
    from instrain_tpu_torch.io.fasta import ScaffoldRegistry
    reg = ScaffoldRegistry.from_fasta(fasta)
    jb, _, jpus = _pairs_and_pileups(jax_decode, JF, JPU,
                                     JaxFilterConfig(), bam)
    _, _, ppus = _pairs_and_pileups(port_decode, PF, PPU,
                                    ReadFilterConfig(), bam)
    jl = JPU.make_luts(JaxVariantConfig())
    pl = PPU.make_luts(VariantConfig())
    assert all(np.array_equal(a, b) for a, b in zip(jl, pl))
    for jpu, ppu in zip(jpus, ppus):
        ref = reg.codes[ppu.name]
        want = JPU.run_site_stats(jpu, ref, *jl, seed=9,
                                  max_chunk=max_chunk, kernel="xla")
        got = PPU.run_site_stats(ppu, ref, *pl, seed=9,
                                 max_chunk=max_chunk, device="cpu")
        assert set(want.arrays) == set(got.arrays)
        for k, a in want.arrays.items():
            b = got.arrays[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if a.dtype.kind == "f":
                assert np.array_equal(a.view(np.uint32),
                                      b.view(np.uint32)), k
            else:
                assert np.array_equal(a, b), k
        assert np.isfinite(got.arrays["clonR"]).any()


def _read(path, name):
    if name == "mapping_info":
        with open(path) as f:
            header = f.readline()
        return header, pd.read_csv(path, sep="\t", header=1)
    return None, pd.read_csv(path, sep="\t")


@pytest.mark.parametrize("table", TABLES)
def test_profile_tsvs_match_jax_dense(profiles, table):
    port_dir, jax_dir = profiles
    a_path = os.path.join(port_dir, "output",
                          f"{os.path.basename(port_dir)}_{table}.tsv")
    b_path = os.path.join(jax_dir, "output",
                          f"{os.path.basename(jax_dir)}_{table}.tsv")
    ha, a = _read(a_path, table)
    hb, b = _read(b_path, table)
    assert ha == hb
    assert len(a) > 0 and list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for col in a.columns:
        va, vb = a[col].values, b[col].values
        if va.dtype.kind == "f" or vb.dtype.kind == "f":
            va, vb = va.astype(float), vb.astype(float)
            assert np.array_equal(np.isnan(va), np.isnan(vb)), col
            m = ~np.isnan(va)
            tol = 1e-6 if col.startswith("nucl_diversity") else 1e-9
            assert np.allclose(va[m], vb[m], rtol=tol, atol=0), col
        else:
            assert np.array_equal(va, vb), col


def test_jax_profiledir_reads_port_dir(profiles):
    port_dir, jax_dir = profiles
    jr = JaxProfileDir(port_dir)
    own = PD.ProfileDir(port_dir)
    ref = JaxProfileDir(jax_dir)
    for name in ("cumulative_snv_table", "cumulative_scaffold_table",
                 "mapping_info"):
        pd.testing.assert_frame_equal(jr.get(name), own.get(name))
        assert len(jr.get(name)) == len(ref.get(name))
    assert jr.get("scaffold_list") == ref.get("scaffold_list")
    assert jr.get("version") == ref.get("version")
    for special in ("covT", "clonT", "clonTR"):
        got, want = jr.get(special), ref.get(special)
        assert sorted(got) == sorted(want)
        for scaff in want:
            assert sorted(got[scaff]) == sorted(want[scaff])
            for mm, s in want[scaff].items():
                pd.testing.assert_series_equal(got[scaff][mm], s)
    assert len(jr.load_output("SNVs")) > 0


def test_special_stored_as_pickle_without_h5py(tmp_path, monkeypatch):
    """Where h5py is missing the special views are pickled, and both
    packages' readers still load them."""
    monkeypatch.setattr(PD, "_h5py", lambda: None)
    obj = {"scaf_0": {0: pd.Series(np.array([3, 4], np.int32),
                                   index=np.array([10, 11]))}}
    d = PD.ProfileDir(str(tmp_path / "p.IS"))
    d.store("covT", obj, "special", "coverage")
    got = JaxProfileDir(str(tmp_path / "p.IS")).get("covT")
    pd.testing.assert_series_equal(got["scaf_0"][0], obj["scaf_0"][0])
    pd.testing.assert_series_equal(d.get("covT")["scaf_0"][0],
                                   obj["scaf_0"][0])


@pytest.fixture(scope="module")
def base_runs():
    """The runs test_unported_options_raise holds its cases to, each made
    once: engine flags -> profile directory."""
    return {}


@pytest.mark.parametrize("extra, same_as", [
    (["--engine", "hybrid", "--mesh_devices", "2"], ["--engine", "hybrid"]),
    (["--engine", "batch", "--mesh_devices", "2"], ["--engine", "batch"]),
    (["--engine", "pallas"], ["--engine", "dense"]),
    (["--engine", "dense", "--mesh_devices", "3"], ["--engine", "hybrid"]),
    (["--mesh_devices", "2"], ["--engine", "hybrid"]),
    (["--mesh_devices", "1"], []),
    (["--distributed"], []),
    (["--distributed", "--engine", "batch", "--mesh_devices", "4"],
     ["--engine", "batch"]),
    (["--engine", "pallas", "--mesh_devices", "2"], ["--engine", "hybrid"]),
    (["--distributed", "--engine", "pallas"], ["--engine", "pallas"])])
def test_unported_options_raise(tmp_path, synth_data, extra, same_as,
                                base_runs):
    """The options that the port once raised on now run on --device cpu,
    and their TSVs equal, byte for byte, those of the run named beside
    them: --mesh_devices and --distributed equal the run without them (a
    mesh turns auto, dense and pallas into hybrid, as in the JAX package;
    --distributed without WORLD_SIZE is one process), and --engine pallas,
    the dense engine with clon rounded as the JAX package's Pallas core
    rounds it, equals --engine dense: clon's last bit differs at some
    cells (tests/test_torch_pallas.py), which does not reach the printed
    digits of this input's tables."""
    fasta, bam, _ = synth_data
    run = ["profile", bam, fasta, "--device", "cpu"] + FLAGS
    out = str(tmp_path / "x.IS")
    key = " ".join(same_as)
    if key not in base_runs:
        base_runs[key] = str(tmp_path / "base.IS")
        assert port_main(run + ["-o", base_runs[key]] + same_as) == 0
    base = base_runs[key]
    assert port_main(run + ["-o", out] + extra) == 0
    for table in TABLES:
        texts = []
        for d in (out, base):
            with open(os.path.join(d, "output", f"{os.path.basename(d)}_"
                                                f"{table}.tsv")) as f:
                texts.append(f.read())
        assert texts[0] == texts[1], table


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PP.resolve_device("cuda")
    assert PP.resolve_device("cpu") == torch.device("cpu")


def test_kernel_fault_is_not_contained(tmp_path, synth_data, monkeypatch):
    """A scaffold whose host code fails is dropped and logged; a kernel
    fault fails the whole run."""
    fasta, bam, _ = synth_data
    real = PP.run_site_stats

    def host_fault(pileup, *a, **k):
        if pileup.name == "scaf_1":
            raise ValueError("host failure")
        return real(pileup, *a, **k)

    monkeypatch.setattr(PP, "run_site_stats", host_fault)
    out = str(tmp_path / "host.IS")
    port_main(["profile", bam, fasta, "-o", out, "--device", "cpu"] + FLAGS)
    assert "scaf_1" not in PD.ProfileDir(out).get("scaffold_list")

    def kernel_fault(*a, **k):
        raise KernelError("site_stats: launch failed")

    monkeypatch.setattr(PP, "run_site_stats", kernel_fault)
    with pytest.raises(KernelError):
        port_main(["profile", bam, fasta, "-o", str(tmp_path / "k.IS"),
                   "--device", "cpu"] + FLAGS)


@pytest.mark.cuda
def test_profile_on_gpu_matches_cpu(profiles, synth_data, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from instrain_tpu_torch.kernels import cuda_sitestats as C
    fasta, bam, _ = synth_data
    out = str(tmp_path / "gpu.IS")
    C.reset_launch_counts()
    port_main(["profile", bam, fasta, "-o", out, "--device", "cuda"] + FLAGS)
    assert min(C.launch_counts().values()) >= 4
    for t in TABLES:
        a = open(os.path.join(out, "output", f"gpu.IS_{t}.tsv")).read()
        b = open(os.path.join(profiles[0], "output",
                              f"port.IS_{t}.tsv")).read()
        assert a == b, t

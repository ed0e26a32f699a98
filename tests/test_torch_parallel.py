"""
The port's multi-device placement (instrain_tpu_torch/parallel/mesh.py)
on the CPU, where a mesh is n shards of the one CPU device: the
position-sharded hybrid and compact runs and the scaffold-sharded batch
equal the port's one-device run bit for bit (the rarefied draws too), and
the JAX package's run over its 8 virtual CPU devices as the port's parity
tests hold it (every integer, mask, row and draw bit for bit, the tables
exactly: the f64 clonality sums are exact in any grouping); clonR drawn
at a base position is the slice of the whole scaffold's draws; profile()
over a mesh writes the one-device bytes; the engine entry points default
to the current CUDA device and raise without one; make_mesh never gives
fewer cards than asked.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from instrain_tpu.parallel.mesh import make_mesh as jax_make_mesh
from instrain_tpu.profile import compact as JC
from instrain_tpu.profile.pileup import ScaffoldPileup as JaxPileup
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.kernels import cuda_sitestats as C
from instrain_tpu_torch.kernels import sitestats as S
from instrain_tpu_torch.kernels.nullmodel import analytic_null_thresholds
from instrain_tpu_torch.parallel.mesh import Mesh, make_mesh
from instrain_tpu_torch.profile import compact as PC
from instrain_tpu_torch.profile import pileup as PPU
from instrain_tpu_torch.profile import pipeline as PP
from instrain_tpu_torch.profile.pileup import ScaffoldPileup
from instrain_tpu_torch.store.profile_dir import ProfileDir
from instrain_tpu_torch.synth import site_stats_inputs, synth

NULL_LUT = analytic_null_thresholds(max_coverage=1000)
FREQ_LUT = S.freq_min_count_lut(0.05, max_coverage=1000)
LUTS = (NULL_LUT, FREQ_LUT)
FLAGS = ["--skip_genome_wide", "--skip_plot_generation"]
TABLES = ["SNVs", "scaffold_info", "linkage", "mapping_info"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread in this module: its plain versions run many
    small elementwise ops, which threads only make contend with the other
    test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n):
    return make_mesh(n, device_type="cpu")


def _pileups(seed, M=5, L=9001):
    """The same random sparse pileup for both packages (the inputs of
    tests/test_parallel.py)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 12, (M, 4, L)).astype(np.int32)
    counts[rng.random((M, 4, L)) < 0.6] = 0
    refs = rng.integers(0, 4, L).astype(np.uint8)
    kw = dict(name=f"synth{seed}", rid=seed, length=L,
              mm_values=np.arange(M), counts=counts)
    return ScaffoldPileup(**kw), JaxPileup(**kw), refs


def _bits_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    if a.dtype.kind == "f":
        a = a.view(np.int32 if a.itemsize == 4 else np.int64)
        b = b.view(a.dtype)
    assert np.array_equal(a, b), what


def assert_stats_equal(want, got, dense: bool):
    assert (want.M, want.L) == (got.M, got.L)
    for grp in ("rows", "agg", "linkage", "masks"):
        w, g = getattr(want, grp), getattr(got, grp)
        assert set(w) == set(g), grp
        for k in w:
            _bits_equal(w[k], g[k], (grp, k))
    if dense:
        for k in ("clon", "clonR"):
            _bits_equal(getattr(want, k), getattr(got, k), k)


def assert_matches_jax(js, ps, ref, dense: bool):
    """The port's stats against the JAX package's as the port's parity
    tests hold them: the SNV and coverage tables exactly, the dense clon
    and clonR (JAX's padded to its buckets) bit for bit."""
    for a, b in zip(JC.snp_tables_compact(js, ref),
                    PC.snp_tables_compact(ps, ref)):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    pd.testing.assert_frame_equal(JC.coverage_table_compact(js),
                                  PC.coverage_table_compact(ps),
                                  check_exact=True)
    np.testing.assert_array_equal(np.asarray(js.masks["cryptic"])[:ps.L],
                                  ps.masks["cryptic"])
    if dense:
        for k in ("clon", "clonR"):
            _bits_equal(np.asarray(getattr(js, k))[:ps.M, :ps.L],
                        getattr(ps, k), ("jax", k))


@pytest.fixture(scope="module")
def jax_mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    return jax_make_mesh(8)


@pytest.fixture(scope="module")
def hybrid_one():
    """The hybrid input of tests/test_parallel.py and its one-device
    run."""
    pu, jpu, ref = _pileups(3)
    return pu, jpu, ref, PC.run_site_stats_hybrid(pu, ref, *LUTS,
                                                  device="cpu")


@pytest.fixture(scope="module")
def compact_one():
    pu, jpu, ref = _pileups(11, M=3, L=4097)
    return pu, jpu, ref, PC.run_site_stats_hybrid(pu, ref, *LUTS,
                                                  device="cpu")


@pytest.mark.parametrize("n", [2, 3, 8])
def test_hybrid_position_sharded_equals_one_device(n, hybrid_one):
    """L = 9001 divides by none of the shard counts."""
    pu, _, ref, one = hybrid_one
    sharded = PC.run_site_stats_hybrid(pu, ref, *LUTS, mesh=cpu_mesh(n))
    assert isinstance(sharded, PC.CompactStats)
    assert_stats_equal(one, sharded, dense=True)
    assert np.isfinite(sharded.clonR).any()


@pytest.mark.parametrize("n", [2, 3, 8])
def test_compact_position_sharded_equals_one_device(n, compact_one):
    pu, _, ref, one = compact_one
    sharded = PC.run_site_stats_hybrid(pu, ref, *LUTS, mesh=cpu_mesh(n))
    assert type(sharded) is PC.CompactStats
    assert_stats_equal(one, sharded, dense=True)


def test_position_sharded_matches_jax_mesh8(jax_mesh8, hybrid_one,
                                            compact_one):
    """The port's 8 shards against the JAX package's mesh of 8 virtual
    CPU devices, at tests/test_parallel.py's shapes (the port's 8 shards
    equal its one device: the tests above). The second shape is held to
    the JAX package's compact run, which has no dense views."""
    for case, jax_run, dense in ((hybrid_one, JC.run_site_stats_hybrid,
                                  True),
                                 (compact_one, JC.run_site_stats_compact,
                                  False)):
        pu, jpu, ref, _ = case
        js = jax_run(jpu, ref, *LUTS, mesh=jax_mesh8)
        ps = PC.run_site_stats_hybrid(pu, ref, *LUTS, mesh=cpu_mesh(8))
        assert_matches_jax(js, ps, ref, dense=dense)


@pytest.mark.parametrize("n_scaff", [3, 11])
def test_batch_scaffold_sharded(n_scaff, jax_mesh8):
    """The batch engine's chunks over 8 shards (chunks of a few scaffolds:
    3 and 11 scaffolds leave some shards idle) equal the unsharded batch
    and the JAX package's batch over its 8 devices, per scaffold."""
    pus, jpus, refs = zip(*[_pileups(100 + i, M=3, L=3000 + 17 * i)
                            for i in range(n_scaff)])
    kw = dict(max_chunk_cells=3 * 4 * 3100)
    one = PC.run_site_stats_compact_batch(list(pus), list(refs), *LUTS,
                                          device="cpu", **kw)
    sharded = PC.run_site_stats_compact_batch(list(pus), list(refs), *LUTS,
                                              mesh=cpu_mesh(8), **kw)
    want = JC.run_site_stats_compact_batch(list(jpus), list(refs), *LUTS,
                                           with_dense=True, mesh=jax_mesh8)
    assert len(one) == len(sharded) == len(want) == n_scaff
    for a, b, js, ref in zip(one, sharded, want, refs):
        assert_stats_equal(a, b, dense=True)
        assert_matches_jax(js, b, ref, dense=True)


def test_stream_sends_chunks_to_devices_in_turn(monkeypatch):
    """Scaffold split: chunk k goes to the mesh's device k mod n with that
    device's LUT copies, and the results come back in dispatch order."""
    seen = []
    dispatch = PC._dispatch_chunk

    def spy(items, null_t, freq_t, *a):
        seen.append(([i for i, _, _ in items], a[-2], null_t))
        return dispatch(items, null_t, freq_t, *a)

    monkeypatch.setattr(PC, "_dispatch_chunk", spy)
    pus, _, refs = zip(*[_pileups(200 + i, M=2, L=1000) for i in range(5)])
    mesh = Mesh(["cpu"] * 3)
    got = list(PC.iter_site_stats_compact_batch(
        list(pus), list(refs), *LUTS, mesh=mesh, max_chunk_cells=2 * 1000))
    assert [i for i, _ in got] == [0, 1, 2, 3, 4]
    assert [items for items, _, _ in seen] == [[0], [1], [2], [3], [4]]
    luts = [t for _, _, t in seen]
    assert luts[0] is luts[3] and luts[1] is luts[4]
    assert luts[0] is not luts[1] and luts[1] is not luts[2]


@pytest.mark.parametrize("pos0", [0, 1, 4097, 123_456])
def test_clonR_at_base_is_a_slice_of_the_scaffold(pos0):
    """The plain clonR of a shard at base pos0 equals positions [pos0,
    pos0 + n) of the whole scaffold's draws, through the kernel wrapper
    too (its plain version on CPU tensors); base 0 is the one-segment
    draw as before."""
    M, n = 3, 700
    counts, ref = site_stats_inputs(M, pos0 + n, seed=4)
    core = C.site_stats_core_plain(torch.from_numpy(counts),
                                   torch.from_numpy(ref),
                                   torch.from_numpy(NULL_LUT),
                                   torch.from_numpy(FREQ_LUT))
    key = PC._fold_keys(9, [5])[0]
    whole = C.clonR_plain(core["cum"], core["total"], core["clonR_set"],
                          C.single_segment(pos0 + n, key, "cpu"), 50, 8)
    sl = slice(pos0, pos0 + n)
    args = (core["cum"][:, :, sl].contiguous(),
            core["total"][:, sl].contiguous(),
            core["clonR_set"][:, sl].contiguous())
    shard = C.clonR(*args, C.single_segment(n, key, "cpu", pos0=pos0), 50, 8)
    _bits_equal(whole[:, sl].numpy(), shard.numpy(), "clonR shard")
    plain = S.clonR_values(*args, key, 50, 8, pos0)
    _bits_equal(shard.numpy(), plain.numpy(), "clonR_values")
    if pos0:
        unshifted = C.clonR(*args, C.single_segment(n, key, "cpu"), 50, 8)
        assert not np.array_equal(unshifted.numpy(), shard.numpy(),
                                  equal_nan=True)


def test_position_split():
    mesh = Mesh(["cpu"] * 3)
    assert [(a, b) for _, a, b in mesh.position_split(10)] == [
        (0, 4), (4, 8), (8, 10)]
    assert [(a, b) for _, a, b in mesh.position_split(1)] == [(0, 1)]
    assert [(a, b) for _, a, b in Mesh(["cpu"] * 8).position_split(9001)
            ][-1] == (7 * 1126, 9001)


def test_make_mesh_never_shrinks(monkeypatch):
    """make_mesh asked for more cards than the process has raises; it
    never falls back to fewer (instrain_tpu/parallel/mesh.py:44-53)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert make_mesh(2).devices == (torch.device("cuda", 0),
                                    torch.device("cuda", 1))
    with pytest.raises(ValueError, match="need 3 devices, have 2"):
        make_mesh(3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(ValueError, match="need 3 devices, have 2"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 2 devices, have 0"):
        make_mesh(2)
    assert make_mesh(devices=["cpu", "cpu"]).size == 2
    assert make_mesh(4, device_type="cpu").devices == (
        torch.device("cpu"),) * 4


def test_local_rank_takes_its_own_cards(monkeypatch):
    """Under torchrun, --mesh_devices N takes cards LOCAL_RANK*N ... on;
    missing cards raise, never wrap."""
    from instrain_tpu_torch.cli import select_local_cards
    chosen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setenv("LOCAL_RANK", "1")
    select_local_cards("cuda", 2)
    select_local_cards("cuda", 0)
    select_local_cards("cpu", 8)
    assert chosen == [2, 1]
    with pytest.raises(ValueError, match="need 6 devices, have 4"):
        select_local_cards("cuda", 3)
    monkeypatch.delenv("LOCAL_RANK")
    select_local_cards("cuda", 2)
    assert chosen == [2, 1]


def test_engine_defaults_need_a_gpu(monkeypatch):
    """Without a device the engine entry points run on the current CUDA
    device: on a host without one they raise, never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pu, _, ref = _pileups(1, M=2, L=500)
    for run in (PC.run_site_stats_hybrid, PPU.run_site_stats):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(pu, ref, *LUTS)
    for run in (PC.run_site_stats_compact_batch,
                lambda *a: list(PC.iter_site_stats_compact_batch(*a))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run([pu], [ref], *LUTS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(PC.run_site_stats_compact_stream(iter([(0, pu, ref)]), *LUTS))


def test_sharded_bounds_scale_with_the_mesh():
    """The one-launch bound is the shard count times HYBRID_MAX_CELLS
    (instrain_tpu/profile/pipeline.py:474-482, :594), and a mesh makes
    auto and dense run hybrid or batch, on the CPU too (:447-450)."""
    cpu, L = torch.device("cpu"), (1 << 24) + 1
    assert PP.resolve_engine("hybrid", cpu, 8, L) == "dense"
    assert PP.resolve_engine("hybrid", cpu, 8, L, shards=2) == "hybrid"
    assert PP.resolve_engine("hybrid", cpu, 8, 2 * L, shards=2) == "dense"
    assert PP.resolve_run_engine("auto", cpu, 20) == "dense"
    assert PP.resolve_run_engine("auto", cpu, 20, shards=2) == "batch"
    assert PP.resolve_run_engine("auto", cpu, 3, shards=2) == "hybrid"
    assert PP.resolve_run_engine("dense", cpu, 3, shards=2) == "hybrid"
    assert PP.resolve_run_engine("batch", cpu, 1, shards=4) == "hybrid"


@pytest.fixture(scope="module")
def synth_small(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    return synth(str(d), S=4, L=5000, COV=40, seed=3)


def _special(d, attr):
    return ProfileDir(d).get(attr)


@pytest.mark.parametrize("engine", ["hybrid", "batch"])
def test_profile_over_mesh_is_byte_identical(tmp_path, synth_small, engine):
    """profile() with mesh_devices=4 on --device cpu: every TSV, the
    stored covT, clonT and clonTR, Rdic and mapping_info byte for byte
    equal to the run with no mesh. Hybrid is the exception for clonT: on
    one device the host rebuilds clon from the int16 counts of the sparse
    wire (clon_cum16), over the mesh the position split takes the card's
    clon from int32 counts, as the JAX package's two-phase mesh path does;
    there clonT equals the dense engine's run, which takes the card's
    clon too."""
    fasta, bam, _ = synth_small
    outs = {}
    runs = (("one", "", []), ("mesh", "", ["--mesh_devices", "4"]))
    if engine == "hybrid":
        runs += (("dense", "dense", []),)
    for label, other, extra in runs:
        outs[label] = str(tmp_path / f"{label}.IS")
        assert port_main(["profile", bam, fasta, "-o", outs[label],
                          "--device", "cpu", "--engine", other or engine] +
                         FLAGS + extra) == 0
    with open(os.path.join(outs["mesh"], "log", "log.log")) as f:
        assert "Sharding the profile kernels over 4 devices" in f.read()
    for table in TABLES:
        texts = []
        for d in (outs["one"], outs["mesh"]):
            with open(os.path.join(d, "output", f"{os.path.basename(d)}_"
                                                f"{table}.tsv")) as f:
                texts.append(f.read())
        assert texts[0] == texts[1], table
    for attr in ("covT", "clonT", "clonTR"):
        want = "dense" if engine == "hybrid" and attr == "clonT" else "one"
        a, b = _special(outs[want], attr), _special(outs["mesh"], attr)
        assert list(a) == list(b)
        for s in a:
            assert list(a[s]) == list(b[s])
            for mm in a[s]:
                pd.testing.assert_series_equal(a[s][mm], b[s][mm],
                                               check_exact=True)
    for name in ("Rdic.json", "mapping_info.csv.gz"):
        blobs = []
        for d in (outs["one"], outs["mesh"]):
            path = os.path.join(d, "raw_data", name)
            blobs.append(pd.read_csv(path).to_csv() if name.endswith(".gz")
                         else open(path).read())
        assert blobs[0] == blobs[1], name

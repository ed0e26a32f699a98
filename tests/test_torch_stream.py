"""
The batch engine's overlapped stores in the port
(instrain_tpu_torch/store/profile_dir.py:SpecialStreamWriter and the
read-results and special-writes threads of profile/pipeline.py), against
the JAX package's (instrain_tpu/profile/pipeline.py:255-377).

- SpecialStreamWriter, fed the scaffolds in a shuffled order, against
  store(..., "special") over the same mapping: with h5py, the same
  dataset names, dtypes, compression filters and values, read back by the
  JAX package's ProfileDir; without h5py, the same pickle bytes; abort()
  registers nothing, close() registers once.
- `profile --engine batch --device cpu` against `instrain_tpu profile
  --engine batch`, with and without --skip_mm_profiling: attributes.tsv
  lists the same attributes with the same types and descriptions in the
  same order (covT/clonT/clonTR before scaffold_list), covT
  and clonT and clonTR are equal series by series, bit for bit (both
  engines send int16 counts over the sparse wire and rebuild clon on the
  host with native clon_cum16; under --skip_mm_profiling both send int32
  counts and take the device's clon), and Rdic and mapping_info are byte
  for byte (gzip decompressed); the read results and the special writes
  ran on their own threads.
- Without h5py, the batch run's three pickles are the bytes of the
  hybrid run's, which stores them serially.
- A kernel fault in the loop, a failing read-results store and a failing
  gather fail the run with no instrain-* thread left and no covT
  registered; one scaffold's failing write is logged as a
  SpecialWriteError and the run exits 0.

No tolerances.
"""

import gzip
import os
import threading

import numpy as np
import pandas as pd
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU here)

from instrain_tpu.cli import main as jax_main
from instrain_tpu.store.profile_dir import ProfileDir as JaxProfileDir
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.kernels.cuda_sitestats import KernelError
from instrain_tpu_torch.parallel import distributed as D
from instrain_tpu_torch.profile import compact as PC
from instrain_tpu_torch.profile import pipeline as PP
from instrain_tpu_torch.store import profile_dir as PD
from instrain_tpu_torch.synth import synth

FLAGS = ["--skip_genome_wide", "--skip_plot_generation"]
SPECIALS = ("covT", "clonT", "clonTR")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread for this module's runs, so that they do not
    contend with the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mapping(seed):
    """scaffold -> mm -> Series as the pipeline's views hold them: int64
    coverage, float32 clonality with NaN, positions from 0; one scaffold
    large enough for a compressed dataset (>= 8,192 elements), one empty
    series."""
    rng = np.random.default_rng(seed)
    out = {}
    for s, L in enumerate((5000, 17, 300, 1, 2400)):
        mm2 = {}
        for mm in range(s % 3 + 1):
            n = L if s == 0 else rng.integers(0, L + 1)
            idx = np.sort(rng.choice(L, size=n,
                                     replace=False)).astype(np.int64)
            if s % 2:
                vals = rng.random(len(idx)).astype(np.float32)
                vals[::7] = np.nan
            else:
                vals = rng.integers(0, 3000, len(idx)).astype(np.int64)
            mm2[mm * 2] = pd.Series(vals, index=idx)
        out[f"scaf_{s}"] = mm2
    return out


def _streamed(d, name, mapping, order_seed=0):
    pdir = PD.ProfileDir(str(d))
    writer = pdir.open_special_stream(name, "descr")
    names = list(mapping)
    np.random.default_rng(order_seed).shuffle(names)
    assert names != list(mapping)
    for s in names:
        writer.write(s, mapping[s])
    assert name not in pdir.keys()          # registered only on close()
    writer.close(list(mapping))
    return pdir


def _raw(pdir, name):
    return os.path.join(pdir.location, "raw_data",
                        os.path.basename(pdir._get_attributes().loc[
                            name, "value"]))


@pytest.mark.parametrize("name", ["covT", "clonTR"])
def test_stream_writer_matches_store_h5py(tmp_path, name):
    import h5py
    mapping = _mapping(3)
    serial = PD.ProfileDir(str(tmp_path / "serial"))
    serial.store(name, mapping, "special", "descr")
    streamed = _streamed(tmp_path / "streamed", name, mapping)
    a, b = _raw(serial, name), _raw(streamed, name)
    assert a.endswith(".hd5") and b.endswith(".hd5")
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert sorted(fa.keys()) == sorted(fb.keys())
        compressed = 0
        for k in fa.keys():
            x, y = fa[k], fb[k]
            assert (x.dtype, x.shape, x.compression, x.chunks) == \
                (y.dtype, y.shape, y.compression, y.chunks), k
            compressed += x.compression is not None
            assert np.array_equal(x[()], y[()], equal_nan=True), k
        assert compressed > 0
    want = JaxProfileDir(serial.location).get(name)
    got = JaxProfileDir(streamed.location).get(name)
    assert list(want) == list(mapping) and sorted(got) == sorted(want)
    for s in want:
        assert sorted(got[s]) == sorted(want[s])
        for mm in want[s]:
            pd.testing.assert_series_equal(got[s][mm], want[s][mm],
                                           check_exact=True)
    for s in mapping:
        for mm, series in mapping[s].items():
            np.testing.assert_array_equal(got[s][mm].values, series.values)


@pytest.mark.parametrize("name", ["covT", "clonT"])
def test_stream_writer_matches_store_pickle(tmp_path, monkeypatch, name):
    monkeypatch.setattr(PD, "_h5py", lambda: None)
    mapping = _mapping(4)
    serial = PD.ProfileDir(str(tmp_path / "serial"))
    serial.store(name, mapping, "special", "descr")
    streamed = _streamed(tmp_path / "streamed", name, mapping, order_seed=1)
    a, b = _raw(serial, name), _raw(streamed, name)
    assert a.endswith(".pickle") and b.endswith(".pickle")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got = streamed.get(name)
    assert list(got) == list(mapping)


@pytest.mark.parametrize("h5", [True, False])
def test_stream_writer_abort_and_close(tmp_path, monkeypatch, h5):
    if not h5:
        monkeypatch.setattr(PD, "_h5py", lambda: None)
    pdir = PD.ProfileDir(str(tmp_path / "p"))
    mapping = _mapping(5)
    before = pdir.keys()
    aborted = pdir.open_special_stream("clonT", "descr")
    aborted.write("scaf_0", mapping["scaf_0"])
    aborted.abort()
    aborted.close()                     # after abort: nothing registers
    assert pdir.keys() == before
    with pytest.raises(ValueError):
        aborted.write("scaf_1", mapping["scaf_1"])
    writer = pdir.open_special_stream("covT", "descr")
    for s, mm2 in mapping.items():
        writer.write(s, mm2)
    writer.close()
    writer.close()
    writer.abort()
    adb = pdir._get_attributes()
    assert list(adb.index) == before + ["covT"]
    assert adb.loc["covT", "type"] == "special"
    assert sorted(pdir.get("covT")) == sorted(mapping)


@pytest.fixture(scope="module")
def meta_data(tmp_path_factory):
    """17 scaffolds (tests/test_torch_batch.py's meta_data)."""
    d = tmp_path_factory.mktemp("meta")
    return synth(str(d), S=17, L=3000, COV=30, seed=5)


class ThreadSpy:
    """The thread names that ran the read-results store and the special
    writes of a profile run."""

    def __init__(self, monkeypatch):
        self.reads, self.writes = set(), set()
        store, write = PP._store_read_results, PD.SpecialStreamWriter.write

        def spy_store(*a, **k):
            self.reads.add(threading.current_thread().name)
            return store(*a, **k)

        def spy_write(w, *a, **k):
            self.writes.add(threading.current_thread().name)
            return write(w, *a, **k)

        monkeypatch.setattr(PP, "_store_read_results", spy_store)
        monkeypatch.setattr(PD.SpecialStreamWriter, "write", spy_write)


@pytest.fixture(scope="module")
def batch_runs(meta_data, tmp_path_factory):
    """The port's batch run (--device cpu) and the JAX package's, with and
    without --skip_mm_profiling, and the threads the port's ran on."""
    fasta, bam, _ = meta_data
    d = tmp_path_factory.mktemp("stream")
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for tag, extra in (("mm", []), ("skip_mm", ["--skip_mm_profiling"])):
            port, jx = str(d / f"port_{tag}.IS"), str(d / f"jax_{tag}.IS")
            spy = ThreadSpy(mp)
            PP.PHASES = {}
            try:
                assert port_main(["profile", bam, fasta, "-o", port,
                                  "--device", "cpu", "--engine", "batch"] +
                                 FLAGS + extra) == 0
                phases = PP.PHASES
            finally:
                PP.PHASES = None
                mp.undo()
            assert jax_main(["profile", bam, fasta, "-o", jx, "--engine",
                             "batch"] + FLAGS + extra) == 0
            out[tag] = (port, jx, spy, phases)
    finally:
        mp.undo()
    return out


def _attributes(d):
    adb = pd.read_csv(os.path.join(d, "raw_data", "attributes.tsv"),
                      sep="\t")
    return [(r["name"], r["type"], r["description"])
            for _, r in adb.iterrows()]


@pytest.mark.parametrize("tag", ["mm", "skip_mm"])
def test_batch_attributes_in_jax_order(batch_runs, tag):
    port, jx, spy, phases = batch_runs[tag]
    got, want = _attributes(port), _attributes(jx)
    assert got == want
    names = [n for n, _, _ in got]
    assert names.index("clonTR") < names.index("scaffold_list")
    assert spy.reads == {"instrain-store-reads"}
    assert spy.writes == {"instrain-hd5-stream"}
    assert phases["store_reads"] > 0 and phases["special_stream"] > 0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("instrain-")]


def _assert_same_specials(got, want, what):
    assert sorted(got) == sorted(want) and len(got) == 17, what
    for s in want:
        assert sorted(got[s]) == sorted(want[s]), (what, s)
        for mm in want[s]:
            pd.testing.assert_series_equal(got[s][mm], want[s][mm],
                                           check_exact=True)


@pytest.mark.parametrize("tag", ["mm", "skip_mm"])
def test_batch_specials_match_jax(batch_runs, tag):
    port, jx = batch_runs[tag][:2]
    want = {k: JaxProfileDir(jx).get(k) for k in SPECIALS}
    for pdir in (PD.ProfileDir(port), JaxProfileDir(port)):
        for k in SPECIALS:
            _assert_same_specials(pdir.get(k), want[k], k)


def _blob(d, name):
    path = os.path.join(d, "raw_data", name)
    with (gzip.open if name.endswith(".gz") else open)(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("tag", ["mm", "skip_mm"])
@pytest.mark.parametrize("name", ["mapping_info.csv.gz", "Rdic"])
def test_batch_read_results_match_jax(batch_runs, tag, name):
    port, jx = batch_runs[tag][:2]
    if name == "Rdic":
        name += ".pickle" if tag == "skip_mm" else ".json"
        if tag == "skip_mm":
            # a pickled set: its order is Python's set order in each
            # process, so the sets are held equal
            assert PD.ProfileDir(port).get("Rdic") == \
                JaxProfileDir(jx).get("Rdic")
            return
    assert _blob(port, name) == _blob(jx, name)


def test_batch_pickles_match_serial_store(meta_data, tmp_path, monkeypatch):
    """Without h5py (the GPU host), the batch run pickles covT, clonT and
    clonTR at its writers' close: the same bytes as the hybrid run's
    serial store, the kept scaffolds in the same order."""
    fasta, bam, _ = meta_data
    monkeypatch.setattr(PD, "_h5py", lambda: None)
    dirs = {}
    for engine in ("batch", "hybrid"):
        dirs[engine] = str(tmp_path / f"{engine}.IS")
        assert port_main(["profile", bam, fasta, "-o", dirs[engine],
                          "--device", "cpu", "--engine", engine] +
                         FLAGS) == 0
    names = {e: [n for n, _, _ in _attributes(d)] for e, d in dirs.items()}
    assert sorted(names["batch"]) == sorted(names["hybrid"])
    assert names["batch"].index("covT") < names["batch"].index(
        "scaffold_list") and names["hybrid"].index("covT") > \
        names["hybrid"].index("scaffold_list")
    for k in SPECIALS:
        blobs = [_blob(dirs[e], f"{k}.pickle") for e in dirs]
        assert len(blobs[0]) > 1000 and blobs[0] == blobs[1], k
    assert list(PD.ProfileDir(dirs["batch"]).get("covT")) == \
        PD.ProfileDir(dirs["batch"]).get("scaffold_list")


def _no_store_threads():
    return not [t for t in threading.enumerate()
                if t.name.startswith("instrain-")]


def _registered(out):
    return set(PD.ProfileDir(out).keys())


def test_kernel_fault_stops_the_threads(meta_data, tmp_path, monkeypatch):
    """A kernel fault in the batch loop fails the run: both threads are
    joined and no special attribute is registered."""
    fasta, bam, _ = meta_data

    def kernel_fault(*a, **k):
        raise KernelError("site_stats: launch failed")

    monkeypatch.setattr(PC, "_dispatch_chunk", kernel_fault)
    out = str(tmp_path / "k.IS")
    with pytest.raises(KernelError):
        port_main(["profile", bam, fasta, "-o", out, "--device", "cpu",
                   "--engine", "batch"] + FLAGS)
    assert _no_store_threads()
    assert not _registered(out) & set(SPECIALS + ("scaffold_list",))


def test_read_store_fault_fails_the_run(meta_data, tmp_path, monkeypatch):
    fasta, bam, _ = meta_data
    store = PP._store_read_results

    def failing(isdir, *a):
        store(isdir, *a)
        raise OSError("disk full")

    monkeypatch.setattr(PP, "_store_read_results", failing)
    out = str(tmp_path / "r.IS")
    with pytest.raises(OSError, match="disk full"):
        port_main(["profile", bam, fasta, "-o", out, "--device", "cpu",
                   "--engine", "batch"] + FLAGS)
    assert _no_store_threads()
    assert "Rdic" in _registered(out)
    assert not _registered(out) & set(SPECIALS + ("scaffold_list",))


def test_gather_fault_fails_the_run(meta_data, tmp_path, monkeypatch):
    """In process 0 of two (the collectives stood in for), a failing
    gather fails the run after the loop: the open writers are aborted."""
    fasta, bam, _ = meta_data
    monkeypatch.setattr(D, "process_count", lambda: 2)
    monkeypatch.setattr(D, "process_index", lambda: 0)
    monkeypatch.setattr(D, "my_scaffolds", lambda w: list(w))
    monkeypatch.setattr(PP, "_plan_sharded_decode", lambda *a: None)

    def gather_fault(*a, **k):
        raise RuntimeError("gather: peer lost")

    monkeypatch.setattr(PP, "_gather_results", gather_fault)
    out = str(tmp_path / "g.IS")
    with pytest.raises(RuntimeError, match="peer lost"):
        port_main(["profile", bam, fasta, "-o", out, "--device", "cpu",
                   "--engine", "batch"] + FLAGS)
    assert _no_store_threads()
    assert "Rdic" in _registered(out)
    assert not _registered(out) & set(SPECIALS + ("scaffold_list",))


def test_one_failed_write_is_contained(meta_data, tmp_path, monkeypatch):
    fasta, bam, _ = meta_data
    write = PD.SpecialStreamWriter.write

    def failing(w, scaffold, mm2series):
        if scaffold == "scaf_3":
            raise OSError("no space for scaf_3")
        return write(w, scaffold, mm2series)

    monkeypatch.setattr(PD.SpecialStreamWriter, "write", failing)
    out = str(tmp_path / "w.IS")
    assert port_main(["profile", bam, fasta, "-o", out, "--device", "cpu",
                      "--engine", "batch"] + FLAGS) == 0
    with open(os.path.join(out, "log", "log.log")) as f:
        log = f.read()
    assert "FAILURE SpecialWriteError scaf_3 no space for scaf_3" in log
    pdir = PD.ProfileDir(out)
    assert len(pdir.get("scaffold_list")) == 17
    for k in SPECIALS:
        got = pdir.get(k)
        assert "scaf_3" not in got and len(got) == 16, k
    assert _no_store_threads()

"""
The hybrid and batch engines' count wire in the port
(instrain_tpu_torch): int16 bucket-padded pileups, the delta-encoded
sparse counts, K8 (densify_sparse) and the host's clon_cum16, against the
JAX package's (instrain_tpu/io/bam.py:245-270, :406-463,
profile/pileup.py:99-146, kernels/sitestats.py:_densify_sparse,
profile/compact.py).

- The port's four native wrappers (build_counts_padded,
  pack_counts_sparse_d16_into, total_cum16, clon_cum16) against the JAX
  package's on synth BAMs, bit for bit; the padded builder's int32 route
  where an exact-mm count exceeds int16.
- densify_sparse_plain against JAX _densify_sparse (jitted on the CPU)
  and the int16 tensors the wire was packed from: an empty scaffold,
  counts of 254, 255, 256 and 32,767, a gap over 65,535 (its chained
  entry in the padding), zero-padded tails, a chunk of scaffolds of
  unequal lengths sliced into the port's layout, and the cases of K8's
  windows (synth.densify_case: Ltot % 4 != 0, windows over two rows and
  scaffolds, scaffolds with no entries in the middle and at the end, no
  entries at all, corrections in a window's first and last cell, one
  scaffold over many tiles), and a hypothesis fuzz; K8's launch geometry
  against a direct count; zero-value tails place nothing.
- The chunk planner never puts int16 and int32 pileups in one chunk.
- Where a scaffold's linkage counts exceed int16, clon is the card's
  (the JAX package's sparse path gives way to its two-phase path).
- `profile --device cpu --engine hybrid/batch` against `instrain_tpu
  profile` on the same engine: covT, clonT and clonTR bit for bit, the
  TSVs byte for byte, on a metagenome-shaped input and on one with an
  int16-overflow scaffold.
- A failing K8 fails the run: no dense fallback.
- On a GPU (marked cuda; skipped here): the kernel against its plain
  version at the cases above, with and without zero-value tails, into an
  output filled with a sentinel (every cell written).

No tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from instrain_tpu.cli import main as jax_main
from instrain_tpu.config import ReadFilterConfig as JaxFilterConfig
from instrain_tpu.io import bam as JB
from instrain_tpu.kernels.nullmodel import analytic_null_thresholds
from instrain_tpu.kernels.sitestats import _densify_sparse
from instrain_tpu.profile import compact as JC
from instrain_tpu.profile.filter_reads import filter_reads as jax_filter
from instrain_tpu.profile.pileup import ScaffoldPileup as JaxPileup
from instrain_tpu.profile.pileup import \
    build_scaffold_pileup_padded as jax_padded
from instrain_tpu.store.profile_dir import ProfileDir as JaxProfileDir
from instrain_tpu_torch.cli import main as port_main
from instrain_tpu_torch.config import ReadFilterConfig
from instrain_tpu_torch.io import bam as PB
from instrain_tpu_torch.kernels import cuda_compact as CC
from instrain_tpu_torch.kernels import sitestats as S
from instrain_tpu_torch.kernels.cuda_sitestats import KernelError
from instrain_tpu_torch.profile import compact as PC
from instrain_tpu_torch.profile import pileup as PP
from instrain_tpu_torch.profile.filter_reads import filter_reads
from instrain_tpu_torch.profile.pileup import ScaffoldPileup
from instrain_tpu_torch.synth import (DENSIFY_EDGE_CASES, densify_case,
                                      synth, synth_mixed,
                                      wire_with_zero_tail)

FLAGS = ["--skip_genome_wide", "--skip_plot_generation"]
TABLES = ("SNVs", "scaffold_info", "linkage", "mapping_info")
SPECIALS = ("covT", "clonT", "clonTR")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread for this module's runs, so that they do not
    contend with the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A metagenome-shaped input (8 scaffolds of 4 kb at 30x) and one with
    an int16-overflow scaffold (synth_mixed: four of 5 kb at 40x, one of
    1 kb at 30,000x)."""
    d = tmp_path_factory.mktemp("sparse")
    os.makedirs(d / "meta")
    os.makedirs(d / "mixed")
    return {"meta": synth(str(d / "meta"), S=8, L=4000, COV=30, seed=5),
            "mixed": synth_mixed(str(d / "mixed"))}


# ---------------------------------------------------------------- native


@pytest.fixture(scope="module")
def decoded(inputs):
    """Both packages' decodes of the mixed input and read pairs."""
    _, bam, _ = inputs["mixed"]
    pb, jb = PB.decode_bam(bam), JB.decode_bam(bam)
    return (pb, jb, filter_reads(pb, ReadFilterConfig()),
            jax_filter(jb, JaxFilterConfig()))


def _qid2mm(bam, n_mm, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-1, n_mm, bam.n_qnames).astype(np.int32)
    q[q == n_mm - 1] = -1           # an empty level, dropped
    return q


@pytest.mark.parametrize("rid", [0, 3, 4])
def test_build_counts_padded_matches_jax(decoded, rid):
    pb, jb = decoded[:2]
    L = int(pb.ref_lens[rid])
    if rid == 4:
        # 30,000x, every pair at one level: an exact-mm count over int16
        q = np.zeros(pb.n_qnames, np.int32)
        assert pb.build_counts_padded(rid, q, 1, L, 4096, 8) is None
        assert jb.build_counts_padded(rid, q, 1, L, 4096, 8) is None
        return
    q = _qid2mm(pb, 5, rid)
    got = pb.build_counts_padded(rid, q, 5, L, 8192, 8)
    want = jb.build_counts_padded(rid, q, 5, L, 8192, 8)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (got[1][-1], got[2][-1]) == (0, -1)
    assert got[0].dtype == np.int16 and got[0].any()


@pytest.fixture(scope="module")
def tensors(decoded):
    """int16 [8, 4, Lp] count tensors of the mixed input's shallow
    scaffolds, and one of counts at the saturation edges."""
    pb = decoded[0]
    out = []
    for rid in range(4):
        L = int(pb.ref_lens[rid])
        out.append(pb.build_counts_padded(rid, _qid2mm(pb, 4, rid), 4, L,
                                          8192, 8)[0])
    edge = np.zeros(3 * 4 * 5000, np.int16)
    edge[::97] = np.resize([254, 255, 256, 32767, 1, 0], len(edge[::97]))
    out.append(edge.reshape(3, 4, 5000))
    return out


def test_pack_counts_sparse_d16_matches_jax(tensors):
    for c in tensors:
        bufs = []
        for pack in (PB.pack_counts_sparse_d16_into,
                     JB.pack_counts_sparse_d16_into):
            n = int((c != 0).sum()) + c.size // 65535 + 1
            b = (np.zeros(n, np.uint16), np.zeros(n, np.uint8),
                 np.zeros(n, np.int32), np.zeros(n, np.int32))
            bufs.append((pack(c, *b), b))
        (got, a), (want, b) = bufs
        assert got == want and got[1] == int((c > 255).sum())
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
        # buffers of length 0 count without writing
        none = (np.zeros(0, np.uint16), np.zeros(0, np.uint8),
                np.zeros(0, np.int32), np.zeros(0, np.int32))
        assert PB.pack_counts_sparse_d16_into(c, *none) == got


@pytest.mark.parametrize("fn", ["total_cum16", "clon_cum16"])
def test_cum16_matches_jax(tensors, fn):
    for c in tensors:
        for n_mm in (1, 3):
            if fn == "total_cum16":
                pairs = [(PB.total_cum16(c, n_mm), JB.total_cum16(c, n_mm))]
            else:
                pairs = list(zip(PB.clon_cum16(c, n_mm, 5),
                                 JB.clon_cum16(c, n_mm, 5)))
            for a, b in pairs:
                assert a.dtype == b.dtype and a.shape == b.shape
                assert np.array_equal(a.view(np.int32), b.view(np.int32))


def test_padded_pileup_matches_jax(decoded, inputs):
    """build_scaffold_pileup_padded as the JAX package's: padded int16 with
    its true M, or the int32 builder's pileup where a count overflows."""
    pb, jb, pairs, jpairs = decoded
    for rid in range(5):
        L = int(pb.ref_lens[rid])
        got = PP.build_scaffold_pileup_padded(pb, pairs, rid, L)
        want = jax_padded(jb, jpairs, rid, L)
        assert got.true_M == want.true_M
        assert got.counts.dtype == want.counts.dtype
        assert np.array_equal(got.counts, want.counts)
        assert np.array_equal(got.counts_exact, want.counts_exact)
        assert np.array_equal(got.mm_values, want.mm_values)
        assert np.array_equal(got.qid2mmidx, want.qid2mmidx)
        assert (got.true_M is None) == (rid == 4)


# ---------------------------------------------------------------- K8


def _jax_wire(c, pad):
    """The JAX package's wire of one tensor: its packer into buffers
    `pad` entries (and corrections) longer than needed, zero-padded."""
    n, nc = JB.pack_counts_sparse_d16_into(
        c, np.zeros(0, np.uint16), np.zeros(0, np.uint8),
        np.zeros(0, np.int32), np.zeros(0, np.int32))
    b = (np.zeros(n + pad, np.uint16), np.zeros(n + pad, np.uint8),
         np.zeros(nc + pad, np.int32), np.zeros(nc + pad, np.int32))
    JB.pack_counts_sparse_d16_into(c, *b)
    return b


_jax_densify = jax.jit(_densify_sparse, static_argnames=("shape",))


def _wire_from_parts(parts, tensors, lengths):
    """A SparseWire from per-scaffold (deltas, vals, corr_idx, corr_val)
    buffers, zero-padded tails and all."""
    e = np.concatenate([[0], np.cumsum([len(p[0]) for p in parts])])
    c = np.concatenate([[0], np.cumsum([len(p[2]) for p in parts])])
    tiles = np.concatenate([[0], np.cumsum(
        [-(-len(p[0]) // S.WIRE_TILE) for p in parts])])
    lp = [t.shape[2] for t in tensors] + [0]
    off = np.concatenate([[0], np.cumsum(lengths)])
    table = torch.from_numpy(np.concatenate([e, c, tiles, lp, off]).astype(
        np.int64))
    cat = [torch.from_numpy(np.concatenate([p[k] for p in parts]))
           for k in range(4)]
    return S.SparseWire(table, cat[2], cat[3], cat[0].view(torch.int16),
                        cat[1], len(parts), int(tiles[-1]),
                        max(4 * t.shape[0] * t.shape[2] for t in tensors))


def _check_chunk(tensors, lengths, M, pad=0):
    """The chunk's wire (the port's exact stage_wire, and the JAX
    package's zero-padded buffers) densified by the plain version against
    JAX _densify_sparse and the tensors themselves, scaffold by scaffold
    at its segment; returns the port's wire and output."""
    Ltot = int(sum(lengths))
    refs = [np.zeros(L, np.uint8) for L in lengths]
    buf, layout = PC.stage_wire(tensors, lengths, refs)
    wire, _ = PC.wire_views(buf, layout)
    jparts = [_jax_wire(t, pad) for t in tensors]
    outs = [S.densify_sparse_plain(wire, M, Ltot),
            S.densify_sparse_plain(_wire_from_parts(jparts, tensors,
                                                    lengths), M, Ltot)]
    off = np.concatenate([[0], np.cumsum(lengths)])
    for s, (t, jp) in enumerate(zip(tensors, jparts)):
        want = np.asarray(_jax_densify(*[jnp.asarray(x) for x in jp],
                                       shape=t.shape))
        assert np.array_equal(want, t.astype(np.int32))
        for out in outs:
            got = out[:, :, off[s]:off[s + 1]].numpy()
            assert got.dtype == np.int32
            assert np.array_equal(got, want[:M, :, :lengths[s]]), s
    return wire, outs[0]


SENTINEL = 0x7F7F7F7F


def _staged(name, device):
    """(wire on `device`, M, Ltot, the plain version's output) of an edge
    case, the wire staged as the engines stage it."""
    tensors, lengths, M = _case(name)
    buf, layout = PC.stage_wire(tensors, lengths,
                                [np.zeros(L, np.uint8) for L in lengths])
    Ltot = sum(lengths)
    want = S.densify_sparse_plain(PC.wire_views(buf, layout)[0], M, Ltot)
    return PC.wire_views(buf.to(device), layout)[0], M, Ltot, want


def _case(name):
    """(tensors, true lengths, M) of the edge cases (synth.densify_case)."""
    return densify_case(name, seed=len(name))


@pytest.mark.parametrize("name", DENSIFY_EDGE_CASES)
@pytest.mark.parametrize("pad", [0, 5])
def test_densify_plain_matches_jax(name, pad):
    """pad: the JAX package's zero-padded tails of that many entries."""
    tensors, lengths, M = _case(name)
    wire, _ = _check_chunk(tensors, lengths, M, pad)
    if name == "gap":
        d = (wire.deltas.numpy().view(np.uint16))
        assert list(d) == [4618, 65535, 3586, 19989]
        assert list(wire.vals.numpy()) == [7, 0, 255, 2]
        assert list(wire.corr_idx.numpy()) == [73738]
        assert list(wire.corr_val.numpy()) == [45]


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(st.data())
def test_densify_plain_fuzz(data):
    n = data.draw(st.integers(1, 3))
    M = data.draw(st.integers(1, 4))
    tensors, lengths = [], []
    for s in range(n):
        L = data.draw(st.integers(1, 300))
        Lp = data.draw(st.sampled_from([L, 320]))
        density = data.draw(st.sampled_from([0.0, 0.05, 0.5, 1.0]))
        seed = data.draw(st.integers(0, 2 ** 16))
        rng = np.random.default_rng(seed)
        t = np.zeros((M + data.draw(st.integers(0, 2)), 4, Lp), np.int16)
        hi = data.draw(st.sampled_from([3, 300, 32768]))
        t[:M, :, :L] = rng.integers(0, hi, (M, 4, L)) * (
            rng.random((M, 4, L)) < density)
        tensors.append(t)
        lengths.append(L)
    _check_chunk(tensors, lengths, M, pad=data.draw(st.integers(0, 3)))


@pytest.mark.parametrize("n_scaffolds, M, Ltot", [(1, 1, 1), (1, 1, 2048),
                                        (2, 1, 2049), (3, 3, 3010),
                                        (5, 5, 17114), (1, 8, 2_500_000)])
@pytest.mark.parametrize("entries", [0, 1, 2048, 2049, 398_479])
def test_densify_geometry_counts(n_scaffolds, M, Ltot, entries):
    """K8's windows tile the flat output exactly, each aligned to 16
    bytes and a multiple of 4 cells, and its scratch holds a mark a window
    and a mark a row start (4 M + 1 a scaffold) for the entries and for the
    corrections (int64), a scaffold a window, a sum a tile and an index an
    entry (int32)."""
    n_cells = 4 * M * Ltot
    starts = list(range(0, n_cells, CC.DENSIFY_WINDOW))
    sizes = [min(CC.DENSIFY_WINDOW, n_cells - a) for a in starts]
    n_tiles = -(-entries // S.WIRE_TILE)
    windows, scratch = CC.densify_geometry(entries, n_tiles, n_scaffolds, M,
                                           Ltot)
    assert windows == len(starts)
    assert sum(sizes) == n_cells
    assert all(4 * a % 16 == 0 and n % 4 == 0 for a, n in zip(starts, sizes))
    marks = np.zeros(len(starts) + n_scaffolds * (4 * M + 1), np.int64)
    assert scratch == (2 * marks.nbytes +
                       np.zeros(len(starts) + n_tiles + entries,
                                np.int32).nbytes)


@pytest.mark.parametrize("name", DENSIFY_EDGE_CASES)
def test_densify_zero_tail_places_nothing(name):
    """wire_with_zero_tail's entries repeat each scaffold's last index and
    place nothing; densify_sparse on the CPU writes into `out`, every
    cell of it."""
    wire, M, Ltot, want = _staged(name, torch.device("cpu"))
    table = wire.table.clone()
    tailed = wire_with_zero_tail(wire, 3)
    assert torch.equal(wire.table, table)
    e_off, _, tile0, _, _ = tailed.rows()
    assert tailed.n_tiles == tile0[-1] == sum(
        -(-(e_off[s + 1] - e_off[s]) // S.WIRE_TILE) for s in range(wire.S))
    for s in range(wire.S):
        e = e_off[s + 1]
        assert not tailed.deltas[e - 3:e].any()
        assert not tailed.vals[e - 3:e].any()
    out = torch.full((M, 4, Ltot), SENTINEL, dtype=torch.int32)
    assert CC.densify_sparse(tailed, M, Ltot, out=out) is out
    assert torch.equal(out, want)
    with pytest.raises(KernelError, match="out must be"):
        CC.densify_sparse(wire, M, Ltot, out=out[:, :, 1:])


# ---------------------------------------------------------------- planner


def test_planner_never_mixes_wires():
    rng = np.random.default_rng(3)
    shapes = [(int(m), int(l), bool(w)) for m, l, w in zip(
        rng.choice([2, 3], 50), rng.integers(1, 3000, 50),
        rng.random(50) < 0.7)]
    chunks = PC.plan_chunks(shapes, 3 * 10_000)
    assert sorted(i for c in chunks for i in c) == list(range(50))
    for c in chunks:
        assert len({shapes[i][0] for i in c}) == 1
        assert len({shapes[i][2] for i in c}) == 1
    assert any(len(c) > 1 for c in chunks)
    # the bucket of a pileup: its true M and whether its counts are int16
    pu = ScaffoldPileup(name="a", rid=0, length=10, mm_values=np.arange(3),
                        counts=np.zeros((8, 4, 4096), np.int16), true_M=3)
    assert PC._bucket_of(pu) == (3, True)
    pu = ScaffoldPileup(name="a", rid=0, length=10, mm_values=np.arange(3),
                        counts=np.zeros((3, 4, 10), np.int32))
    assert PC._bucket_of(pu) == (3, False)


# ---------------------------------------------------------------- clon


@pytest.mark.parametrize("peak", [8000, 20000])
def test_linkage_overflow_takes_card_clon(peak):
    """A scaffold whose linkage counts at an SNV position exceed int16
    (two levels of `peak` each) takes the card's clon, as the JAX
    package's hybrid engine gives way to its two-phase path; below, the
    host's clon_cum16. Both equal the JAX package's bit for bit."""
    rng = np.random.default_rng(peak)
    L = 3000
    counts = (rng.integers(0, 30, (2, 4, L)) *
              (rng.random((2, 4, L)) < 0.4)).astype(np.int16)
    counts[:, 0, 100:140] = peak
    counts[:, 1, 100:140] = peak // 3
    counts[0, 2, 200:300] = peak + 7
    refs = rng.integers(0, 4, L).astype(np.uint8)
    kw = dict(name="s", rid=7, length=L, mm_values=np.array([0, 1]),
              counts=counts)
    lut = analytic_null_thresholds(max_coverage=10000)
    freq = S.freq_min_count_lut(0.05, max_coverage=10000)
    js = JC.run_site_stats_hybrid(JaxPileup(**kw), refs, lut, freq, seed=5)
    ps = PC.run_site_stats_hybrid(ScaffoldPileup(**kw), refs, lut, freq,
                                  seed=5, device="cpu")
    assert ps.linkage["n_pos"] > 0
    over = int(ps.linkage["cum"].max()) > PC.INT16_MAX
    assert over == (peak == 20000)
    assert ("clon" in ps.__dict__ and ps.min_cov is not None) or not over
    for k in ("clon", "clonR", "total"):
        a = np.asarray(getattr(js, k))
        b = getattr(ps, k)
        assert a.shape == b.shape
        assert np.array_equal(a.view(np.int32) if a.itemsize == 4 else a,
                              b.view(np.int32) if b.itemsize == 4 else b), k


# ---------------------------------------------------------------- profile


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """The port's (--device cpu) and the JAX package's profile of each
    input with --engine hybrid and batch."""
    d = tmp_path_factory.mktemp("runs")
    out = {}
    for name, (fasta, bam, _) in inputs.items():
        for engine in ("hybrid", "batch"):
            port = str(d / f"port_{name}_{engine}.IS")
            jx = str(d / f"jax_{name}_{engine}.IS")
            assert port_main(["profile", bam, fasta, "-o", port, "--device",
                              "cpu", "--engine", engine] + FLAGS) == 0
            assert jax_main(["profile", bam, fasta, "-o", jx, "--engine",
                             engine] + FLAGS) == 0
            out[name, engine] = (port, jx)
    return out


def _tsv(d, table):
    with open(os.path.join(d, "output",
                           f"{os.path.basename(d)}_{table}.tsv")) as f:
        return f.read()


@pytest.mark.parametrize("name", ["meta", "mixed"])
@pytest.mark.parametrize("engine", ["hybrid", "batch"])
def test_profile_matches_jax_engine(runs, name, engine):
    port, jx = runs[name, engine]
    for table in TABLES:
        got = _tsv(port, table)
        assert got.count("\n") > 1 and got == _tsv(jx, table), table
    for k in SPECIALS:
        got, want = JaxProfileDir(port).get(k), JaxProfileDir(jx).get(k)
        assert sorted(got) == sorted(want) and len(want) >= 5
        for s in want:
            assert sorted(got[s]) == sorted(want[s]), (k, s)
            for mm, w in want[s].items():
                g = got[s][mm]
                pd.testing.assert_series_equal(g, w, check_exact=True)
                if g.dtype == np.float32:
                    ok = ~np.isnan(w.values)
                    assert np.array_equal(g.values[ok].view(np.int32),
                                          w.values[ok].view(np.int32))


def test_overflow_scaffold_takes_int32(inputs, monkeypatch, tmp_path):
    """On the mixed input the batch engine sends the four shallow
    scaffolds over the sparse wire, in a chunk per mm extent (2 and 3),
    and the deep one (2 mm levels, int32 counts) dense, in a chunk of its
    own."""
    fasta, bam, _ = inputs["mixed"]
    chunks = []
    dispatch = PC._dispatch_chunk

    def spy(items, *a, **k):
        chunks.append(sorted((pu.name, pu.counts_exact.shape[0],
                              pu.counts.dtype.name) for _, pu, _ in items))
        return dispatch(items, *a, **k)

    monkeypatch.setattr(PC, "_dispatch_chunk", spy)
    assert port_main(["profile", bam, fasta, "-o", str(tmp_path / "b.IS"),
                      "--device", "cpu", "--engine", "batch"] + FLAGS) == 0
    assert sorted(chunks) == [
        [("scaf_0", 3, "int16"), ("scaf_2", 3, "int16")],
        [("scaf_1", 2, "int16"), ("scaf_3", 2, "int16")],
        [("scaf_4", 2, "int32")]]


@pytest.mark.parametrize("engine", ["hybrid", "batch"])
def test_densify_fault_fails_the_run(inputs, monkeypatch, tmp_path, engine):
    """A fault in K8 fails profile: the dense path never runs instead."""
    fasta, bam, _ = inputs["meta"]
    dense = []

    def fault(*a, **k):
        raise KernelError("densify_sparse: launch failed")

    monkeypatch.setattr(CC, "densify_sparse", fault)
    for name in ("site_stats_compact",):
        fn = getattr(CC, name)
        monkeypatch.setattr(CC, name, lambda *a, fn=fn, **k: (
            dense.append(1), fn(*a, **k))[1])
    monkeypatch.setattr(PP, "run_site_stats", lambda *a, **k: dense.append(
        1))
    with pytest.raises(KernelError, match="densify_sparse"):
        port_main(["profile", bam, fasta, "-o", str(tmp_path / "f.IS"),
                   "--device", "cpu", "--engine", engine] + FLAGS)
    assert not dense


# ---------------------------------------------------------------- GPU


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", DENSIFY_EDGE_CASES)
@pytest.mark.parametrize("tail", [0, 3])
def test_densify_kernel_matches_plain_on_gpu(name, tail, cuda_device):
    """K8 on the card into an output filled with a sentinel, so every cell
    is shown written; tail: zero-value entries after each scaffold's."""
    wire, M, Ltot, want = _staged(name, cuda_device)
    if tail:
        wire = wire_with_zero_tail(wire, tail)
    out = torch.full((M, 4, Ltot), SENTINEL, dtype=torch.int32,
                     device=cuda_device)
    CC.reset_launch_counts()
    got = CC.densify_sparse(wire, M, Ltot, out=out)
    torch.cuda.synchronize()
    assert got is out
    assert CC.launch_counts()["densify_sparse"] == 1
    assert torch.equal(got.cpu(), want)

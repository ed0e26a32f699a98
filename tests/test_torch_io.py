"""
The port's I/O against the JAX package: the synthetic BAM generator is
byte-identical to bench_batch.synth (its .bai too), and the port's own build of the
native decoder (with libdeflate, and with the zlib shim the GPU host
needs) decodes it to the same arrays as instrain_tpu's decoder.
"""

import os

import numpy as np
import pytest

from instrain_tpu.io import bam as jax_bam
from instrain_tpu_torch import build
from instrain_tpu_torch.io import bam as port_bam
from instrain_tpu_torch.synth import synth


@pytest.fixture(scope="module")
def synth_bam(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    return synth(str(d), S=3, L=5000, COV=30, seed=7)


@pytest.mark.parametrize("S,L,seed", [(3, 5000, 7), (2, 2400, 11)])
def test_synth_matches_bench_batch(tmp_path, S, L, seed):
    import bench_batch
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    old = bench_batch.S, bench_batch.L
    bench_batch.S, bench_batch.L = S, L
    try:
        fa_j, bam_j, n_j = bench_batch.synth(str(a), seed=seed)
    finally:
        bench_batch.S, bench_batch.L = old
    fa_p, bam_p, n_p = synth(str(b), S=S, L=L, COV=bench_batch.COV,
                             seed=seed)
    assert n_p == n_j
    assert open(fa_p, "rb").read() == open(fa_j, "rb").read()
    assert open(bam_p, "rb").read() == open(bam_j, "rb").read()
    # both write the minimal .bai beside the BAM: the same bytes
    assert open(bam_p + ".bai", "rb").read() == \
        open(bam_j + ".bai", "rb").read()


def _assert_same_decode(a, b):
    assert a.ref_names == b.ref_names
    assert np.array_equal(a.ref_lens, b.ref_lens)
    for f in ("ref_id", "pos", "flag", "mapq", "nm", "qname_id",
              "qlen_infer", "ref_start", "ref_end", "tlen", "mate_pos",
              "mate_ref", "ev_off", "ev_len", "pileup_ok", "ev_pos",
              "ev_base", "ev_qual"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.n_qnames == b.n_qnames
    assert a.qnames == b.qnames


def test_decode_matches_jax(synth_bam):
    _, bam, _ = synth_bam
    j = jax_bam.decode_bam(bam, baq=False)
    p = port_bam.decode_bam(bam, baq=False)
    assert p.n_records > 0 and len(p.ev_pos) > 0
    _assert_same_decode(j, p)
    # the port never loads the tracked library of the JAX package
    assert os.path.dirname(p._handle_obj.lib._name) == build.BUILD_DIR


def test_zlib_shim_decoder_matches(synth_bam, monkeypatch):
    """The decoder built over csrc/zlib_shim (used where libdeflate is
    not installed) decodes exactly like the libdeflate build."""
    _, bam, _ = synth_bam
    shim = port_bam.load_native(build.native_io_library(use_libdeflate=False))
    ref = port_bam.decode_bam(bam, baq=False)
    monkeypatch.setattr(port_bam, "_lib", shim)
    got = port_bam.decode_bam(bam, baq=False)
    assert got._handle_obj.lib is shim
    _assert_same_decode(ref, got)


def test_codes_to_str_and_splits_match_jax(synth_bam):
    """fasta.codes_to_str and ScaffoldRegistry.splits_of against the JAX
    package's (tests/test_io.py:31-58, on the synth FASTA), with codes
    past 4 written as N."""
    from instrain_tpu.io import fasta as jax_fasta
    from instrain_tpu_torch.io import fasta as port_fasta
    fa, _, _ = synth_bam
    for window in (5000, 1234, 10000):
        j = jax_fasta.ScaffoldRegistry.from_fasta(fa, window_length=window)
        p = port_fasta.ScaffoldRegistry.from_fasta(fa, window_length=window)
        assert p.names == j.names
        for name in p.names:
            assert p.splits_of(name) == j.splits_of(name)
            assert p.splits_of(name)[-1][1] == p.length_of(name) - 1
            codes = p.codes[name]
            assert port_fasta.codes_to_str(codes) == \
                jax_fasta.codes_to_str(codes)
            assert port_fasta.codes_to_str(codes[:10]) == \
                port_fasta.read_fasta(fa)[name][:10].tobytes().decode()
    codes = np.array([0, 1, 2, 3, 4, 5, 255, 0], np.uint8)
    assert port_fasta.codes_to_str(codes) == \
        jax_fasta.codes_to_str(codes) == "ACTGNNNA"


def test_records_of_ref_matches_jax(tmp_path):
    """BamArrays.records_of_ref over a whole and a ranged decode of a
    5-scaffold synth BAM (tests/test_bai.py:40-60), against the JAX
    package's decoder."""
    _, bam, _ = synth(str(tmp_path), S=5, L=4000, COV=20, seed=3)
    for scaffolds in (None, ["scaf_0", "scaf_3"]):
        j = jax_bam.decode_bam(bam, scaffolds=scaffolds)
        p = port_bam.decode_bam(bam, scaffolds=scaffolds)
        assert p.ranged == j.ranged == (scaffolds is not None)
        for name in scaffolds or p.ref_names:
            rid = p.name_to_ref_id[name]
            got, want = p.records_of_ref(rid), j.records_of_ref(rid)
            assert len(got) > 0 and np.array_equal(got, want), name
            assert (p.ref_id[got] == rid).all()


def _baq_cases():
    """(ref, pos, cigar, read, qual): tests/test_io.py:73-87's
    perfect-match read, then mismatches, an insertion, a deletion, soft
    clips, low qualities, a read off the reference's end and a spliced
    one (returned unchanged)."""
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 4, 500).astype(np.uint8)
    M, I, D, N, S = 0, 1, 2, 3, 4

    def cig(*ops):
        return np.array([(n << 4) | op for n, op in ops], np.uint32)

    read = ref[100:250].copy()
    cases = [(ref, 100, cig((150, M)), read, np.full(150, 38, np.uint8))]
    mism = read.copy()
    mism[[10, 11, 60, 149]] = (mism[[10, 11, 60, 149]] + 1) % 4
    cases.append((ref, 100, cig((150, M)), mism,
                  rng.integers(2, 41, 150).astype(np.uint8)))
    ins = np.concatenate([ref[200:260], [1, 2, 3], ref[260:320]])
    cases.append((ref, 200, cig((60, M), (3, I), (60, M)), ins,
                  np.full(123, 30, np.uint8)))
    dele = np.concatenate([ref[300:350], ref[355:420]])
    cases.append((ref, 300, cig((50, M), (5, D), (65, M)), dele,
                  rng.integers(10, 41, 115).astype(np.uint8)))
    clip = np.concatenate([[0, 0, 0, 0, 0], ref[20:120], [3, 3]])
    cases.append((ref, 20, cig((5, S), (100, M), (2, S)), clip,
                  np.full(107, 35, np.uint8)))
    cases.append((ref, 450, cig((50, M)), ref[450:500].copy(),
                  np.full(50, 3, np.uint8)))
    cases.append((ref, 480, cig((40, M)), rng.integers(0, 4, 40).astype(
        np.uint8), np.full(40, 40, np.uint8)))
    cases.append((ref, 10, cig((30, M), (100, N), (30, M)),
                  rng.integers(0, 4, 60).astype(np.uint8),
                  np.full(60, 37, np.uint8)))
    return cases


@pytest.mark.parametrize("case", range(8))
def test_baq_one_matches_jax(case):
    """io.bam.baq_one, through the port's own build of native/baq.cc,
    equals the JAX package's on every case; it never raises a quality,
    keeps most of a matching read's high, and leaves a spliced read's
    qualities as they were."""
    ref, pos, cigar, read, qual = _baq_cases()[case]
    got = port_bam.baq_one(ref, pos, cigar, read, qual)
    want = jax_bam.baq_one(ref, pos, cigar, read, qual)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    assert got.shape == qual.shape and (got <= qual).all()
    if case == 0:
        assert (got >= 30).mean() > 0.9
    if case == 7:
        assert np.array_equal(got, qual)

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

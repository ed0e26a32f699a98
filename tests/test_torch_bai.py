"""
io/bai.py against the JAX package's: the minimal .bai writer gives the
same bytes, the header and extent readers the same values, and the
port's ranged decode through its own index holds the same records as its
full decode (the pattern of tests/test_bai.py:30-66).
"""

import os
import shutil

import numpy as np
import pytest

from instrain_tpu.io import bai as JB
from instrain_tpu_torch.io import bai as PB
from instrain_tpu_torch.io.bam import decode_bam
from instrain_tpu_torch.synth import synth, synth_samples


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    """A synth BAM of 5 scaffolds of 6 kb and one synth_samples sample,
    each with the .bai its generator wrote beside it."""
    d = tmp_path_factory.mktemp("bai")
    os.makedirs(d / "a")
    os.makedirs(d / "b")
    _, bam_a, _ = synth(str(d / "a"), S=5, L=6000, COV=30, seed=7)
    _, sample_bams, _ = synth_samples(str(d / "b"), 2, 4, 5000, [12, 25],
                                      seed=5)
    return {"synth": (bam_a, 5), "sample": (sample_bams[1], 4)}


@pytest.mark.parametrize("which", ["synth", "sample"])
def test_make_bai_matches_jax(bams, tmp_path, which):
    bam, n_ref = bams[which]
    written = bam + ".bai"
    assert PB.find_bai(bam) == written
    want = str(tmp_path / "jax.bai")
    assert JB.make_bai(bam, want) == want
    assert PB.make_bai(bam, str(tmp_path / "port.bai")) == \
        str(tmp_path / "port.bai")
    with open(want, "rb") as f:
        want_bytes = f.read()
    for got in (str(tmp_path / "port.bai"), written):
        with open(got, "rb") as f:
            assert f.read() == want_bytes, got
    names = PB.read_bam_ref_names(bam)
    assert names == JB.read_bam_ref_names(bam)
    assert names == [f"scaf_{i}" for i in range(n_ref)]
    ext = PB.read_ref_extents(written)
    np.testing.assert_array_equal(ext, JB.read_ref_extents(written))
    assert len(ext) == n_ref and (ext > 0).all()


def test_find_bai(tmp_path):
    bam = str(tmp_path / "x.bam")
    open(bam, "wb").close()
    assert PB.find_bai(bam) is None
    open(str(tmp_path / "x.bai"), "wb").close()
    assert PB.find_bai(bam) == str(tmp_path / "x.bai")
    open(bam + ".bai", "wb").close()
    assert PB.find_bai(bam) == bam + ".bai"


@pytest.mark.parametrize("which", ["synth", "sample"])
def test_ranged_decode_holds_the_full_records(bams, tmp_path, which):
    bam, n_ref = bams[which]
    full = decode_bam(bam)
    want_names = ["scaf_0", f"scaf_{n_ref - 1}"]
    sub = decode_bam(bam, scaffolds=want_names)
    assert sub.ranged and not full.ranged
    assert set(sub.ref_id.tolist()) == {0, n_ref - 1}
    for name in want_names:
        a = np.flatnonzero(full.ref_id == full.name_to_ref_id[name])
        b = np.flatnonzero(sub.ref_id == sub.name_to_ref_id[name])
        assert len(a) == len(b) > 0
        for f in ("pos", "nm", "mapq", "flag", "ref_end"):
            np.testing.assert_array_equal(getattr(full, f)[a],
                                          getattr(sub, f)[b])
        qa = [full.qnames[i] for i in full.qname_id[a]]
        qb = [sub.qnames[i] for i in sub.qname_id[b]]
        assert qa == qb
    # without its index the same call decodes the whole BAM
    copy = str(tmp_path / "noindex.bam")
    shutil.copy(bam, copy)
    whole = decode_bam(copy, scaffolds=want_names)
    assert not whole.ranged and whole.n_records == full.n_records

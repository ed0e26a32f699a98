"""The input generator: the same seed writes the same bytes, every seed
the same amount of work, and the program's decoder reads what it wrote."""

import filecmp
import json
import os

import numpy as np
import pytest

from bench_helpers import ROOT, tiny_config
from benchmark.gen import reads


@pytest.mark.parametrize("name", ["metagenome", "isolate"])
def test_deterministic_by_seed(tmp_path, name):
    cfg = tiny_config(name)
    a = reads.write_inputs(cfg, 2 ** 31 + 11, str(tmp_path / "a"), threads=2)
    b = reads.write_inputs(cfg, 2 ** 31 + 11, str(tmp_path / "b"), threads=3)
    c = reads.write_inputs(cfg, 5, str(tmp_path / "c"), threads=2)
    for k in ("bam", "fasta", "stb"):
        if a[k] is None:
            continue
        assert filecmp.cmp(a[k], b[k], shallow=False), k
    assert filecmp.cmp(a["bam"] + ".bai", b["bam"] + ".bai", shallow=False)
    assert not filecmp.cmp(a["bam"], c["bam"], shallow=False)
    assert a["pairs"] == c["pairs"]


def test_same_work_for_every_seed():
    for name in ("metagenome", "isolate"):
        with open(os.path.join(ROOT, "benchmark", "configs",
                               name + ".json")) as f:
            cfg = json.load(f)
        lays = [reads.layout(cfg, s) for s in (0, 1, -3, 2 ** 31 + 99)]
        assert len({lay.total_pairs for lay in lays}) == 1
        assert len({tuple(sorted(lay.lengths)) for lay in lays}) == 1


def test_program_decodes_the_bam(tmp_path):
    from instrain_tpu_torch.io.bam import decode_bam
    cfg = tiny_config("metagenome")
    inp = reads.write_inputs(cfg, 9, str(tmp_path), threads=2)
    lay = inp["layout"]
    bam = decode_bam(inp["bam"], threads=2, baq=False)
    assert bam.n_records == 2 * inp["pairs"]
    for s in (0, len(lay.names) - 1):
        rd = reads.scaffold_reads(cfg, lay, s, 9)
        rid = bam.name_to_ref_id[lay.names[s]]
        mine = bam.ref_id == rid
        assert np.array_equal(np.sort(bam.pos[mine]), np.sort(rd["pos"]))
        assert np.array_equal(np.sort(bam.nm[mine]), np.sort(rd["nm"]))


def test_relatives_fail_the_read_filter():
    cfg = tiny_config("isolate")
    lay = reads.layout(cfg, 3)
    rd = reads.scaffold_reads(cfg, lay, 0, 3)
    nm = np.zeros(len(rd["insert"]), dtype=np.int64)
    np.add.at(nm, rd["pair"], rd["nm"])
    pid = 1 - nm / (2 * cfg["read_length"])
    assert (pid[rd["rel"]] <= 0.95).mean() > 0.85
    assert (pid[~rd["rel"]] > 0.95).mean() > 0.99


def test_every_seed_fills_the_same_mm_levels():
    """The isolate's pairs that pass the filter fill mm levels 0-14 for
    every seed, so the seed does not change the size of the mm axis."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "isolate.json")) as f:
        cfg = json.load(f)
    lay = reads.layout(cfg, 0)
    for seed in (1, 2 ** 31 + 7):
        rd = reads.scaffold_reads(cfg, lay, 0, seed)
        nm = np.zeros(len(rd["insert"]), dtype=np.int64)
        np.add.at(nm, rd["pair"], rd["nm"])
        passed = nm < 0.05 * 2 * cfg["read_length"]
        assert np.array_equal(np.unique(nm[passed]), np.arange(15))

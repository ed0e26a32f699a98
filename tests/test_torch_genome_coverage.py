"""
genome_coverage_info of the port (profile/genome.py: a running sum over
the mm levels, a histogram median, one sum of squared deviations for std
and SEM) against the JAX package's (a coverage array rebuilt at every
level, np.median, scipy.stats.sem, np.std) on synthetic covT: every
column equal with ==, NaN matched to NaN. The cases: levels with gaps,
--skip_mm_profiling's [1000], a scaffold absent from covT, scaffolds
under 200 bp, a genome with no positions, an even length whose middle
values differ by 1, two genomes (and one not relevant), and a 1 Mb
scaffold at 50x over 15 levels with GC-corrected iRep.
"""

import numpy as np
import pandas as pd
import pytest

from instrain_tpu.profile import genome as jax_genome
from instrain_tpu_torch.profile import genome as port_genome


def _split(rng, length, depth, levels, start=0):
    """mm -> Series: Poisson(depth) coverage at each position, a binomial
    share of what is left going to each mm in `levels` in turn."""
    left = rng.poisson(depth, length)
    out = {}
    for i, mm in enumerate(levels):
        take = (left if i == len(levels) - 1
                else rng.binomial(left, 0.6))
        left = left - take
        pos = np.flatnonzero(take)
        out[mm] = pd.Series(take[pos].astype("int32"), index=pos + start)
    return out


def _sequence(rng, length):
    return "".join(rng.choice(list("ACGT"), length))


def _gaps(rng):
    s2l = {"a": 5000, "b": 3000}
    covT = {"a": _split(rng, 5000, 20, range(6)),
            "b": _split(rng, 3000, 8, [0, 1, 3])}
    return covT, {"g": {"a", "b"}}, s2l, None, [0, 2, 5]


def _skip_mm(rng):
    covT, b2s, s2l, seqs, _ = _gaps(rng)
    return covT, b2s, s2l, seqs, [1000]


def _absent(rng):
    s2l = {"a": 5000, "b": 4000}
    covT = {"a": _split(rng, 5000, 12, [0, 1, 2])}
    return covT, {"g": {"a", "b"}}, s2l, None, [0, 1, 2]


def _short(rng):
    s2l = {"a": 5000, "c": 150, "d": 200, "e": 201}
    covT = {"a": _split(rng, 5000, 12, [0, 1]),
            "c": _split(rng, 150, 30, [0, 1]),
            "d": _split(rng, 200, 30, [0, 1]),
            "e": _split(rng, 201, 30, [0, 1])}
    return covT, {"g": set(s2l)}, s2l, None, [0, 1]


def _empty(rng):
    s2l = {"c": 150, "d": 120}
    covT = {"c": _split(rng, 150, 30, [0, 1])}
    return covT, {"g": {"c", "d"}}, s2l, None, [0, 1]


def _even(rng):
    # 1,000 kept positions, 500 at 3x and 500 at 4x (shuffled), deep edges
    kept = np.repeat([3, 4], 500)
    rng.shuffle(kept)
    cov = np.concatenate([np.full(100, 90), kept, np.full(100, 90)])
    s2l = {"a": 1200}
    covT = {"a": {0: pd.Series(cov.astype("int32"), index=np.arange(1200))}}
    return covT, {"g": {"a"}}, s2l, None, [0]


def _two_genomes(rng):
    s2l = {"a": 6000, "b": 2500, "c": 8000, "d": 700, "e": 3000}
    covT = {s: _split(rng, n, 6 + 5 * i, range(4))
            for i, (s, n) in enumerate(s2l.items())}
    b2s = {"g0": {"a", "b"}, "g1": {"c", "d"}, "other": {"e"}}
    seqs = {s: _sequence(rng, n) for s, n in s2l.items()}
    return covT, b2s, s2l, seqs, [0, 1, 2, 3]


def _large(rng):
    n = 1_000_000
    covT = {"chr": _split(rng, n, 50, range(15))}
    return covT, {"g": {"chr"}}, {"chr": n}, {"chr": _sequence(rng, n)}, \
        list(range(15))


CASES = {"gaps": _gaps, "skip_mm": _skip_mm, "absent": _absent,
         "short": _short, "empty": _empty, "even": _even,
         "two_genomes": _two_genomes, "large": _large}


def _relevant(b2s):
    return {g for g in b2s if g != "other"}


@pytest.mark.parametrize("case", list(CASES))
def test_genome_coverage_info_equals_jax(case):
    covT, b2s, s2l, seqs, mms = CASES[case](np.random.default_rng(7))
    want = jax_genome.genome_coverage_info(covT, b2s, _relevant(b2s), s2l,
                                           seqs, mms)
    got = port_genome.genome_coverage_info(covT, b2s, _relevant(b2s), s2l,
                                           seqs, mms)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) == len(mms) * len(_relevant(b2s))
    for col in want.columns:
        a, b = got[col].to_numpy(), want[col].to_numpy()
        assert a.dtype == b.dtype, col
        same = (a == b) | (pd.isna(a) & pd.isna(b))
        assert same.all(), (col, a, b)
    if case == "empty":
        assert list(got["coverage_median"]) == [0, 0]
        assert got["coverage_SEM"].isna().all()
        assert list(got["coverage_std"]) == [0.0, 0.0]
    if case == "even":
        assert list(got["coverage_median"]) == [3]


def test_each_series_added_once():
    covT, b2s, s2l, seqs, mms = _two_genomes(np.random.default_rng(7))
    mms = mms[:-1]
    relevant = _relevant(b2s)
    expected = sum(mm <= mms[-1] for g in relevant for s in b2s[g]
                   for mm in covT[s])
    before = port_genome.genome_coverage_info.series_added
    port_genome.genome_coverage_info(covT, b2s, relevant, s2l, seqs, mms)
    assert port_genome.genome_coverage_info.series_added - before == expected


@pytest.mark.parametrize("bad", ["descending", "float_counts"])
def test_genome_coverage_info_rejects(bad):
    covT, b2s, s2l, seqs, mms = _gaps(np.random.default_rng(7))
    if bad == "descending":
        mms = mms[::-1]
    else:
        covT["a"][0] = covT["a"][0].astype(float)
    with pytest.raises(ValueError):
        port_genome.genome_coverage_info(covT, b2s, {"g"}, s2l, seqs, mms)

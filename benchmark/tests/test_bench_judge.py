"""The comparison's own rules: an exact count differs by any cell, a
value on one side only reads ONE_SIDED, and D' at an exact D of 0 reads
0 on both sides whichever rounding left it NaN."""

import numpy as np
import pandas as pd

from benchmark.harness import judge


def _link(d_prime, counts=((10, 10, 10, 10), (20, 0, 0, 20))):
    idx = pd.MultiIndex.from_tuples(
        [("s", 1, 2), ("s", 3, 4)],
        names=["scaffold", "position_A", "position_B"])
    AB, Ab, aB, ab = zip(*counts)
    return pd.DataFrame(dict(
        distance=[1, 1], allele_A=["A", "A"], allele_a=["C", "C"],
        allele_B=["G", "G"], allele_b=["T", "T"], total=[40, 40],
        countAB=AB, countAb=Ab, countaB=aB, countab=ab, r2=[0.0, 1.0],
        d_prime=d_prime), index=idx)


def _compare(a, b):
    return judge._tables(judge._settle_d_prime(a), judge._settle_d_prime(b),
                         judge.LINK_EXACT, judge.LINK_FLOAT)


def test_d_prime_at_an_exact_zero():
    assert _compare(_link([np.nan, 1.0]), _link([-0.0, 1.0])) == (0, 0.0)
    assert _compare(_link([np.nan, 1.0]), _link([np.nan, np.nan]))[1] == \
        judge.ONE_SIDED


def test_counts_and_one_sided_values():
    a = _link([0.0, 1.0])
    b = a.copy()
    b.loc[("s", 3, 4), "countAB"] = 21
    assert _compare(a, b)[0] == 1
    assert _compare(a, a.iloc[:1])[0] == 1
    g = judge._gap(np.array([np.nan, 1.0]), np.array([np.nan, 1.0 + 1e-9]))
    assert 0 < g < 1e-8
    assert judge._gap(np.array([1.0]), np.array([np.nan])) == judge.ONE_SIDED


def _genome(irep=1.1, corrected=True, median=40, std=5.0):
    return pd.DataFrame(dict(
        length=[10000], true_scaffolds=[2], detected_scaffolds=[2],
        SNS_count=[0], SNV_count=[5], filtered_read_pair_count=[900],
        coverage_median=[median], iRep_GC_corrected=[corrected],
        coverage=[40.0], breadth=[1.0], nucl_diversity=[0.01],
        breadth_minCov=[1.0], coverage_std=[std], coverage_SEM=[0.05],
        iRep=[irep]), index=pd.Index(["g"], name="genome"))


def test_genome_coverage_and_irep_are_held():
    def gi(**kw):
        return judge._tables(_genome(**kw), _genome(), [],
                             judge.GENOME_COVERAGE)[1]
    lim = judge.LIMITS["genome_coverage_gap"]
    assert gi() == 0.0
    assert gi(irep=1.1 + 10 * lim) > lim
    assert gi(std=5.0 * (1 + 10 * lim)) > lim
    assert gi(irep=np.nan) == judge.ONE_SIDED
    both = judge._tables(_genome(irep=np.nan), _genome(irep=np.nan), [],
                         judge.GENOME_COVERAGE)
    assert both == (0, 0.0)
    for kw in (dict(median=41), dict(corrected=False)):
        assert judge._tables(_genome(**kw), _genome(), judge.GENOME_INT,
                             [])[0] == 1

"""The comparison fails what it must: the control (the reference one step
below the stated precision, in the program's place), and a run of the
harness on the CPU with the timed path broken underneath, once for each
fault this system's cells can have: an answer altered where it is
produced, and half of the batch (of a chunk's scaffolds) left out. A sound
run of the same harness is correct."""

import pytest

from bench_helpers import load_run_module, tiny_config, tiny_manifest
from benchmark.control import control_numbers
from benchmark.harness import judge


@pytest.mark.parametrize("name", ["metagenome", "isolate"])
def test_control_is_not_correct(name):
    nums = control_numbers(tiny_config(name), 2 ** 31 + 5)
    assert not judge.verdict(nums)
    assert nums["clonT_rel_gap"] > judge.LIMITS["clonT_rel_gap"]


def _alter_snv_counts(monkeypatch):
    from instrain_tpu_torch.profile import tables
    real = tables.snp_table

    def altered(stats, ref_codes):
        df = real(stats, ref_codes)
        if len(df):
            df.loc[df.index[0], "A"] += 1
        return df
    monkeypatch.setattr(tables, "snp_table", altered)


def _drop_half(monkeypatch):
    from instrain_tpu_torch.profile import pipeline
    real = pipeline._profile_one_scaffold
    calls = []

    def half(*a, **kw):
        calls.append(1)
        return real(*a, **kw) if len(calls) % 2 else None
    monkeypatch.setattr(pipeline, "_profile_one_scaffold", half)


@pytest.mark.parametrize("fault,expect", [(None, True),
                                          ("altered", False),
                                          ("half", False)])
def test_harness_judges_the_timed_path(monkeypatch, fault, expect):
    if fault == "altered":
        _alter_snv_counts(monkeypatch)
    elif fault == "half":
        _drop_half(monkeypatch)
    run = load_run_module()
    man = tiny_manifest("metagenome")
    cell = next(w for w in man["workloads"]
                if w["name"] == "metagenome.profile")
    res = run.run_cell(man, cell, 4242, 0.5, False, device="cpu")
    assert res["correct"] is expect, res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    # a cell that names no checks compares the base numbers, no other
    assert {k: v["limit"] for k, v in res["compared"].items()} == judge.LIMITS

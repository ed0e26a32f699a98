"""BENCHMARK.json against the benchmark's contract: its keys, names, units
and limits, and that every name it gives finds its file."""

import json
import os
import re

import pytest

from bench_helpers import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_names(man):
    assert set(man) == KEYS["top"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[part]]
        assert len(names) == len(set(names)), part
        for e in man[part]:
            allowed = KEYS[part] | ({"workloads"} if part in
                                    ("end_to_end", "per_layer") else set())
            assert KEYS[part] <= set(e) <= allowed, (part, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for c in man["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in man["per_layer"]:
        assert _line(m["layer"])


def test_paths_command_and_files(man):
    assert 1 <= len(man["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in man["paths"])
    assert len(man["command"]) <= 32 and all(_line(w) for w in man["command"])
    under = lambda f: any(f == p or f.startswith(p + "/")  # noqa: E731
                          for p in man["paths"])
    for word in man["command"][1:]:
        assert under(word), word
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert under(f) and os.path.exists(os.path.join(ROOT, f))


def test_metrics_and_bounds(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        path = os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py")
        assert os.path.exists(path), m["name"]
    layers = {}
    for m in man["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_cells(man):
    configs = {c["name"] for c in man["configs"]}
    assert {w["config"] for w in man["workloads"]} == configs
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)
    for w in man["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic",
                                           w["traffic"] + ".json"))
        e2e = [m["name"] for m in man["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in man["per_layer"])


def test_run_seconds_fit_a_full_check(man):
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_config_files_state_their_cuts(man):
    for c in man["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert all(k in cfg for k in c["reduced"])
        assert "assumed" in cfg and "precision" in cfg["assumed"]


def test_manifest_is_small(man):
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10

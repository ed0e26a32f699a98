"""The harness on the card (marked `cuda`: skips without one), and its
refusal to run without one."""

import json
import os
import subprocess
import sys

import pytest

from bench_helpers import ROOT


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(cuda_device):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "metagenome.profile", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "1"], capture_output=True, text=True, timeout=900,
        cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    assert res["device"]["busy_s"] > 0
    assert 0 < res["metrics"]["device_idle_pct"]["value"] < 100


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "isolate.profile", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""

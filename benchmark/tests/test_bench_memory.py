"""The peak-memory reading: the watcher process sees an allocation that
comes and goes between start and stop, and ends when stopped."""

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.harness import memory  # noqa: E402


def _watched() -> memory.PeakRSS:
    """A PeakRSS on its watcher path, as where clear_refs is refused."""
    p = memory.PeakRSS()
    p.mode = "watcher"
    p._start = memory.resident()
    p._proc = subprocess.Popen(
        [sys.executable, "-S", "-c", memory._WATCHER, str(os.getpid())],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    return p


def test_watcher_sees_a_passing_peak():
    p = _watched()
    time.sleep(0.2)
    before = memory.resident()
    a = np.ones(200 * 2 ** 20 // 8)
    time.sleep(0.2)
    del a
    time.sleep(0.05)
    proc = p._proc
    peak = p.stop()
    assert peak >= before + 190 * 2 ** 20
    assert proc.returncode is not None and p._proc is None


def test_close_ends_the_watcher():
    p = _watched()
    proc = p._proc
    p.close()
    assert proc.returncode is not None

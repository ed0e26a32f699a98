"""
Peak resident memory of this process over a window: the kernel's high
water mark (VmHWM), reset when the window opens by writing 5 to
/proc/self/clear_refs; where the kernel refuses that, a small watcher
process that reads this process's resident size (VmRSS) every 10 ms. The
watcher is a process of its own, not a thread, so that it never takes
the measured process's interpreter lock. `mode` says which one measured.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

_KEY = r"^{key}:\s+(\d+) kB"

# the watcher: reads /proc/<pid>/status every 10 ms until its standard
# input closes, then prints the largest VmRSS it saw, in bytes
_WATCHER = r"""
import re, select, sys
path = "/proc/%s/status" % sys.argv[1]
pat = re.compile(r"^VmRSS:\s+(\d+) kB", re.M)
peak = 0
while True:
    with open(path) as f:
        peak = max(peak, int(pat.search(f.read()).group(1)) * 1024)
    if select.select([sys.stdin], [], [], 0.01)[0]:
        break
print(peak, flush=True)
"""


def _status(key: str, pid: str = "self") -> int:
    with open(f"/proc/{pid}/status") as f:
        m = re.search(_KEY.format(key=key), f.read(), re.M)
    return int(m.group(1)) * 1024


def resident() -> int:
    """This process's resident memory now, in bytes."""
    return _status("VmRSS")


class PeakRSS:
    def __init__(self):
        self.mode = None
        self._proc = None
        self._start = 0

    def start(self) -> None:
        try:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
            ok = _status("VmHWM") <= _status("VmRSS") * 1.05 + (1 << 20)
        except OSError:
            ok = False
        if ok:
            self.mode = "VmHWM after clear_refs"
            return
        self.mode = "VmRSS read every 10 ms by a watcher process"
        self._start = _status("VmRSS")
        self._proc = subprocess.Popen(
            [sys.executable, "-S", "-c", _WATCHER, str(os.getpid())],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def stop(self) -> int:
        """The peak in bytes since start()."""
        if self._proc is None:
            return _status("VmHWM")
        now = _status("VmRSS")
        try:
            out, _ = self._proc.communicate("stop\n", timeout=60)
            seen = int(out.strip() or 0)
        finally:
            if self._proc.poll() is None:
                self._proc.kill()
                self._proc.wait()
            self._proc = None
        return max(self._start, seen, now)

    def close(self) -> None:
        """Ends the watcher if stop() was never reached."""
        if self._proc is not None:
            self._proc.kill()
            self._proc.wait()
            self._proc = None

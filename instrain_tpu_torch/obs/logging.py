"""
Observability: checkpoint/worker logging and runtime reports
(reference: inStrain/logUtils.py — log_checkpoint 904-938, get_worker_log
939-1012, load_log 85-238, report_run_stats 25-83).

The log grammar is kept compatible so `other --run_statistics` style
parsing works on either implementation's logs:
  "Checkpoint <class> <name> <start|end> <RAM> <time>"
  "WorkerLog <class> <unit> <start|end> <time> <PID> <RAM>"
  "FAILURE <type> <unit> ..."
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import defaultdict
from typing import Optional

import pandas as pd

try:
    import psutil
except ImportError:  # psutil is expected in the image, but stay safe
    psutil = None


_CHILD_RAM_TTL_S = 5.0
_child_ram_cache = [0.0, 0]  # [monotonic stamp, bytes]


def _ram() -> int:
    """RSS of this process + children (reference: logUtils psutil usage
    incl. children). The children walk reads /proc for EVERY process on
    the host (~20 ms here) and worker-log lines are emitted per
    scaffold, so the children total is cached for a few seconds — self
    RSS (cheap) stays exact per call; child processes (samtools prep,
    multi-host peers) change on a much slower timescale than scaffolds
    profile."""
    if psutil is None:
        return 0
    try:
        process = psutil.Process(os.getpid())
        mem = process.memory_info().rss
        now = time.monotonic()
        if now - _child_ram_cache[0] > _CHILD_RAM_TTL_S:
            kids = 0
            for child in process.children(recursive=True):
                try:
                    kids += child.memory_info().rss
                except Exception:
                    pass
            _child_ram_cache[0] = now
            _child_ram_cache[1] = kids
        return mem + _child_ram_cache[1]
    except Exception:
        return 0


def log_checkpoint(klass: str, name: str, status: str):
    """reference: logUtils.log_checkpoint (904-938)."""
    assert status in ("start", "end"), status
    logging.debug(f"Checkpoint {klass} {name} {status} {_ram()} "
                  f"{time.time()}")


def get_worker_log(klass: str, unit, status: str) -> str:
    """reference: logUtils.get_worker_log (939-976)."""
    assert status in ("start", "end"), status
    return (f"\nWorkerLog {klass} {unit} {status} {time.time()} "
            f"{os.getpid()} {_ram()}")


def log_failure(failure_type: str, unit: str, detail: str = ""):
    """Structured failure line; run continues (reference: per-worker
    try/except FAILURE logging, e.g. profile_utilities.py:92-112)."""
    t = time.strftime("%m-%d %H:%M")
    logging.debug(f"{t} DEBUG FAILURE {failure_type} {unit} {detail}")


def setup_logger(loc: Optional[str]):
    """DEBUG -> file, INFO -> console (reference: controller.py:445-475);
    with loc None, only INFO -> console (a process that writes no
    profile directory)."""
    if logging.getLogger("").handlers:
        return
    if loc is None:
        logging.basicConfig(level=logging.INFO, format="%(message)s")
        return
    logging.basicConfig(level=logging.DEBUG,
                        format="%(asctime)s %(levelname)-8s %(message)s",
                        datefmt="%y-%m-%d %H:%M:%S", filename=loc)
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(logging.Formatter("%(message)s"))
    logging.getLogger("").addHandler(console)
    logging.debug("!" * 80)
    logging.debug(f"***Logger started up at {loc}***")
    logging.debug("Command was: {0}\n".format(" ".join(sys.argv)))


def load_log(logloc: str) -> pd.DataFrame:
    """Parse checkpoint/worker/failure lines back into a table
    (reference: logUtils.load_log 85-238, simplified schema)."""
    table = defaultdict(list)
    with open(logloc) as f:
        for line in f:
            parts = line.strip().split()
            for marker, kind in (("Checkpoint", "checkpoint"),
                                 ("WorkerLog", "worker"),
                                 ("FAILURE", "failure")):
                if marker in parts:
                    i = parts.index(marker)
                    rest = parts[i + 1:]
                    table["log_type"].append(kind)
                    table["class"].append(rest[0] if rest else "")
                    table["name"].append(rest[1] if len(rest) > 1 else "")
                    table["status"].append(rest[2] if len(rest) > 2 else "")
                    table["rest"].append(" ".join(rest[3:]))
                    break
    return pd.DataFrame(table)


# failure-class explanations (reference: _gen_failures_report,
# logUtils.py:707-767)
_FAILURE_TEXT = {
    "FilterReads": "The following scaffolds were not in the bam file:",
    "SplitException": "The following scaffolds failed during profiling:",
    "MergeError": ("The following scaffolds could not be profiled due to "
                   "merging errors:"),
    "GeneException": ("Genes on the following scaffolds could not be "
                      "profiled due to errors during profiling:"),
    "StbError": ("The following scaffolds were in the .stb file given, "
                 "but not the original .fasta file used for profiling. "
                 "They will not be considered in genomeLevel operations:"),
    "iRepError": ("The following genomes failed to calculate iRep for an "
                  "unknown reason:"),
    "CompareException": "The following scaffolds failed during compare:",
}


def _section(title: str) -> str:
    return ("\n.:: " + title + " ::.\n")


def _checkpoint_section(cps, klass: str, overall: Optional[float]) -> str:
    """Per-checkpoint runtimes + RAM deltas for one checkpoint class
    (reference: gen_checkpoint_report, logUtils.py:587-655)."""
    db = cps[cps["class"] == klass]
    if not len(db):
        return ""
    out = []
    times = {}
    for name, ndb in db.groupby("name", sort=False):
        try:
            s = ndb[ndb.status == "start"]["rest"].iloc[0].split()
            e = ndb[ndb.status == "end"]["rest"].iloc[-1].split()
            t0, t1 = float(s[-1]), float(e[-1])
            ram0, ram1 = int(s[0]), int(e[0])
            times[name] = (t0, t1, ram0, ram1)
        except (ValueError, IndexError):
            out.append(f"{name:24s} started and never finished")
    total = overall
    if total is None and times:
        total = max(t1 for _, t1, _, _ in times.values()) - \
            min(t0 for t0, _, _, _ in times.values())
    for name, (t0, t1, ram0, ram1) in times.items():
        pct = 100.0 * (t1 - t0) / total if total else 0.0
        inc = "increased" if ram1 >= ram0 else "decreased"
        out.append(f"{name:24s} took {t1 - t0:9.1f}s ({pct:5.1f}% of "
                   f"overall)\tRAM went from {humanbytes(ram0)} to "
                   f"{humanbytes(ram1)} ({inc} by "
                   f"{humanbytes(abs(ram1 - ram0))})")
    return "\n".join(out)


def _worker_class_section(db) -> str:
    """Parallel-efficiency report for one worker class (reference:
    gen_multiprocessing_text, logUtils.py:372-423): wall vs summed unit
    time, concurrency, efficiency, per-unit stats, RAM."""
    units = []
    for unit, udb in db.groupby("name"):
        try:
            s = udb[udb.status == "start"]["rest"].iloc[0].split()
            e = udb[udb.status == "end"]["rest"].iloc[-1].split()
            units.append(dict(unit=unit, t0=float(s[0]), t1=float(e[0]),
                              pid=s[1], ram0=int(s[2]), ram1=int(e[2])))
        except (ValueError, IndexError):
            continue
    if not units:
        return ""
    wall = max(u["t1"] for u in units) - min(u["t0"] for u in units)
    wall = max(wall, 1e-9)
    par = sum(u["t1"] - u["t0"] for u in units)
    pids = sorted({u["pid"] for u in units})
    durs = sorted(u["t1"] - u["t0"] for u in units)
    n = len(durs)
    longest = max(units, key=lambda u: u["t1"] - u["t0"])
    lines = [
        f"{'Wall time':32s}\t{wall:.1f}s",
        f"{'Total processes used':32s}\t{len(pids)}",
        f"{'Average number processes used':32s}\t{par / wall:.1f}",
        f"{'Parallelization efficiency':32s}\t"
        f"{100.0 * par / wall / len(pids):.1f}%",
        f"{'Units profiled':32s}\t{n}",
        f"{'Average time per unit':32s}\t{par / n:.2f}s",
        f"{'Median time per unit':32s}\t{durs[n // 2]:.2f}s",
        f"{'Maximum unit time':32s}\t{durs[-1]:.2f}s",
        f"{'Longest running unit':32s}\t{longest['unit']} "
        f"({longest['t1'] - longest['t0']:.2f}s)",
        f"{'Per-unit RAM increase (mean)':32s}\t"
        f"{humanbytes(sum(u['ram1'] - u['ram0'] for u in units) / n)}",
    ]
    return "\n".join(lines)


def _failures_section(fails) -> str:
    """Failure-class breakdown with the reference's explanations
    (reference: _gen_failures_report, logUtils.py:707-767)."""
    if not len(fails):
        return "No failures"
    out = []
    for ftype, db in fails.groupby("class"):
        text = _FAILURE_TEXT.get(
            ftype, f"I dont know how to report {ftype} failures — units:")
        out.append(text)
        for _, row in db.iterrows():
            out.append(f"  {row['name']}")
        out.append("")
    return "\n".join(out).rstrip()


def report_run_stats(logloc: str, printToo: bool = True,
                     output: Optional[str] = None) -> str:
    """Runtime / parallel-efficiency / failure summary from a log file
    (reference: logUtils.report_run_stats + generate_reports,
    logUtils.py:25-83, 240-767); written as <run>.runtime_summary.txt."""
    try:
        ldb = load_log(logloc)
    except FileNotFoundError:
        return "No log found"
    lines = ["..:: Run report ::.."]
    if len(ldb):
        cps = ldb[ldb.log_type == "checkpoint"]
        # Overall: bounds of the main checkpoint class
        overall = None
        main = cps[cps["class"] == "main_profile"]
        try:
            t0 = float(main[main.status == "start"]["rest"].iloc[0]
                       .split()[-1])
            t1 = float(main[main.status == "end"]["rest"].iloc[-1]
                       .split()[-1])
            overall = t1 - t0
            lines.append(_section("Overall"))
            lines.append(f"Overall runtime: {overall:.1f} seconds")
        except (ValueError, IndexError):
            pass

        for klass in cps["class"].unique():
            sec = _checkpoint_section(cps, klass, overall)
            if sec:
                lines.append(_section(f"Checkpoints: {klass}"))
                lines.append(sec)

        # per-worker-class parallel-efficiency reports
        wdb = ldb[ldb.log_type == "worker"]
        for klass, db in wdb.groupby("class"):
            sec = _worker_class_section(db)
            if sec:
                lines.append(_section(f"Worker class: {klass}"))
                lines.append(sec)

        lines.append(_section("Failures"))
        lines.append(_failures_section(ldb[ldb.log_type == "failure"]))
    report = "\n".join(lines)
    if printToo:
        print(report)
    if output:
        with open(output, "w") as f:
            f.write(report + "\n")
    return report


def humanbytes(B: float) -> str:
    """Bytes -> human string (reference: logUtils.humanbytes 846-871)."""
    B = float(B)
    sign = "-" if B < 0 else ""
    B = abs(B)
    KB, MB, GB, TB = 1024, 1024 ** 2, 1024 ** 3, 1024 ** 4
    if B < KB:
        return f"{sign}{B:.0f} B"
    if B < MB:
        return f"{sign}{B / KB:.2f} KB"
    if B < GB:
        return f"{sign}{B / MB:.2f} MB"
    if B < TB:
        return f"{sign}{B / GB:.2f} GB"
    return f"{sign}{B / TB:.2f} TB"

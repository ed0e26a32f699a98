"""
The span recorder behind the phase accounting of the profile and compare
runs (profile/pipeline.py:PHASES, compare/pipeline.py:PHASES).

A span is one timed step of a run: its name, its start and end
(time.perf_counter_ns), the name of the thread it ran on, its parent (the
span open on the same thread when it opened; None at a thread's root) and
the run it belongs to. A child is named `<parent>.<step>`.

The switch is the run's phase dict, which start_run(phases) takes and
end_run() drops. While a run holds a dict, `span(name)` is recorded, adds
its seconds to phases[name] and enters
torch.profiler.record_function(name), so that a torch.profiler trace
holds it as a range on the clock of the kernels and copies (PyTorch's
profiler is thread-local: a trace started on the main thread holds the
main thread's ranges). While there is none (outside a run, or in a run
started with None), a span reads no clock, calls nothing and records
nothing.

The profile run's spans: registry (its set-up), decode, filter, pileup,
kernels (kernels.wait), tables (tables.linkage, tables.views), gather,
store (store.outputs, store.wait, store.genes), genome (genome.load,
genome.coverage, genome.irep, genome.write) and plots on the main
thread; with -g, genes: the gene file's parse (genes.parse) at the top
level, and each scaffold's gene profile (genes.coverage,
genes.mutations, genes.counts) inside tables; store_reads and
special_stream on the batch engine's two store threads. The main
thread's top-level spans add up to its wall but for the log checkpoints
and scaffold selection. The compare run's: load, overlap, pairs,
pooling, store and plots.

RECORD holds the spans of the current run, in the order they opened;
start_run() gives it a new list and the next run id (each profile and
compare run calls it first), so a list read after a run stays that run's.
A span closes on the thread, and in the order, it opened: none stays
open across a yield.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int            # 0 while the span is open
    thread: str
    parent: Optional[int]  # the parent's index in its run's spans
    run: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Record:
    """The spans of one run (`run`: its id), in the order they opened,
    and its phase dict (None: nothing is recorded)."""

    def __init__(self):
        self.run = 0
        self.spans: List[Span] = []
        self.phases: Optional[Dict[str, float]] = None


RECORD = Record()
_LOCK = threading.Lock()
_OPEN = threading.local()  # .stack: indices of this thread's open spans
_OFF = nullcontext()


def start_run(phases: Optional[Dict[str, float]]) -> int:
    """Start a run's record: a new list of spans, the next run id, which
    it returns, and `phases`, the dict its spans add their seconds to
    (None: the run records nothing)."""
    with _LOCK:
        RECORD.run += 1
        RECORD.spans = []
        RECORD.phases = phases
        return RECORD.run


def end_run() -> None:
    """End the run: later spans record nothing. Its spans and phase dict
    stay as they are."""
    with _LOCK:
        RECORD.phases = None


class _Recorded:
    __slots__ = ("name", "phases", "span", "range")

    def __init__(self, name: str, phases: Dict[str, float]):
        self.name = name
        self.phases = phases

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        with _LOCK:
            spans = RECORD.spans
            stack.append(len(spans))
            self.span = Span(self.name, 0, 0,
                             threading.current_thread().name,
                             stack[-2] if len(stack) > 1 else None,
                             RECORD.run)
            spans.append(self.span)
        self.span.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        span = self.span
        span.end_ns = time.perf_counter_ns()
        _OPEN.stack.pop()
        self.range.__exit__(*exc)
        with _LOCK:
            self.phases[self.name] = (self.phases.get(self.name, 0.0) +
                                      span.seconds)
        return False


def span(name: str):
    """A context manager timing one step named `name`: recorded while the
    current run holds a phase dict (module docstring), a shared no-op
    otherwise."""
    phases = RECORD.phases
    if phases is None:
        return _OFF
    return _Recorded(name, phases)

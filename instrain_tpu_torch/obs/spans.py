"""
The span recorder behind the phase accounting of the profile and compare
runs (profile/pipeline.py:PHASES, compare/pipeline.py:PHASES).

A span is one timed step of a run: its name, its start and end
(time.perf_counter_ns), the name of the thread it ran on, its parent (the
span open on the same thread when it opened; None at a thread's root) and
the run it belongs to. A child is named `<parent>.<step>`.

`span(name, phases)` is switched on by `phases`, the caller's phase dict:
while it is a dict, the span is recorded, adds its seconds to
phases[name] and enters torch.profiler.record_function(name), so that a
torch.profiler trace holds it as a range on the clock of the kernels and
copies (PyTorch's profiler is thread-local: a trace started on the main
thread holds the main thread's ranges). While it is None, the span reads
no clock, calls nothing and records nothing.

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
    """The spans of one run (`run`: its id), in the order they opened."""

    def __init__(self):
        self.run = 0
        self.spans: List[Span] = []


RECORD = Record()
_LOCK = threading.Lock()
_OPEN = threading.local()  # .stack: indices of this thread's open spans
_OFF = nullcontext()


def start_run() -> int:
    """Start a run's record: a new list of spans and the next run id,
    which it returns."""
    with _LOCK:
        RECORD.run += 1
        RECORD.spans = []
        return RECORD.run


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


def span(name: str, phases: Optional[Dict[str, float]]):
    """A context manager timing one step named `name`: recorded while
    `phases` is a dict (module docstring), a shared no-op while it is
    None."""
    if phases is None:
        return _OFF
    return _Recorded(name, phases)


def no_span(name: str):
    """The `phase` of a caller that times nothing."""
    return _OFF

"""Spans and counts at the engines' layer boundaries.

Off by default. An engine's `dispatch` and `collect` each open an `entry`,
which decides once for the whole call whether tracing is on: while a
torch.profiler session is active, or after `enable()`. Off, `span` returns
one shared null context and nothing is counted. On, each span adds its
duration, its self time (less its child spans') and its counts to the
totals of its name, so memory stays constant however long the run. Under a
profiler, a span also enters `torch.profiler.record_function(name)`, so that
it lands in the profiler's chrome trace on the kernels' clock, its launches
linked to their kernels by correlation ids.

The totals are cleared when tracing turns on from off, so a traced window
holds its own spans only; `totals()` returns them. The state is the
process's, as the profiler's is; the engines call from one thread.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass(slots=True)
class Total:
    """The spans of one name: how many, their ns of `time.perf_counter_ns`,
    their self ns (less their child spans') and the sums of their counts."""

    n: int = 0
    ns: int = 0
    self_ns: int = 0
    counts: dict = field(default_factory=dict)


class _Null:
    """The span of tracing off: enters nothing and counts nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts):
        pass


NULL = _Null()
_enabled = False    # enable() was called
_on = False         # decided by the innermost open entry
_profiled = False   # ... and whether a profiler session was active then
_last = False       # the last entry's decision
_totals: dict = {}
_stack: list = []   # the open spans


class _Span:
    __slots__ = ("name", "counts", "parent", "child_ns", "start", "_fn")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts, self.child_ns = name, counts, 0

    def add(self, **counts):
        """Add to counts known only inside the span (a wire's bytes)."""
        c = self.counts
        for k, v in counts.items():
            c[k] = c.get(k, 0) + v

    def __enter__(self):
        self._fn = None
        if _profiled:
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self.parent = _stack[-1] if _stack else None
        _stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.start
        _stack.pop()
        if self.parent is not None:
            self.parent.child_ns += ns
        t = _totals.get(self.name)
        if t is None:
            t = _totals[self.name] = Total()
        t.n += 1
        t.ns += ns
        t.self_ns += ns - self.child_ns
        for k, v in self.counts.items():
            t.counts[k] = t.counts.get(k, 0) + v
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


def span(name: str, **counts):
    """A context manager for one span inside an entry; `add(**counts)` on
    what it returns adds counts. The null context while tracing is off."""
    return _Span(name, counts) if _on else NULL


def on() -> bool:
    """Whether the open entry traces: guard counts that cost work."""
    return _on


@contextmanager
def entry(name: str):
    """The span of an engine's `dispatch` or `collect`: decides whether
    tracing is on for every span inside it."""
    global _on, _profiled, _last
    prev = _on, _profiled
    _profiled = torch.autograd.profiler._is_profiler_enabled
    _on = _enabled or _profiled
    if _on and not _last:
        _totals.clear()
    _last = _on
    try:
        with span(name) as sp:
            yield sp
    finally:
        _on, _profiled = prev


def enable():
    """Trace every engine call from now on, profiler or not."""
    global _enabled
    _enabled = True


def disable():
    """Undo enable(); the next traced call starts its totals anew."""
    global _enabled, _last
    _enabled = False
    _last = _last and torch.autograd.profiler._is_profiler_enabled


def totals() -> dict:
    """Span name -> its `Total` since tracing last turned on."""
    return dict(_totals)

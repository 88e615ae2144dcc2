"""The measured window: a frozen copy of the rolling window of
`dynamont_tpu_torch/cli/resquiggle.py` (`_pump_engine` and `INFLIGHT`, as
of the port's multi-device release), fed from the benchmark's pool instead
of a read file, with a clock that stops dispatching, and with each chunk's
dispatch, collect and formatting in a `record_function` span of its own.

Up to `inflight` chunks are dispatched before the oldest is collected, so
the device does not drain between chunks; a chunk whose dispatch or collect
raises is re-run read by read, as the CLI isolates it. Rows are formatted
in memory and kept, the last of each pool read, for the check.
"""

from __future__ import annotations

import time
from collections import deque

SPAN_DISPATCH = "bench.dispatch"
SPAN_COLLECT = "bench.collect"
SPAN_FORMAT = "bench.format"


class Result:
    """What a window did: reads attempted, failed and formatted, the rows of
    each pool read (its last pass), and the wall from the first dispatch to
    the end of the drain."""

    def __init__(self):
        self.attempted = 0
        self.failed = 0
        self.done = 0
        self.rows: dict = {}
        self.count: dict = {}
        self.errors: dict = {}
        self.chunks = 0
        self.t0 = self.t1 = 0.0

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0


def chunks(n_pool: int, chunk_reads: int):
    """Pool indices in chunks of `chunk_reads`, cycling through the pool in
    its order without end."""
    at = 0
    while True:
        yield [(at + i) % n_pool for i in range(chunk_reads)]
        at = (at + chunk_reads) % n_pool


def run_window(program, reads, *, seconds: float, chunk_reads: int,
               inflight: int, record=None, clock=time.perf_counter) -> Result:
    """Drive `program` (dispatch/collect/format/items, see program.Program)
    over the pool `reads` for `seconds` from the first dispatch, then drain.
    `record(name)` is a context manager for a span (torch.profiler's
    record_function), or None."""
    from contextlib import nullcontext

    span = record or (lambda name: nullcontext())
    res = Result()
    window: deque = deque()

    def emit(outs):
        with span(SPAN_FORMAT):
            for o in outs:
                if o is None:
                    continue
                i = o.item.meta
                res.count[i] = res.count.get(i, 0) + 1
                if o.error is not None:
                    res.failed += 1
                    res.errors[i] = o.error
                    res.rows.pop(i, None)
                else:
                    res.rows[i] = program.format(o)
                    res.errors.pop(i, None)
                res.done += 1

    def isolate(part, why):
        for i in part:
            try:
                emit(program.collect(program.dispatch(program.items(reads, [i]))))
            except Exception as e:  # the read itself breaks the engine
                res.failed += 1
                res.done += 1
                res.count[i] = res.count.get(i, 0) + 1
                res.errors[i] = f"engine exception, {e} ({why})"

    def collect_oldest():
        handle, part = window.popleft()
        with span(SPAN_COLLECT):
            try:
                outs = program.collect(handle)
            except Exception as e:
                isolate(part, e)
                return
        emit(outs)

    def submit(part):
        with span(SPAN_DISPATCH):
            try:
                handle = program.dispatch(program.items(reads, part))
            except Exception as e:
                isolate(part, e)
                return
        window.append((handle, part))
        if len(window) > inflight:
            collect_oldest()

    res.t0 = clock()
    for part in chunks(len(reads), chunk_reads):
        if clock() - res.t0 >= seconds:
            break
        res.attempted += len(part)
        res.chunks += 1
        submit(part)
    while window:
        collect_oldest()
    res.t1 = clock()
    return res

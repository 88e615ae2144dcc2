"""Host milliseconds a read of the banded engine's own work (bucketing, the
wire build in `ops/nt_banded_device.prepare_wire`, the launches' host side,
the Z gate and the outputs in `collect`): the time the traced window spent
inside the harness's `bench.dispatch` and `bench.collect` spans, less the
time inside CUDA runtime and driver calls there (where the host waits: on a
full launch queue, a synchronize, an allocation), by the reads completed in
the window. The engine's own `profile["dispatch_s"]` is not used: it counts
those waits, which on a busy card are nearly all of it."""

from benchmark.harness.trace import union

SPANS = ("bench.dispatch", "bench.collect")
CUDA_CATS = ("cuda_runtime", "cuda_driver")


def overlap_us(a, b) -> float:
    """Length of the intersection of two sorted, merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    events = run.get("events")
    if not events or not run["reads"]:
        return None
    spans = union([(e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") in SPANS])
    if not spans:
        return None
    cuda = union([(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in CUDA_CATS])
    span_us = sum(e - s for s, e in spans)
    host_us = span_us - overlap_us(spans, cuda)
    return host_us / 1e3 / run["reads"]

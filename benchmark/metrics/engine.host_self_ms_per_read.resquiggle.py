"""Host milliseconds a read of the NTC engine's own work, timed from inside
the program: the time the traced window spent inside its `ntc.dispatch`
and `ntc.collect` spans (dynamont_tpu_torch/tracing.py), less the time
inside CUDA runtime and driver calls and the `ntc.wait` spans there (where
the host waits: on a full launch queue, an allocation, a bucket's done
event), by the reads completed in the window. The wide and exact rungs run
inside `ntc.collect` and count. Nothing where the program records no
spans."""

import os

from benchmark.harness.main import load_file
from benchmark.harness.trace import union

SPANS = ("ntc.dispatch", "ntc.collect")
WAIT = "ntc.wait"
CUDA_CATS = ("cuda_runtime", "cuda_driver")
# the intersection of two merged interval lists, as the harness's own host
# metric takes it
overlap_us = load_file(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "engine.host_ms_per_read.basic.py"),
    "bench_metric_engine_host_ms_per_read_basic").overlap_us


def read(run):
    events = run.get("events")
    if not events or not run["reads"]:
        return None
    iv = lambda e: (e["ts"], e["ts"] + e["dur"])
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    spans = union([iv(e) for e in ann if e.get("name") in SPANS])
    if not spans:
        return None
    waits = union([iv(e) for e in events if e.get("cat") in CUDA_CATS]
                  + [iv(e) for e in ann if e.get("name") == WAIT])
    host_us = sum(e - s for s, e in spans) - overlap_us(spans, waits)
    return host_us / 1e3 / run["reads"]

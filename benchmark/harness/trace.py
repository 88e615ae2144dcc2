"""Reading the profiler's chrome trace of the measured window.

`union` and `trace_summary` are frozen copies of those in
`tools/main_path_profile.py` (as of the port's multi-device release), with
SPAN naming the benchmark's window: the device's busy union inside the
span, kernel sums by name, and the longest idle gaps with the host spans
that cover them. `kernel_seconds` and `breakdown` are the benchmark's own.
"""

from __future__ import annotations

import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("python_function", "cpu_op", "cuda_runtime", "cuda_driver")
SPAN = "bench.window"


def union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def trace_summary(trace: dict, n_gaps: int) -> dict:
    """Busy share, kernel sums and the longest idle gaps of the device
    inside the SPAN annotation of a chrome trace (times in µs)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    span = [e for e in events if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if not span:
        raise RuntimeError(f"no {SPAN} span in the trace")
    w0, w1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    clip = lambda e: (max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
    busy = union([clip(e) for e in dev if clip(e)[0] < clip(e)[1]])
    busy_us = sum(e - s for s, e in busy)
    by_name: dict = {}
    for e in dev:
        key = (e["cat"], e["name"][:80])
        n, us = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, us + e["dur"])
    gaps = [(s, e) for (_, s), (e, _) in zip([(None, w0)] + busy, busy + [(w1, None)])
            if e > s]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    host = [e for e in events if e.get("cat") in HOST_CATS]
    out_gaps = []
    for s, e in gaps[:n_gaps]:
        # the host spans that cover at least half of the gap, innermost
        # (shortest) first: the frames the host was in while the card idled
        cover = [h for h in host
                 if min(e, h["ts"] + h["dur"]) - max(s, h["ts"]) >= 0.5 * (e - s)]
        cover.sort(key=lambda h: h["dur"])
        out_gaps.append({"start_ms": (s - w0) / 1e3, "ms": (e - s) / 1e3,
                         "host": [[h["name"][:100], round(h["dur"] / 1e3, 3)]
                                  for h in cover[:8]]})
    return {"wall_ms": (w1 - w0) / 1e3, "device_events": len(dev),
            "busy_ms": busy_us / 1e3, "busy_share": busy_us / (w1 - w0),
            "idle_ms": (w1 - w0 - busy_us) / 1e3,
            "kernels": [{"cat": c, "name": n, "count": k, "ms": us / 1e3}
                        for (c, n), (k, us) in sorted(by_name.items(),
                                                      key=lambda kv: -kv[1][1])[:15]],
            "longest_gaps": out_gaps}


def _in_window(trace: dict):
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    span = [e for e in events if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if not span:
        raise RuntimeError(f"no {SPAN} span in the trace")
    w0, w1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    return events, w0, w1


def kernel_seconds(trace: dict) -> dict:
    """Seconds of device time by device event name (kernels, copies, sets),
    each event clipped to the window span."""
    events, w0, w1 = _in_window(trace)
    out: dict = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            us = min(e["ts"] + e["dur"], w1) - max(e["ts"], w0)
            if us > 0:
                out[e["name"]] = out.get(e["name"], 0.0) + us / 1e6
    return out


def matching(seconds_by_name: dict, names) -> float:
    """Device seconds of the events whose name holds one of `names` as a
    whole identifier (`banded_bwd_kernel` does not match
    `banded_bwd_train_kernel`)."""
    pats = [re.compile(rf"(?<![A-Za-z0-9_]){re.escape(n)}(?![A-Za-z0-9_])")
            for n in names]
    return sum(s for name, s in seconds_by_name.items()
               if any(p.search(name) for p in pats))


def short_name(name: str) -> str:
    """A device event's name without its return type and argument list."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    return name.strip()[:100]


def breakdown(trace: dict, summary: dict, n: int = 10) -> dict:
    """The `breakdown` of a traced run's line: the device operations that
    took the most time, and the longest idle gaps, each named by the host
    spans that cover it, innermost first."""
    by: dict = {}
    for name, s in kernel_seconds(trace).items():
        k = short_name(name)
        by[k] = by.get(k, 0.0) + s
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    gaps = []
    for g in summary["longest_gaps"][:n]:
        names = " < ".join(h[0] for h in g["host"][:3]) or "no host span"
        gaps.append([names[:200], g["ms"] / 1e3])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}

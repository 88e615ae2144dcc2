#!/usr/bin/env python3
"""Where the main path's time goes on one GPU: the device's busy and idle
share over one steady `--mode basic` run, for the checkout at --root:

    python3 tools/main_path_profile.py [--root DIR] [--gaps 10] [--trace PATH]

From the package of --root (default: this checkout): chip_smoke.py's
phase-4 workload, 64 rna002 reads of 1800 bases (mean dwell 9, T trimmed
to 16000) through BandedBatchEngine (batch 32, fp32, cuda), after two
warm-up runs. Then:

1. one run under torch.profiler (CPU and CUDA activities, Python stacks):
   the run's wall (its record_function span), the device's busy time (the
   union of the kernels, copies and sets on the card's timeline inside
   that span) and share, the kernel time summed by name, and the --gaps
   longest idle gaps of the device, each with the host spans (Python
   frames, torch ops, CUDA runtime calls) that cover at least half of it,
   innermost first, with their own lengths. If the trace holds no device
   event, it says so;
2. one run with CUDA events bracketing each kernel launch (K1, K2, K3 and
   the whole per-bucket device program: decode, kernels, summaries), beside
   the engine's own host clocks of dispatch and wait + collect.

Prints the card's name and power limit, then one JSON line per part.
--trace writes the profiler's chrome trace there. Comparing two
checkouts: run each in its own process, in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

N_READS, N_BASES, MEAN_DWELL, T_TRIM, BATCH = 64, 1800, 9.0, 16000, 32
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("python_function", "cpu_op", "cuda_runtime", "cuda_driver")
SPAN = "main_path_run"


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--gaps", type=int, default=10)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("main_path_profile: torch sees no CUDA device", file=sys.stderr)
        return 1
    from dynamont_tpu_torch.models.batch import BandedBatchEngine, BatchItem
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.ops import nt_banded_device as dv
    from dynamont_tpu_torch.ops import nt_banded_kernels as kk
    from dynamont_tpu_torch.utils.synthetic import make_read

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    model = load_model_for_pore("rna002")
    items = []
    for s in range(N_READS):
        sig, read = make_read(model, n_bases=N_BASES, mean_dwell=MEAN_DWELL, seed=s)
        items.append(BatchItem(sig[:T_TRIM], read))
    eng = BandedBatchEngine(model, "rna002", device="cuda", batch_size=BATCH)
    for _ in range(2):  # warm-up: the allocator, the first launches, the build
        eng.run(items)
    torch.cuda.synchronize()

    # 1. the profiler's trace of one run
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof:
        with record_function(SPAN):
            eng.run(items)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="main_path_profile_") as tmp:
        path = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    summary = trace_summary(trace, args.gaps)
    if summary["device_events"] == 0:
        summary["note"] = "the trace holds no device event: see the CUDA-event brackets"
    print(json.dumps(dict(root=root, part="profiler", **summary)), flush=True)

    # 2. CUDA-event brackets of the kernels and the device program
    marks: dict = {"banded_bwd": [], "banded_fwd_vit": [], "banded_walk": [],
                   "device_program": []}

    def bracket(name, fn):
        def run(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            marks[name].append(ev)
            return out
        return run

    saved = (kk.backward, kk.fwd_vit, kk.walk, dv.banded_batch_run_device)
    kk.backward, kk.fwd_vit, kk.walk = (bracket(n, f) for n, f in zip(
        ("banded_bwd", "banded_fwd_vit", "banded_walk"), saved[:3]))
    dv.banded_batch_run_device = bracket("device_program", saved[3])
    try:
        prof0 = dict(eng.profile)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(items)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        kk.backward, kk.fwd_vit, kk.walk, dv.banded_batch_run_device = saved
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in marks.items()}
    kernels = sum(ms[k] for k in ("banded_bwd", "banded_fwd_vit", "banded_walk"))
    print(json.dumps(dict(
        root=root, part="cuda_events", wall_ms=wall * 1e3,
        dispatch_ms=(eng.profile["dispatch_s"] - prof0["dispatch_s"]) * 1e3,
        wait_collect_ms=(eng.profile["collect_s"] - prof0["collect_s"]) * 1e3,
        buckets=eng.profile["buckets"] - prof0["buckets"], kernels_ms=kernels,
        kernel_share=kernels / (wall * 1e3), **{f"{k}_ms": v for k, v in ms.items()})),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

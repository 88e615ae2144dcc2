"""One run of one cell of the benchmark:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from the process's start): the card, the program's kernels (built
into the checkout's `dynamont_tpu_torch/_kernels_build/` on a first run,
loaded from there after), the pool of reads made from the seed, the engine
the CLI builds, one warm-up chunk. The window: the CLI's rolling window
(`harness/window.py`) over the pool for `--seconds`, then its drain. After
the window: the peak memory is read, the program freed, and a sample of
the reads the window completed is checked against the plain reference
(`harness/check.py`). With `--trace 1` the window runs under
torch.profiler and the line carries the cell's per-layer metrics; with
`--trace 0`, its end-to-end metrics.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, [breakdown], check); the last lines of standard
error are the numbers the check compared, each beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "dynamont_tpu")


def load_cell(root: str, name: str):
    """(benchmark, cell, config, traffic) of the cell `name`."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: dict, kind: str) -> list:
    """The metrics of kind ("end_to_end" or "per_layer") this cell reports:
    those that list it under `workloads`, or list no workloads and move an
    end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and ("workloads" in m or m["moves"] in names)]


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                              "clocks.sm,temperature.gpu", "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None, t_start: float | None = None, root: str | None = None,
         device: str | None = None, program_factory=None) -> int:
    """A run as `benchmark/run.py` makes it. `device` and `program_factory`
    are for the CPU tests only: they skip the look for a card and replace
    the engine (a broken one, to see the check fail)."""
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    bench, cell, config, traffic = load_cell(root, args.workload)
    # the kernel library is built and found inside the checkout
    os.environ.pop("DYNAMONT_TORCH_BUILD_DIR", None)
    if root not in sys.path:
        sys.path.insert(0, root)

    import torch

    t_import = time.perf_counter()
    if device is None:
        if not torch.cuda.is_available():
            print("benchmark: torch sees no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"benchmark: the cell asks for {cell['chips']} GPUs, torch "
                  f"sees {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        if cell["chips"] != 1:
            raise SystemExit("benchmark: only one-GPU cells are defined")
        device = "cuda:0"
    on_card = torch.device(device).type == "cuda"

    from benchmark.harness import check as chk
    from benchmark.harness import trace as tr
    from benchmark.harness.traffic import make_pool
    from benchmark.harness.window import run_window
    from benchmark.reference.table import load_table

    marks = [("import", t_import), ("card", time.perf_counter())]
    table = load_table(os.path.join(root, config["table"]),
                       rna=config["pore"].startswith("rna"))
    reads = make_pool(traffic, config, table, args.seed)
    marks.append(("pool", time.perf_counter()))
    if program_factory is None:
        from benchmark.harness.program import Program

        program = Program(config, root, device)
    else:
        program = program_factory(config, root, device)
    marks.append(("engine", time.perf_counter()))
    eng = config["engine"]
    chunk, inflight = eng["chunk_reads"], eng["inflight"]
    # warm-up: one chunk through dispatch, collect and the formatter (the
    # kernel library's build or load, the native formatter, the allocator)
    for o in program.collect(program.dispatch(program.items(reads, range(chunk)))):
        if o is not None and o.error is None:
            program.format(o)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = program.counters()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    at = t_start
    parts = []
    for name, t in marks:
        parts.append(f"{name} {t - at}")
        at = t
    print(f"setup: {setup_s} s: " + ", ".join(parts), file=sys.stderr)

    trace = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            with record_function(tr.SPAN):
                win = run_window(program, reads, seconds=args.seconds,
                                 chunk_reads=chunk, inflight=inflight,
                                 record=record_function)
                if on_card:
                    torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        del prof
    else:
        win = run_window(program, reads, seconds=args.seconds,
                         chunk_reads=chunk, inflight=inflight)
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    after = program.counters()
    counters = {k: after[k] - before[k] for k in after}
    failed = win.failed + (win.attempted - win.done)
    ok_reads = win.done - win.failed
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    device_line = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}

    metrics: dict = {}
    breakdown = None
    if not args.trace:
        values = {"reads_per_s": ok_reads / win.wall_s if win.wall_s > 0 else 0.0,
                  "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        for m in cell_metrics(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    else:
        summary = tr.trace_summary(trace, 10)
        window_s = summary["wall_ms"] / 1e3
        busy_s = summary["busy_ms"] / 1e3
        device_line.update(busy_s=busy_s, window_s=window_s)
        kernel_s = tr.kernel_seconds(trace)
        breakdown = tr.breakdown(trace, summary)
        with open(os.path.join(root, "benchmark", "harness", "peaks.json")) as f:
            peaks = json.load(f)["devices"].get(kind)
        sizes = []
        k = table.kmer_size
        for i, n in win.count.items():
            sig, read = reads[i]
            sizes += [(len(sig) + 1, len(read) - k + 2)] * n
        run = {"reads": win.done, "sizes": sizes, "counters": counters,
               "trace": {"window_s": window_s, "busy_s": busy_s,
                         "kernel_s": kernel_s},
               "kernel_time": lambda names: tr.matching(kernel_s, names),
               "events": [e for e in trace.get("traceEvents", [])
                          if e.get("ph") == "X"],
               "peaks": peaks, "config": config, "table": table,
               "roofline": lambda g: load_file(
                   os.path.join(root, "benchmark", "roofline", f"{g}.py"),
                   f"bench_roofline_{g}")}
        for m in cell_metrics(bench, cell, "per_layer"):
            reader = load_file(os.path.join(root, "benchmark", "metrics",
                                            f"{m['name']}.py"),
                               "bench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        del trace
        print(f"trace: window {window_s} s, device busy {busy_s} s, "
              f"{summary['device_events']} device events", file=sys.stderr)
    print(f"window: {win.attempted} reads dispatched in {win.chunks} chunks, "
          f"{ok_reads} formatted, {failed} failed, {win.wall_s} s; "
          f"engine {json.dumps(counters)}", file=sys.stderr)
    if on_card:
        print(f"card: {power_line()}", file=sys.stderr)

    # the check, once the program's state is freed
    program.close()
    del program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    res = chk.run_check(config, table, reads, win, args.seed, device)
    correct = res["ok"] and failed == 0
    print(f"check: {len(res['reads'])} reads against the reference in "
          f"{res['seconds']} s", file=sys.stderr)

    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = {"correct": correct, "attempted": win.attempted, "failed": failed,
            "metrics": metrics, "device": device_line}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in res["numbers"].items()}
    line["check"]["failed_reads"] = {"value": failed, "limit": 0}
    for k, c in line["check"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0

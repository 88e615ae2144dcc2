"""Aggregate per-tool metrics into one long-format CSV
(ref: src/python/misc/collectMetrics.py).

Inputs per tool: an evaluate_reads JSON report, a GNU-time output file
(elapsed + max RSS), and optionally downstream (assembly) stats; output is a
Tool,Value,Metric CSV ready for the figure generators.
"""

from __future__ import annotations

import json
import sys
from argparse import ArgumentParser


def add_json_metrics(rows: list, tool: str, json_path: str) -> None:
    with open(json_path) as f:
        data = json.load(f)
    for metric, value in data.items():
        if metric == "lengths":
            continue
        rows.append((tool, value, metric.lower().replace("n50", "n50_length")))


def add_time_metrics(rows: list, tool: str, time_path: str) -> None:
    """First line: wall time at a fixed offset; second: peak memory
    (ref: collectMetrics.py:90-101 slicing convention)."""
    with open(time_path) as f:
        time = f.readline()[14:22]
        memory = f.readline().strip()[13:].split(" MB")[0]
    rows.append((tool, time, "Time in hh:mm:ss"))
    rows.append((tool, memory, "Memory in MB"))


def add_downstream_metrics(rows: list, tool: str, path: str) -> None:
    """flye/SVIM summary lines (ref: collectMetrics.py:104-120)."""
    with open(path) as f:
        total_len = int(f.readline().strip().split(": ")[1])
        n50 = int(f.readline().strip().split(": ")[1])
        mean_cov = float(f.readline().strip().split(": ")[1])
        struct_vars = int(f.readline().strip().split(": ")[1])
    rows.append((tool, total_len, "flye total length"))
    rows.append((tool, n50, "flye n50"))
    rows.append((tool, mean_cov, "flye mean coverage"))
    rows.append((tool, struct_vars, "SVIM structural variants"))


def add_score_metrics(rows: list, score_csv: str) -> None:
    """Per-tool median of each segment-quality score from the
    signal-scoring CSV (Tool,Score,Segment Quality; produced by
    compare_tools.score_tools — ref: collectMetrics.py:30-45)."""
    import csv
    from collections import defaultdict

    acc: dict = defaultdict(list)
    with open(score_csv) as f:
        for row in csv.DictReader(f):
            try:
                acc[(row["Tool"], row["Segment Quality"])].append(
                    float(row["Score"])
                )
            except (KeyError, ValueError):
                continue
    import statistics

    for (tool, quality), vals in sorted(acc.items()):
        finite = [v for v in vals if v == v]  # drop NaN
        if finite:
            rows.append((tool, statistics.median(finite), quality))


def main(argv=None) -> None:
    p = ArgumentParser(prog="dynamont-collect-metrics")
    p.add_argument("--tool", action="append", nargs=2, metavar=("NAME", "JSON"),
                   default=[], help="tool name + evaluate_reads JSON (repeatable)")
    p.add_argument("--time", action="append", nargs=2, metavar=("NAME", "FILE"),
                   default=[])
    p.add_argument("--downstream", action="append", nargs=2,
                   metavar=("NAME", "FILE"), default=[])
    p.add_argument("--scores", default=None,
                   help="signal-scoring CSV (Tool,Score,Segment Quality)")
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args(argv)

    rows: list = []
    for name, path in args.tool:
        add_json_metrics(rows, name, path)
    for name, path in args.time:
        add_time_metrics(rows, name, path)
    for name, path in args.downstream:
        add_downstream_metrics(rows, name, path)
    if args.scores:
        add_score_metrics(rows, args.scores)
    with open(args.output, "w") as f:
        f.write("Tool,Value,Metric\n")
        for tool, value, metric in rows:
            f.write(f"{tool},{value},{metric}\n")
    print(f"wrote {len(rows)} metric rows to {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()

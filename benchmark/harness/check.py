"""How `correct` is decided: a sample of the reads that the measured window
completed, drawn from the seed, is worked out again by the configuration's
plain reference (`benchmark/reference/<name>.py`, float64), and the
program's CSV rows of those reads are compared with the reference's, row by
row. The numbers compared and their limits are in the configuration's
`check` entry; PERF.md gives the readings each limit was set from.

- `border_diff_share`: of the rows in either the program's or the
  reference's output of the sampled reads, the share that is missing on one
  side or differs in start, end, base position, base, motif, state or
  polish k-mer.
- `prob_max_abs_diff`: the largest difference of the posterior probability
  over the rows that agree in all of those.
"""

from __future__ import annotations

import importlib
import time

import numpy as np

NUMBERS = ("border_diff_share", "prob_max_abs_diff")


def parse_rows(data: bytes) -> list:
    """CSV bytes of one read -> [(start, end, basepos, base, motif, state,
    prob, polish)]."""
    rows = []
    for line in data.decode().splitlines():
        if not line:
            continue
        f = line.split(",")
        rows.append((int(f[2]), int(f[3]), int(f[4]), f[5], f[6], f[7],
                     float(f[8]), f[9]))
    return rows


def sample(done_ids, n: int, seed: int) -> list:
    """`n` of the completed pool reads, drawn from the seed."""
    ids = sorted(done_ids)
    rng = np.random.default_rng([abs(int(seed)), 0xC4EC])
    k = min(n, len(ids))
    return sorted(int(ids[j]) for j in rng.choice(len(ids), size=k, replace=False))


def _keyed(rows) -> dict:
    """Rows by (base position, how many rows of that position came before):
    a base that holds more than one row (an NTC polish row beside its
    alignment row) keeps each."""
    seen: dict = {}
    out = {}
    for r in rows:
        j = seen.get(r[2], 0)
        seen[r[2]] = j + 1
        out[(r[2], j)] = r
    return out


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of PROG's rows (read id -> rows, None for a read that
    failed) against REF's (read id -> rows)."""
    mism = total = 0
    pmax = 0.0
    for i, ref_rows in ref.items():
        by_ref = _keyed(ref_rows)
        by_prog = _keyed(prog.get(i) or [])
        keys = set(by_ref) | set(by_prog)
        total += len(keys)
        for k in keys:
            a, b = by_prog.get(k), by_ref.get(k)
            if a is None or b is None or a[:6] + a[7:] != b[:6] + b[7:]:
                mism += 1
            else:
                pmax = max(pmax, abs(a[6] - b[6]))
    return {"border_diff_share": mism / total if total else 1.0,
            "prob_max_abs_diff": pmax}


def reference_rows(config: dict, table, reads, ids, device, dtype) -> dict:
    """Read id -> the reference's rows for pool reads `ids`; the reference
    takes the configuration's own `reference_args`."""
    ref = importlib.import_module(f"benchmark.reference.{config['reference']}")
    res = ref.segment([reads[i] for i in ids], table, config["pore"],
                      device=device, dtype=dtype,
                      **config.get("reference_args", {}))
    return {i: rows for i, (_, _, rows) in zip(ids, res)}


def run_check(config: dict, table, reads, window, seed: int, device) -> dict:
    """The check of one run: {"numbers": {name: (value, limit)}, "ok": bool,
    "reads": sampled ids, "seconds": reference time}."""
    import torch

    t0 = time.perf_counter()
    done = set(window.rows) | set(window.errors)
    ids = sample(done, config["check"]["reads"], seed)
    ref = reference_rows(config, table, reads, ids, device, torch.float64)
    prog = {}
    for i in ids:
        try:
            prog[i] = parse_rows(window.rows[i]) if i in window.rows else None
        except (ValueError, IndexError, UnicodeDecodeError):
            prog[i] = None  # a malformed row: every row of the read differs
    nums = compare(prog, ref)
    limits = config["check"]["limits"]
    numbers = {k: (nums[k], limits[k]) for k in NUMBERS}
    ok = bool(ids) and all(v <= lim for v, lim in numbers.values())
    return {"numbers": numbers, "ok": ok, "reads": ids,
            "seconds": time.perf_counter() - t0}

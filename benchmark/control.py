"""The check's control: the program's own float32 path, one precision below
the configuration's float64, put in the program's place and judged by the
same check against the float64 reference: the engine with its dtype
lowered runs the cell's window over the cell's pool (the same reads, drawn
from the seed), and the check samples the reads that window completed, as
a run does. It has to come out as not correct; its readings are the upper
ones the limits are set under (PERF.md). The benchmark's runs do not run
it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

Prints one JSON line a seed: the numbers compared, each beside its limit,
and whether the control passed them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control(workload: str, seed: int, root: str = ROOT,
            device: str | None = None) -> dict:
    """One seed of the control."""
    import torch

    from benchmark.harness import check as chk
    from benchmark.harness.main import load_cell
    from benchmark.harness.program import Program
    from benchmark.harness.traffic import make_pool
    from benchmark.harness.window import run_window
    from benchmark.reference.table import load_table

    bench, _, config, traffic = load_cell(root, workload)
    if config["engine"]["dtype"] != "float64":
        raise SystemExit("the control lowers a float64 configuration to the "
                         "program's float32 path")
    device = device or ("cuda:0" if torch.cuda.is_available() else "cpu")
    table = load_table(os.path.join(root, config["table"]),
                       rna=config["pore"].startswith("rna"))
    reads = make_pool(traffic, config, table, seed)
    eng = config["engine"]
    lowered = {**config, "engine": {**eng, "dtype": "float32"}}
    t0 = time.perf_counter()
    prog = Program(lowered, root, device)
    win = run_window(prog, reads, seconds=bench["run_seconds"],
                     chunk_reads=eng["chunk_reads"], inflight=eng["inflight"])
    prog.close()
    t1 = time.perf_counter()
    res = chk.run_check(config, table, reads, win, seed, device)
    return {"workload": workload, "seed": seed, "dtype": "float32",
            "device": str(device), "reads": len(res["reads"]),
            "window_reads": win.done, "failed": win.failed,
            "numbers": {k: {"value": v, "limit": lim}
                        for k, (v, lim) in res["numbers"].items()},
            "passes": res["ok"], "reference_s": res["seconds"],
            "control_s": t1 - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(control(args.workload, int(s))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

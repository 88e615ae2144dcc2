"""The check's control: the program's own float32 path, one precision below
the configuration's float64, judged by the same comparison against the
float64 reference on the reads a run would check (the same sample of the
same pool, drawn from the seed; the engine with its dtype lowered, the
sampled reads dispatched as one chunk). It has to come out as not correct;
its readings are the upper ones the limits are set under (PERF.md). The
benchmark's runs do not run it.

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
    from benchmark.reference.table import load_table

    _, _, config, traffic = load_cell(root, workload)
    if config["engine"]["dtype"] != "float64":
        raise SystemExit("the control lowers a float64 configuration to the "
                         "program's float32 path")
    device = device or ("cuda:0" if torch.cuda.is_available() else "cpu")
    table = load_table(os.path.join(root, config["table"]),
                       rna=config["pore"].startswith("rna"))
    reads = make_pool(traffic, config, table, seed)
    # a window completes every read of the pool, so the run samples these
    ids = chk.sample(range(len(reads)), config["check"]["reads"], seed)
    t0 = time.perf_counter()
    ref = chk.reference_rows(config, table, reads, ids, device, torch.float64)
    t1 = time.perf_counter()
    lowered = {**config, "engine": {**config["engine"], "dtype": "float32"}}
    prog = Program(lowered, root, device)
    outs = prog.collect(prog.dispatch(prog.items(reads, ids)))
    low = {o.item.meta: (chk.parse_rows(prog.format(o)) if o.error is None
                         else None) for o in outs}
    prog.close()
    t2 = time.perf_counter()
    nums = chk.compare(low, ref)
    limits = config["check"]["limits"]
    return {"workload": workload, "seed": seed, "dtype": "float32",
            "device": str(device), "reads": len(ids),
            "numbers": {k: {"value": nums[k], "limit": limits[k]}
                        for k in chk.NUMBERS},
            "passes": all(nums[k] <= limits[k] for k in chk.NUMBERS),
            "reference_s": t1 - t0, "control_s": t2 - t1}


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

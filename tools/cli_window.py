#!/usr/bin/env python3
"""Reads/s and peak device memory of the port's batch CLI
(dynamont_tpu_torch.cli.resquiggle) on one GPU, for the checkout at --root:

    python3 tools/cli_window.py [--root DIR] [--runs 2]

In process, from the package and chip_smoke.py of --root (default: this
checkout), after one warm-up run of each:
  basic       chip_smoke.py's 64 phase-4 reads (1800 bases, mean dwell 9,
              T trimmed to 16000, rna002) at --batch_size 8: two chunks of
              32 reads;
  resquiggle  the first 16 of them at --batch_size 1: four chunks of 4.
Prints one JSON line per timed run (mode, wall s, reads/s, peak GiB) and
the card's name and power limit. The card's machine has no zstandard: the
CSV goes through chip_smoke.py's pass-through stand-in. Comparing two
checkouts: run each in turn in one call (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("cli_window: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from dynamont_tpu_torch.cli import resquiggle
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.utils.synthetic import make_read

    cs.zstd_stand_in()
    model = load_model_for_pore("rna002")
    bench = []
    for s in range(cs.N_READS):
        sig, read = make_read(model, n_bases=cs.N_BASES, mean_dwell=cs.MEAN_DWELL, seed=s)
        bench.append((sig[: cs.T_TRIM], read))
    card = cs.smi("name,power.limit")
    with tempfile.TemporaryDirectory(prefix="cli_window_") as tmp:
        for mode, reads, batch in (("basic", bench, 8), ("resquiggle", bench[:16], 1)):
            tsv = os.path.join(tmp, f"{mode}.tsv")
            cs.write_tsv(tsv, reads)
            for run in range(args.runs + 1):
                out = os.path.join(tmp, f"{mode}{run}.csv.zst")
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                resquiggle.main(["--tsv", tsv, "-o", out, "--mode", mode, "-p", "rna002",
                                 "--batch_size", str(batch), "--device", "cuda"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if os.path.exists(os.path.join(tmp, f"{mode}{run}.errors")):
                    raise AssertionError(f"{mode}: reads failed")
                if run == 0:
                    continue  # warm-up
                print(json.dumps({
                    "root": root, "mode": mode, "reads": len(reads), "batch_size": batch,
                    "wall_s": wall, "reads_per_s": len(reads) / wall,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

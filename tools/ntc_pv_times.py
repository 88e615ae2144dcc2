#!/usr/bin/env python3
"""CUDA-event times of K15 ntc_pv's full store for the checkout at --root,
on one GPU:

    python3 tools/ntc_pv_times.py [--root DIR] [--reps 2]

From the package of --root (default: this checkout), on the bucket of the
resquiggle engine's main rung that chip_smoke.py's phase 12 runs: 16 rna002
reads of 1800 bases (mean dwell 9, T trimmed to 16000) through the TSV
reader, one (16, 16384) bucket at caps (8, 120), N2 2048, run through the
engine's own bucket program (`_dispatch(keep=...)`, full-store route) in
fp32 and in fp64, and K15 timed on the inputs it had there. Each time is
the mean of --reps launches after one. Prints the card's name and power
limit, then one JSON line per dtype with the instance that ran where the
checkout has more than one (`ntc_kernels.pv_instance`). Comparing two
checkouts: run each in its own process, in one call (parent, change,
change, parent).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

N_READS, N_BASES, MEAN_DWELL, T_TRIM = 16, 1800, 9.0, 16000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("ntc_pv_times: torch sees no CUDA device", file=sys.stderr)
        return 1
    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.utils.synthetic import make_read

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    model = load_model_for_pore("rna002")
    with tempfile.TemporaryDirectory(prefix="ntc_pv_times_") as tmp:
        tsv = os.path.join(tmp, "reads.tsv")
        with open(tsv, "w") as f:  # as chip_smoke.write_tsv writes the CLI's input
            for s in range(N_READS):
                sig, read = make_read(model, n_bases=N_BASES, mean_dwell=MEAN_DWELL, seed=s)
                f.write(f"r{s}\tr{s}\t{','.join(repr(float(x)) for x in sig[:T_TRIM])}"
                        f"\t{read[9:][::-1]}\n")
        items = [BatchItem(job.signal, job.read)
                 for job in readers.generate_tsv_jobs(tsv, True)]

    def cuda_ms(fn) -> float:
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(args.reps):
            fn()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / args.reps

    for dtype in (torch.float32, torch.float64):
        eng = NTCBatchEngine(model, "rna002", device="cuda", dtype=dtype)
        k: dict = {}
        eng._dispatch(list(range(N_READS)), items, eng.cap_n, eng.cap_k, keep=k, ckpt=False)
        for f in ("lp", "choices", "slots", "rec", "fin"):
            k.pop(f, None)  # the bucket's own outputs: not needed here
        torch.cuda.empty_cache()
        plan, dims, prm, sig, tl = k["plan"], k["dims"], k["prm"], k["sig"], k["trans_log"]
        bwd, Zb, T_r = k["bwd"], k["Zb"], k["T_r"]
        instance = None
        if hasattr(kern, "pv_instance"):
            instance = kern.pv_instance(dims.CN, dims.CK, dims.A, sig.element_size()).name
        ms = cuda_ms(lambda: kern.pv(plan, dims, prm, sig, bwd, Zb, tl, T_r))
        print(json.dumps(dict(root=root, kernel="ntc_pv", dtype=str(dtype).removeprefix("torch."),
                              shape=[sig.shape[0], sig.shape[1] + 1], dims=list(dims),
                              instance=instance, ms=ms)), flush=True)
        del k, plan, prm, sig, bwd, Zb, T_r, eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

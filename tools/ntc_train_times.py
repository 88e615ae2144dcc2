#!/usr/bin/env python3
"""CUDA-event times of the NTC training kernels, K17 ntc_fwd_store and K18
ntc_train, for the checkout at --root, on one GPU:

    python3 tools/ntc_train_times.py [--root DIR] [--reps 2]

From the package of --root (default: this checkout), on two buckets at the
engine's main caps (8, 120), N2 2048, in fp32 and in fp64:
  - "resquiggle": the bucket chip_smoke.py's phase 12 runs, 16 rna002
    reads of 1800 bases (mean dwell 9, T trimmed to 16000) through the TSV
    reader, (16, 16384);
  - "train": the trainer's batch of phase 13's training step, the first 24
    of the smoke's reads, (24, 16384), at the transitions the step starts
    from (TRAIN_INIT_NTK).
Each bucket runs through the engine's own training program
(`_train_bucket(keep=...)`); then each kernel is timed on the inputs it
had there, in every instance the checkout offers: the one the shape picks
and, where the checkout has more than one (`ntc_train_kernels.
fwd_store_instance`, `train_instance`), every other instance the wrapper
accepts at that shape, each with its outputs held bit for bit against the
picked instance's. Each time is the mean of --reps launches after one.
Prints the card's name and power limit, then one JSON line per kernel,
bucket, dtype and instance. Comparing two checkouts: run each in its own
process, in one call (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

N_BASES, MEAN_DWELL, T_TRIM = 1800, 9.0, 16000
BUCKETS = (("resquiggle", 16), ("train", 24))  # (name, reads)


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
        print("ntc_train_times: torch sees no CUDA device", file=sys.stderr)
        return 1
    from dynamont_tpu_torch.constants import TRAIN_INIT_NTK
    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk
    from dynamont_tpu_torch.utils.synthetic import make_read

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    model = load_model_for_pore("rna002")
    reads = [make_read(model, n_bases=N_BASES, mean_dwell=MEAN_DWELL, seed=s)
             for s in range(max(n for _, n in BUCKETS))]
    reads = [(sig[:T_TRIM], read) for sig, read in reads]
    with tempfile.TemporaryDirectory(prefix="ntc_train_times_") as tmp:
        tsv = os.path.join(tmp, "reads.tsv")
        with open(tsv, "w") as f:  # as chip_smoke.write_tsv writes the CLI's input
            for s, (sig, read) in enumerate(reads[:BUCKETS[0][1]]):
                f.write(f"r{s}\tr{s}\t{','.join(repr(float(x)) for x in sig)}"
                        f"\t{read[9:][::-1]}\n")
        items = {"resquiggle": [BatchItem(job.signal, job.read)
                                for job in readers.generate_tsv_jobs(tsv, True)],
                 "train": [BatchItem(s, r) for s, r in reads[:BUCKETS[1][1]]]}

    def cuda_ms(fn) -> float:
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(args.reps):
            fn()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / args.reps

    def instances(pick, dims, itemsize) -> list:
        """(picked, [every instance the wrapper accepts here]): the
        device-memory instance takes every shape; (None, [None]) where the
        checkout has one kernel."""
        if pick is None:
            return None, [None]
        picked = pick(dims.CN, dims.CK, dims.A, itemsize).name
        return picked, [picked] + (["device"] if picked != "device" else [])

    def line(**kw) -> None:
        print(json.dumps(dict(root=root, **kw)), flush=True)

    for bucket, n in BUCKETS:
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).removeprefix("torch.")
            over = TRAIN_INIT_NTK if bucket == "train" else None
            eng = NTCBatchEngine(model, "rna002", device="cuda", dtype=dtype,
                                 transition_overrides=over)
            kt: dict = {}
            eng._train_bucket(list(range(n)), items[bucket], keep=kt)
            for f in ("tacc", "em", "b0"):
                kt.pop(f)
            torch.cuda.empty_cache()
            plan, dims, prm, sig, tl = (kt[f] for f in ("plan", "dims", "prm", "sig",
                                                        "trans_log"))
            N_r, T_r, fwd, Zf, K = (kt[f] for f in ("N_r", "T_r", "fwd", "Zf", "K"))
            shape = [sig.shape[0], sig.shape[1] + 1]
            isz = sig.element_size()
            # K17
            picked, insts = instances(getattr(tk, "fwd_store_instance", None), dims, isz)
            kw = lambda i: {} if i is None else {"instance": i}
            for inst in insts:
                ms = cuda_ms(lambda: tk.fwd_store(plan, dims, prm, sig, tl, **kw(inst)))
                same = None
                if inst != picked:
                    got = tk.fwd_store(plan, dims, prm, sig, tl, **kw(inst))
                    same = bool(torch.equal(got, fwd))  # fwd: the picked one's
                    del got
                line(kernel="ntc_fwd_store", bucket=bucket, dtype=name, shape=shape,
                     dims=list(dims), instance=inst, picked=picked, ms=ms,
                     same_as_picked=same)
            torch.cuda.empty_cache()
            # K18
            picked, insts = instances(getattr(tk, "train_instance", None), dims, isz)
            want = tk.train(plan, dims, prm, sig, fwd, Zf, tl, N_r, T_r, K)
            for inst in insts:
                ms = cuda_ms(lambda: tk.train(plan, dims, prm, sig, fwd, Zf, tl, N_r, T_r,
                                              K, **kw(inst)))
                same = None
                if inst != picked:
                    got = tk.train(plan, dims, prm, sig, fwd, Zf, tl, N_r, T_r, K, **kw(inst))
                    same = all(torch.equal(g, w) for g, w in zip(got, want))
                    del got
                line(kernel="ntc_train", bucket=bucket, dtype=name, shape=shape,
                     dims=list(dims), instance=inst, picked=picked, ms=ms,
                     same_as_picked=same)
            del kt, plan, prm, sig, fwd, want, eng
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

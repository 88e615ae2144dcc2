#!/usr/bin/env python3
"""CUDA-event times of K8 ntc_tn_bwd_sel and K13 ntc_bwd for the checkout at
--root, on one GPU:

    python3 tools/ntc_pre_bwd_times.py [--root DIR] [--reps 2]

From the package of --root (default: this checkout), on the bucket of the
resquiggle engine's main rung that chip_smoke.py's phase 12 runs: 16 rna002
reads of 1800 bases (mean dwell 9, T trimmed to 16000) through the TSV
reader, one (16, 16384) bucket at caps (8, 120), N2 2048, in fp32 and in
fp64. K8 runs on the engine's own pre-pass inputs (its padded bucket, the
TN tables and K7's forward store), and where the checkout splits it, its
two kernels (tn_bwd_u, the chain; tn_sel, the selection) are timed alone
too; the device memory K8 allocates above its inputs is its peak. K13 runs
on the inputs it had in the engine's bucket program (`_dispatch(keep=...)`,
full-store route), with the instance that ran where the checkout has more
than one (`ntc_kernels.bwd_instance`). Each time is the mean of --reps
launches after one. Prints the card's name and power limit, then one JSON
line per kernel and dtype. Comparing two checkouts: run each in its own
process, in one call (parent, change, change, parent).
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
        print("ntc_pre_bwd_times: torch sees no CUDA device", file=sys.stderr)
        return 1
    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn
    from dynamont_tpu_torch.utils.synthetic import make_read

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    model = load_model_for_pore("rna002")
    with tempfile.TemporaryDirectory(prefix="ntc_pre_bwd_times_") as tmp:
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

    def line(**kw) -> None:
        print(json.dumps(dict(root=root, **kw)), flush=True)

    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        eng = NTCBatchEngine(model, "rna002", device="cuda", dtype=dtype)
        gidx = list(range(N_READS))
        # K8 on the engine's pre-pass inputs, as ntc_bucket_program builds them
        T_arr, N_arr, sig, kid, N2 = eng._pad_bucket(gidx, items)
        put = lambda a: torch.from_numpy(a).to("cuda")
        sig = put(sig).to(dtype).contiguous()
        kid = put(kid).to(torch.int32).contiguous()
        N_r, T_r = put(N_arr).to(torch.int32), put(T_arr).to(torch.int32)
        lm, le, cap = eng.log_ppm, eng.log_ppe, eng.cap_n
        tab = nb.tn_tables(kid, eng.tensors["means"], eng.tensors["stdevs"], dtype)
        fwd = kn.tn_fwd(sig, tab, N_r, lm, le)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kn.tn_bwd_sel(sig, tab, kid, N_r, T_r, fwd, cap, lm, le)
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        ms = cuda_ms(lambda: kn.tn_bwd_sel(sig, tab, kid, N_r, T_r, fwd, cap, lm, le))
        parts = None
        if hasattr(kn, "tn_bwd_u"):
            u, _ = kn.tn_bwd_u(sig, tab, N_r, T_r, fwd, lm, le)
            parts = {"tn_bwd_u": cuda_ms(lambda: kn.tn_bwd_u(sig, tab, N_r, T_r, fwd, lm, le)),
                     "tn_sel": cuda_ms(lambda: kn.tn_sel(u, kid, cap))}
            del u
        line(kernel="ntc_tn_bwd_sel", dtype=name, shape=[sig.shape[0], sig.shape[1] + 1, N2],
             cap=cap, ms=ms, parts=parts, peak_above_inputs_gb=peak_gb)
        del fwd, tab, sig, kid
        torch.cuda.empty_cache()
        # K13 on the inputs it had in the engine's bucket program
        k: dict = {}
        eng._dispatch(gidx, items, eng.cap_n, eng.cap_k, keep=k, ckpt=False)
        for f in ("lp", "choices", "slots", "rec", "fin", "bwd"):
            k.pop(f, None)  # the bucket's own outputs: not needed here
        torch.cuda.empty_cache()
        plan, dims, prm, sig, tl = k["plan"], k["dims"], k["prm"], k["sig"], k["trans_log"]
        N_r, T_r = k["N_r"], k["T_r"]
        instance = None
        if hasattr(kern, "bwd_instance"):
            instance = kern.bwd_instance(dims.CN, dims.CK, dims.A, sig.element_size()).name
        ms = cuda_ms(lambda: kern.bwd(plan, dims, prm, sig, tl, N_r, T_r))
        line(kernel="ntc_bwd", dtype=name, shape=[sig.shape[0], sig.shape[1] + 1],
             dims=list(dims), instance=instance, ms=ms)
        del k, plan, prm, sig, eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

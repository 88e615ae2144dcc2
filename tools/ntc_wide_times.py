#!/usr/bin/env python3
"""CUDA-event times of the wide rung's two kernels, K14 ntc_bwd_ckpt and
K15's checkpoint mode ntc_pv_ckpt, for the checkout at --root, on one GPU:

    python3 tools/ntc_wide_times.py [--root DIR] [--reps 2]

From the package of --root (default: this checkout), on the bucket of the
resquiggle engine's wide rung that chip_smoke.py's phase 12 runs: the first
8 (WIDE_READS) of its 16 rna002 reads of 1800 bases (mean dwell 9, T
trimmed to 16000) through the TSV reader, one (8, 16384) bucket at the
wide caps (16, 240), CK 256, N2 2048, run through the engine's own bucket
program (`_dispatch(keep=...)`, the checkpointed route) in fp32 and in
fp64; then each kernel timed on the inputs it had there, in every instance
the checkout offers: the one the shape picks, and where the checkout has
the cluster instances (`ntc_kernels.bwd_ckpt_instance`), every cluster
size G the pickers allow at that shape and the one-block kernel (G 1),
each with its outputs held bit for bit against the picked instance's.
Each time is the mean of --reps launches after one. Prints the card's
name and power limit, then one JSON line per kernel, dtype and instance,
with the number of clusters of G that fit the card at once. Comparing two
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
        print("ntc_wide_times: torch sees no CUDA device", file=sys.stderr)
        return 1
    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.models.ntc_batch import WIDE_CAPS, WIDE_READS, NTCBatchEngine
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.utils.synthetic import make_read

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    model = load_model_for_pore("rna002")
    with tempfile.TemporaryDirectory(prefix="ntc_wide_times_") as tmp:
        tsv = os.path.join(tmp, "reads.tsv")
        with open(tsv, "w") as f:  # as chip_smoke.write_tsv writes the CLI's input
            for s in range(N_READS):
                sig, read = make_read(model, n_bases=N_BASES, mean_dwell=MEAN_DWELL, seed=s)
                f.write(f"r{s}\tr{s}\t{','.join(repr(float(x)) for x in sig[:T_TRIM])}"
                        f"\t{read[9:][::-1]}\n")
        items = [BatchItem(job.signal, job.read)
                 for job in readers.generate_tsv_jobs(tsv, True)][:WIDE_READS]

    def cuda_ms(fn) -> float:
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(args.reps):
            fn()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / args.reps

    bits = lambda x: x.view(torch.uint8) if x.is_floating_point() else x
    clusters = hasattr(kern, "bwd_ckpt_instance")
    for dtype in (torch.float32, torch.float64):
        eng = NTCBatchEngine(model, "rna002", device="cuda", dtype=dtype)
        k: dict = {}
        eng._dispatch(list(range(len(items))), items, *WIDE_CAPS, keep=k, ckpt=True)
        for f in ("lp", "choices", "slots", "rec", "fin"):
            k.pop(f, None)  # the bucket's own outputs: not needed here
        torch.cuda.empty_cache()
        plan, dims, prm, sig, tl = k["plan"], k["dims"], k["prm"], k["sig"], k["trans_log"]
        N_r, T_r, ckpt, Zb = k["N_r"], k["T_r"], k["ckpt"], k["Zb"]
        isz = sig.element_size()
        kw = lambda G: {} if G is None else {"G": G}  # None: the instance picked
        runs = {
            "ntc_bwd_ckpt": lambda G: kern.bwd_ckpt(plan, dims, prm, sig, tl, N_r, T_r, **kw(G)),
            "ntc_pv_ckpt": lambda G: kern.pv_ckpt(plan, dims, prm, sig, ckpt, Zb, tl, N_r, T_r,
                                                  **kw(G)),
        }
        for name, run in runs.items():
            insts = [None]  # the instance the shape picks
            if clusters:
                pick = {"ntc_bwd_ckpt": kern.bwd_ckpt_instance,
                        "ntc_pv_ckpt": kern.pv_ckpt_instance}[name]
                picked = pick(dims.CN, dims.CK, dims.A, isz)
                for G in kern.CLUSTER_SIZES + (1,):
                    try:
                        inst = pick(dims.CN, dims.CK, dims.A, isz, G)
                    except ValueError:
                        continue  # no cluster of G at this shape
                    if inst != picked:
                        insts.append(inst)
            want = None
            for inst in insts:
                G = None if inst is None else inst.G
                out = run(G)
                torch.cuda.synchronize()
                if want is None:
                    want = out
                elif not all(torch.equal(bits(g), bits(w)) for g, w in zip(out, want)):
                    raise AssertionError(f"{name} at G {G} differs from the picked instance")
                del out
                torch.cuda.empty_cache()
                ms = cuda_ms(lambda: run(G))
                info = {}
                if clusters:
                    inst = inst or pick(dims.CN, dims.CK, dims.A, isz)
                    info = dict(instance=inst.name, G=inst.G, smem_bytes=inst.nbytes)
                    if inst.name == "cluster":
                        info["clusters_fit"] = kern.ckpt_cluster_fit(name, dims, isz, inst.G)
                print(json.dumps(dict(root=root, kernel=name,
                                      dtype=str(dtype).removeprefix("torch."),
                                      shape=[sig.shape[0], sig.shape[1] + 1],
                                      dims=list(dims), **info, ms=ms)), flush=True)
            del want
            torch.cuda.empty_cache()
        del k, plan, prm, sig, ckpt, Zb, eng, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

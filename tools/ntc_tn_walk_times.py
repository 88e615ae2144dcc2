#!/usr/bin/env python3
"""CUDA-event times of K7 ntc_tn_fwd (the TN forward store) and K16
ntc_walk (the NTC traceback), for the checkout at --root, on one GPU:

    python3 tools/ntc_tn_walk_times.py [--root DIR] [--reps 2]

From the package of --root (default: this checkout), in fp32 and in fp64:
  - K7 on "resquiggle", the bucket chip_smoke.py's phase 12 runs: 16
    rna002 reads of 1800 bases (mean dwell 9, T trimmed to 16000) through
    the TSV reader, (16, 16384), N2 2048; and on "train", the trainer's
    batch of phase 13's training step, the first 24 of the smoke's reads,
    (24, 16384), at the transitions the step starts from (TRAIN_INIT_NTK).
    Each bucket is padded as the engine pads it (`_pad_bucket`).
  - K16 on "resquiggle", that bucket through the engine's bucket program
    at the main caps (8, 120) (`_dispatch(keep=...)`, the full-store
    route), and on "wide", the first 8 (WIDE_READS) of those reads at the
    wide rung's caps (16, 240), the checkpointed route, as phase 12 forces
    them; each on the lp, choices, slots and plan the engine made there.
Each time is the mean of --reps launches after one; each line's
`fingerprint` sums the bit patterns of the kernel's outputs (K7's store;
K16's records and fin), so that two checkouts' outputs compare without a
copy to the host, and `design` is the launch geometry where the checkout
has one (tn_fwd_geometry and tn_fwd_layout, walk_geometry). Prints the
card's name and power limit, then one JSON line per kernel, bucket and
dtype. Comparing two
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

N_BASES, MEAN_DWELL, T_TRIM = 1800, 9.0, 16000
N_RESQUIGGLE, N_TRAIN = 16, 24


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
        print("ntc_tn_walk_times: torch sees no CUDA device", file=sys.stderr)
        return 1
    from dynamont_tpu_torch.constants import TRAIN_INIT_NTK
    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.models.ntc_batch import WIDE_CAPS, WIDE_READS, NTCBatchEngine
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn
    from dynamont_tpu_torch.utils.synthetic import make_read

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    model = load_model_for_pore("rna002")
    reads = [make_read(model, n_bases=N_BASES, mean_dwell=MEAN_DWELL, seed=s)
             for s in range(N_TRAIN)]
    reads = [(sig[:T_TRIM], read) for sig, read in reads]
    with tempfile.TemporaryDirectory(prefix="ntc_tn_walk_times_") as tmp:
        tsv = os.path.join(tmp, "reads.tsv")
        with open(tsv, "w") as f:  # as chip_smoke.write_tsv writes the CLI's input
            for s, (sig, read) in enumerate(reads[:N_RESQUIGGLE]):
                f.write(f"r{s}\tr{s}\t{','.join(repr(float(x)) for x in sig)}"
                        f"\t{read[9:][::-1]}\n")
        tsv_items = [BatchItem(job.signal, job.read)
                     for job in readers.generate_tsv_jobs(tsv, True)]
    items = {"resquiggle": tsv_items,
             "train": [BatchItem(s, r) for s, r in reads[:N_TRAIN]]}

    def cuda_ms(fn) -> float:
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(args.reps):
            fn()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / args.reps

    def fingerprint(t) -> int:
        """The sum of the outputs' bit patterns as integers: equal outputs
        give equal fingerprints."""
        as_int = torch.int32 if t.element_size() == 4 else torch.int64
        return int(t.view(as_int).sum(dtype=torch.int64))

    def line(**kw) -> None:
        print(json.dumps(dict(root=root, **kw)), flush=True)

    tn_geo = getattr(kn, "tn_fwd_geometry", None)
    walk_geo = getattr(kern, "walk_geometry", None)
    put = lambda a: torch.from_numpy(a).cuda()
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        # K7 on the resquiggle bucket and the trainer's batch
        for bucket in ("resquiggle", "train"):
            over = TRAIN_INIT_NTK if bucket == "train" else None
            eng = NTCBatchEngine(model, "rna002", device="cuda", dtype=dtype,
                                 transition_overrides=over)
            its = items[bucket]
            _, N_arr, sig, kid, N2 = eng._pad_bucket(list(range(len(its))), its)
            sig, kid, N_r = put(sig).to(dtype), put(kid), put(N_arr)
            tab = nb.tn_tables(kid, eng.tensors["means"], eng.tensors["stdevs"], dtype)
            lm, le = eng.log_ppm, eng.log_ppe
            run = lambda: kn.tn_fwd(sig, tab, N_r, lm, le)
            fwd = run()
            prints = [fingerprint(fwd)]
            del fwd
            torch.cuda.empty_cache()
            design = None
            if tn_geo:
                design = dict(tn_geo(N2)._asdict(), layout=kn.tn_fwd_layout(sig.element_size()))
            line(kernel="ntc_tn_fwd", bucket=bucket, dtype=name,
                 shape=[sig.shape[0], sig.shape[1] + 1], N2=N2, design=design,
                 ms=cuda_ms(run), fingerprint=prints)
            del sig, kid, N_r, tab, eng, run
            torch.cuda.empty_cache()
        # K16 on the resquiggle bucket (main caps) and the wide bucket
        for bucket in ("resquiggle", "wide"):
            eng = NTCBatchEngine(model, "rna002", device="cuda", dtype=dtype)
            its = items["resquiggle"][:WIDE_READS] if bucket == "wide" else items["resquiggle"]
            caps = WIDE_CAPS if bucket == "wide" else (eng.cap_n, eng.cap_k)
            k: dict = {}
            eng._dispatch(list(range(len(its))), its, *caps, keep=k,
                          ckpt=True if bucket == "wide" else None)
            for f in ("bwd", "ckpt", "row0", "rec", "fin"):
                k.pop(f, None)
            torch.cuda.empty_cache()
            wargs = (k["lp"], k["choices"], k["slots"], k["plan"], *k["start"], k["N_r"],
                     k["T_r"], *k["walk_dims"])
            dims = k["dims"]
            run = lambda: kern.walk(*wargs)
            out = run()
            prints = [fingerprint(t) for t in out]
            del out
            line(kernel="ntc_walk", bucket=bucket, dtype=name,
                 shape=[k["sig"].shape[0], k["sig"].shape[1] + 1], caps=list(caps),
                 design=walk_geo(dims.CN, dims.CK)._asdict() if walk_geo else None,
                 ms=cuda_ms(run), fingerprint=prints)
            del k, wargs, eng, run
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

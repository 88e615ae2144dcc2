#!/usr/bin/env python3
"""CUDA-event times of the TK pre-pass kernels, K9 ntc_tk_bwd and K10
ntc_tk_fwd_u, for the checkout at --root, on one GPU:

    python3 tools/ntc_tk_times.py [--root DIR] [--reps 2]

From the package of --root (default: this checkout), in fp32 and in fp64,
on three buckets:
  - "resquiggle": the bucket chip_smoke.py's phase 12 runs, 16 rna002
    reads of 1800 bases (mean dwell 9, T trimmed to 16000) through the TSV
    reader, (16, 16384), K 1024, at the engine's main caps (8, 120);
  - "train": the trainer's batch of phase 13's training step, the first 24
    of the smoke's reads, (24, 16384), K 1024, at the transitions the step
    starts from (TRAIN_INIT_NTK);
  - "k4096": the resquiggle bucket's signal and lengths against a seeded
    synthetic K = 4096 table (means U(-2, 2), stdevs U(0.15, 0.4)), at the
    resquiggle bucket's transitions.
Each bucket's signal and lengths are those the engine's own training
program hands its kernels (`_train_bucket(keep=...)`). K9 is timed on them
and K10 on K9's store (one kernel a shape; each line's `design` is the
launch geometry where the checkout has tk_geometry). Each time is the mean of --reps launches after
one; each line's `fingerprint` sums the bit patterns of the kernel's
outputs (the store; U and finalE), so that two checkouts' outputs compare
without a copy to the host. Prints the card's name and power limit, then
one JSON line per kernel, bucket and dtype. Comparing two checkouts: run
each in its own process, in one call (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

N_BASES, MEAN_DWELL, T_TRIM = 1800, 9.0, 16000
BUCKETS = (("resquiggle", 16, 1024), ("train", 24, 1024), ("k4096", 16, 4096))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ntc_tk_times: torch sees no CUDA device", file=sys.stderr)
        return 1
    from dynamont_tpu_torch.constants import TRAIN_INIT_NTK
    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn
    from dynamont_tpu_torch.utils.synthetic import make_read

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    model = load_model_for_pore("rna002")
    reads = [make_read(model, n_bases=N_BASES, mean_dwell=MEAN_DWELL, seed=s)
             for s in range(max(n for _, n, _ in BUCKETS))]
    reads = [(sig[:T_TRIM], read) for sig, read in reads]
    with tempfile.TemporaryDirectory(prefix="ntc_tk_times_") as tmp:
        tsv = os.path.join(tmp, "reads.tsv")
        with open(tsv, "w") as f:  # as chip_smoke.write_tsv writes the CLI's input
            for s, (sig, read) in enumerate(reads[:BUCKETS[0][1]]):
                f.write(f"r{s}\tr{s}\t{','.join(repr(float(x)) for x in sig)}"
                        f"\t{read[9:][::-1]}\n")
        tsv_items = [BatchItem(job.signal, job.read)
                     for job in readers.generate_tsv_jobs(tsv, True)]
    items = {"resquiggle": tsv_items, "k4096": tsv_items,
             "train": [BatchItem(s, r) for s, r in reads[:BUCKETS[1][1]]]}
    rng = np.random.default_rng(4096)
    sd = rng.uniform(0.15, 0.4, 4096)
    synth = (rng.uniform(-2.0, 2.0, 4096), -0.5 * 1.8378770664093453 - np.log(sd),
             0.5 / (sd * sd))

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
        give equal fingerprints, so two checkouts' lines compare bit for
        bit without copying the stores to the host."""
        as_int = torch.int32 if t.element_size() == 4 else torch.int64
        return int(t.view(as_int).sum(dtype=torch.int64))

    def line(**kw) -> None:
        print(json.dumps(dict(root=root, **kw)), flush=True)

    geometry = getattr(kn, "tk_geometry", None)
    for bucket, n, K in BUCKETS:
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).removeprefix("torch.")
            over = TRAIN_INIT_NTK if bucket == "train" else None
            eng = NTCBatchEngine(model, "rna002", device="cuda", dtype=dtype,
                                 transition_overrides=over)
            kt: dict = {}
            eng._train_bucket(list(range(n)), items[bucket], keep=kt)
            sig, T_r = kt["sig"], kt["T_r"]
            del kt
            torch.cuda.empty_cache()
            if K == model.num_kmers:
                tabk = nb.tk_tables(eng.tensors["means"], eng.tensors["c1"],
                                    eng.tensors["c2"], dtype)
            else:
                tabk = nb.tk_tables(*(torch.from_numpy(a).cuda() for a in synth), dtype)
            lm, le = eng.log_ppm, eng.log_ppe
            design = (geometry(K, 4, sig.element_size())._asdict()
                      if geometry is not None else None)
            shape = [sig.shape[0], sig.shape[1] + 1]
            bwd = kn.tk_bwd(sig, tabk, T_r, 4, lm, le)
            runs = (("ntc_tk_bwd", lambda: kn.tk_bwd(sig, tabk, T_r, 4, lm, le)),
                    ("ntc_tk_fwd_u", lambda: kn.tk_fwd_u(sig, tabk, T_r, bwd, 4, lm, le)))
            for kernel, fn in runs:
                out = fn()
                prints = [fingerprint(t) for t in (out if isinstance(out, tuple) else (out,))]
                del out
                line(kernel=kernel, bucket=bucket, dtype=name, shape=shape, K=K,
                     design=design, ms=cuda_ms(fn), fingerprint=prints)
            del bwd, runs, sig, tabk, eng
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

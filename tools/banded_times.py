#!/usr/bin/env python3
"""CUDA-event times of the main path's K1 (banded_bwd), K2
(banded_fwd_vit) and K3 (banded_walk), of the basic trainer's K5
(banded_fwd) and K6 (banded_bwd_train), and of the matrix route's K4
(banded_vit), for the checkout at --root, on one GPU:

    python3 tools/banded_times.py [--root DIR] [--reps 3] [--sweep]
                                  [--group all|segment|train|matrix]

From the package of --root (default: this checkout), on the buckets
chip_smoke.py builds from rna002 reads of 1800 bases (mean dwell 9, T
trimmed to 16000). Group segment, K1-K3: the reads decoded as the engine
decodes them, (32, 16384, 512) in fp32, the main path's, and (2, 16384,
512) in fp64, phase 3's, at the band width the exact per-read fp64 rung
takes for such reads. Group train, K5 and K6: the reads prepared as the
trainer prepares them (ops/nt_banded_batch.prepare_batch, t_pad_to 512),
(24, 16384, 512) in fp32, the trainer's batch, and (2, 16384, 512) in
fp64, K6 over K5's fE; and K5 on the matrix route's (32, 16384, 512) fp32
bucket (prepared as BandedBatchEngine(device_pipeline=False) prepares
it). Group matrix, K4: the matrix route's (32, 16384, 512) in fp32 and
(2, 16384, 512) in fp64, prepared so, over K5's and K1's stored rows.
Each time is the mean of --reps launches after one; each line's
`fingerprint` sums the bit patterns of the kernel's outputs, so that two
checkouts' lines compare bit for bit, and `C` gives the rows a staged
chunk where the checkout's wrappers say. With --sweep, where the
checkout's K2 and K1 take their chunk rows from
ops/nt_banded_kernels.staging, each is also timed at every smaller chunk
in SWEEP and BWD_SWEEP, and K4 in VIT_SWEEP, its outputs compared with
those at its own chunk.
Prints the card's name and power limit, then one JSON line per time.
Comparing two checkouts: run each in its own process, in one call
(parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

SWEEP = {"float32": (4, 8, 12, 16), "float64": (2, 4, 6, 8)}
BWD_SWEEP = (16, 32, 64, 128)
VIT_SWEEP = (2, 4, 8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--group", choices=("all", "segment", "train", "matrix"),
                    default="all")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("banded_times: torch sees no CUDA device", file=sys.stderr)
        return 1
    from dynamont_tpu_torch.constants import NT_TRANSITIONS
    from dynamont_tpu_torch.models.packing import t_pad_ladder
    from dynamont_tpu_torch.models.params import params_from_numpy
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.ops import nt_banded_batch as bb
    from dynamont_tpu_torch.ops import nt_banded_device as dv
    from dynamont_tpu_torch.ops import nt_banded_kernels as kk
    from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids
    from dynamont_tpu_torch.utils.synthetic import make_read

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0], flush=True)
    model = load_model_for_pore("rna002")
    m1, e2 = NT_TRANSITIONS["rna002"]["m1"], NT_TRANSITIONS["rna002"]["e2"]
    lm, le = math.log(m1), math.log(e2)
    reads = []
    for s in range(32):
        sig, read = make_read(model, n_bases=1800, mean_dwell=9.0, seed=s)
        reads.append((sig[:16000], read))

    def bucket(items, dtype):
        kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size) for _, r in items]
        t_pad = t_pad_ladder(max(len(s) for s, _ in items) + 1, 512)
        wire = dv.prepare_wire([s for s, _ in items], kids, device="cuda", t_pad=t_pad)
        p = params_from_numpy(model, m1, e2, device="cuda", dtype=dtype)
        return dv.decode(wire, p.means, p.c1, p.c2, dtype), wire.N_max

    def cuda_ms(fn) -> float:
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(args.reps):
            fn()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / args.reps

    def fingerprint(*ts) -> list:
        """Each output's bit patterns summed as integers."""
        out = []
        for t in ts:
            as_int = {1: torch.uint8, 4: torch.int32, 8: torch.int64}[t.element_size()]
            out.append(int(t.view(as_int).sum(dtype=torch.int64)))
        return out

    if args.group in ("all", "train"):
        train_times(root, model, reads, lm, le, bb, kk, cuda_ms, fingerprint)
    if args.group in ("all", "matrix"):
        matrix_times(root, model, reads, lm, le, bb, kk, cuda_ms, fingerprint, args.sweep)
    if args.group in ("train", "matrix"):
        return 0
    for items, dtype in ((reads, torch.float32), (reads[:2], torch.float64)):
        b, nmax = bucket(items, dtype)
        shape = [b.sig.shape[0], b.bstart.shape[1], b.B]
        dname = str(dtype).removeprefix("torch.")
        bM, bE = kk.backward(b, lm, le)
        Zb = bE[torch.arange(shape[0], device="cuda"), 0, b.bw.long() + 1]
        ch, LPM, LPE, _ = kk.fwd_vit(b, bM, bE, Zb, lm, le)
        rows = bwd_rows = None
        if hasattr(kk, "staging"):
            st = kk.staging(b.B, bM.element_size())
            rows, bwd_rows = st.fwd_vit_rows, getattr(st, "bwd_rows", None)
        line = dict(root=root, dtype=dname, shape=shape)
        print(json.dumps(dict(line, kernel="banded_bwd", C=bwd_rows,
                              ms=cuda_ms(lambda: kk.backward(b, lm, le)),
                              fingerprint=fingerprint(bM, bE))), flush=True)
        print(json.dumps(dict(line, kernel="banded_fwd_vit", C=rows,
                              ms=cuda_ms(lambda: kk.fwd_vit(b, bM, bE, Zb, lm, le)),
                              fingerprint=fingerprint(ch, LPM, LPE))), flush=True)
        print(json.dumps(dict(line, kernel="banded_walk",
                              ms=cuda_ms(lambda: kk.walk(LPM, LPE, ch, b, nmax)),
                              fingerprint=fingerprint(*kk.walk(LPM, LPE, ch, b, nmax)))),
              flush=True)
        if args.sweep and rows is not None:
            staging = kk.staging
            for C in (c for c in SWEEP[dname] if c < rows):
                kk.staging = lambda B, itemsize, C=C: staging(B, itemsize)._replace(
                    fwd_vit_rows=C)
                try:
                    got = kk.fwd_vit(b, bM, bE, Zb, lm, le)
                    same = all(torch.equal(x, y) for x, y in zip(got, (ch, LPM, LPE)))
                    ms = cuda_ms(lambda: kk.fwd_vit(b, bM, bE, Zb, lm, le))
                finally:
                    kk.staging = staging
                print(json.dumps(dict(line, kernel="banded_fwd_vit", C=C, ms=ms,
                                      same_outputs=same)), flush=True)
        if args.sweep and bwd_rows is not None:
            staging = kk.staging
            for C in (c for c in BWD_SWEEP if c < bwd_rows):
                kk.staging = lambda B, itemsize, C=C: staging(B, itemsize)._replace(
                    bwd_rows=C)
                try:
                    got = kk.backward(b, lm, le)
                    same = all(torch.equal(x, y) for x, y in zip(got, (bM, bE)))
                    del got
                    ms = cuda_ms(lambda: kk.backward(b, lm, le))
                finally:
                    kk.staging = staging
                print(json.dumps(dict(line, kernel="banded_bwd", C=C, ms=ms,
                                      same_outputs=same)), flush=True)
        del bM, bE, ch, LPM, LPE
        torch.cuda.empty_cache()
    return 0


def train_times(root, model, reads, lm, le, bb, kk, cuda_ms, fingerprint) -> None:
    """K5 and K6 on the trainer's batches, K5 on the matrix route's bucket."""
    import torch

    from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids

    def batch(items, dtype):
        kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size) for _, r in items]
        return bb.prepare_batch([s for s, _ in items], kids, model, device="cuda",
                                dtype=dtype, t_pad_to=512)

    staging = getattr(kk, "train_staging", None)
    for bucket, items, dtype in (("trainer", reads[:24], torch.float32),
                                 ("trainer", reads[:2], torch.float64),
                                 ("matrix", reads, torch.float32)):
        b = batch(items, dtype)
        st = staging(b.B, b.sig.element_size()) if staging else None
        line = dict(root=root, bucket=bucket, dtype=str(dtype).removeprefix("torch."),
                    shape=[b.sig.shape[0], b.bstart.shape[1], b.B])
        fM, fE = kk.forward(b, lm, le)
        print(json.dumps(dict(line, kernel="banded_fwd", C=st and st.fwd_rows,
                              ms=cuda_ms(lambda: kk.forward(b, lm, le)),
                              fingerprint=fingerprint(fM, fE))), flush=True)
        del fM
        if bucket == "trainer":
            out = kk.backward_train(b, fE, lm, le)
            print(json.dumps(dict(line, kernel="banded_bwd_train",
                                  C=st and st.bwd_train_rows,
                                  ms=cuda_ms(lambda: kk.backward_train(b, fE, lm, le)),
                                  fingerprint=fingerprint(*out))), flush=True)
            del out
        del fE, b
        torch.cuda.empty_cache()


def matrix_times(root, model, reads, lm, le, bb, kk, cuda_ms, fingerprint,
                 sweep: bool) -> None:
    """K4 over K5's and K1's rows of the matrix route's buckets; with
    `sweep`, where the checkout's K4 takes its chunk rows from
    ops/nt_banded_kernels.staging, also at every smaller chunk in
    VIT_SWEEP, its outputs compared with those at its own chunk."""
    import torch

    from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids

    for items, dtype in ((reads, torch.float32), (reads[:2], torch.float64)):
        kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size) for _, r in items]
        b = bb.prepare_batch([s for s, _ in items], kids, model, device="cuda",
                             dtype=dtype, t_pad_to=512)
        fM, fE = kk.forward(b, lm, le)
        bM, bE = kk.backward(b, lm, le)
        rows = (fM, fE, bM, bE, bE[torch.arange(len(items), device="cuda"), 0,
                                   b.bw.long() + 1])
        rows_of = getattr(kk.staging(b.B, fM.element_size()), "vit_rows", None)
        out = kk.viterbi_post(b, *rows)
        line = dict(root=root, bucket="matrix", dtype=str(dtype).removeprefix("torch."),
                    shape=[len(items), b.bstart.shape[1], b.B], kernel="banded_vit")
        print(json.dumps(dict(line, C=rows_of, ms=cuda_ms(lambda: kk.viterbi_post(b, *rows)),
                              fingerprint=fingerprint(*out))), flush=True)
        staging = kk.staging
        for C in (c for c in VIT_SWEEP if sweep and rows_of and c < rows_of):
            kk.staging = lambda B, itemsize, C=C: staging(B, itemsize)._replace(vit_rows=C)
            try:
                same = all(torch.equal(x, y) for x, y in zip(kk.viterbi_post(b, *rows), out))
                ms = cuda_ms(lambda: kk.viterbi_post(b, *rows))
            finally:
                kk.staging = staging
            print(json.dumps(dict(line, C=C, ms=ms, same_outputs=same)), flush=True)
        del b, rows, fM, fE, bM, bE, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())

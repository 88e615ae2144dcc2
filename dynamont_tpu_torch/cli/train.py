"""dynamont-train on PyTorch + CUDA, basic and resquiggle (NTC) mode
(counterpart of dynamont_tpu/cli/train.py; ref:
src/python/segmentation/train.py).

Same flags and defaults (batch_size 24, epochs 1, qscore 10), same
trained_{epoch}_{batch}.model checkpoints and params.csv, on one torch
device. --distributed is not ported yet.

    python -m dynamont_tpu_torch.cli.train --tsv reads.tsv -o outdir \\
        -p rna002 --mode basic|resquiggle [--device cuda]
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser

from dynamont_tpu_torch.constants import PORES


def build_parser() -> ArgumentParser:
    p = ArgumentParser(prog="dynamont-train")
    p.add_argument("-r", "--raw", metavar="DIR", default=None)
    p.add_argument("-b", "--basecalls", metavar="BAM", default=None)
    p.add_argument("--tsv", metavar="TSV", default=None,
                   help="Plain-TSV read source (readid, signalid, signal, read)")
    p.add_argument("-o", "--outdir", required=True)
    p.add_argument("-p", "--pore", required=True, choices=list(PORES))
    p.add_argument("--mode", choices=["basic", "resquiggle"], required=True)
    p.add_argument("--model_path", default=None,
                   help="Initial kmer model (default: packaged per-pore model)")
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("-e", "--epochs", type=int, default=1)
    p.add_argument("-q", "--qscore", type=float, default=10.0)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--precision", choices=["auto", "fp64", "fp32"],
                   default="auto",
                   help="auto (default): fp32 on a CUDA device, fp64 on the "
                        "CPU; resquiggle-mode reads failing a gate or cap "
                        "re-run on the exact fp64 rung")
    p.add_argument("--resume", action="store_true",
                   help="continue from the last trained_{epoch}_{batch} "
                        "checkpoint in the output dir (skips the batches "
                        "params.csv records as done)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host training: not yet ported to the "
                        "PyTorch package (exits with an error)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; the run "
                        "fails rather than fall back to the CPU)")
    return p


def main(argv=None):
    """Run the training; returns the closed Trainer (its counters say how
    many reads took the per-read fp64 NTC rung)."""
    args = build_parser().parse_args(argv)
    if args.tsv is None and (args.raw is None or args.basecalls is None):
        print("provide either --tsv or both --raw and --basecalls", file=sys.stderr)
        raise SystemExit(2)
    if args.distributed:
        print("--distributed training is not yet ported to the PyTorch "
              "package; use dynamont_tpu's dynamont-train", file=sys.stderr)
        raise SystemExit(2)

    import torch

    from dynamont_tpu_torch.constants import is_rna
    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch.models.registry import get_model_path
    from dynamont_tpu_torch.training.trainer import Trainer, read_passes_filters

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: torch sees no CUDA device (pass --device cpu "
              "to run the plain-torch path)", file=sys.stderr)
        raise SystemExit(2)

    rna = is_rna(args.pore)
    model_path = args.model_path or get_model_path(args.pore)
    trainer = Trainer(
        args.mode, args.pore, args.outdir, model_path,
        batch_size=args.batch_size, epochs=args.epochs, resume=args.resume,
        precision=args.precision, device=device,
    )

    def jobs():
        # (basecall seq, materialize thunk): batch membership only needs
        # the sequence, so skipped batches on --resume never touch raw data
        if args.tsv is not None:
            for job in readers.generate_tsv_jobs(args.tsv, rna, args.qscore):
                yield job.read_5to3, (lambda j=job: j)
        else:
            for raw in readers.generate_bam_jobs(args.raw, args.basecalls,
                                                 args.qscore):
                yield raw[5], (
                    lambda r=raw: readers.materialize_bam_job(r, rna)
                )

    try:
        for epoch in range(trainer.resume_epoch, args.epochs):
            skip = trainer.resume_skip_batches if epoch == trainer.resume_epoch else 0
            batch = []
            n_batch = 0
            for seq, make_job in jobs():
                if not read_passes_filters(seq):
                    continue
                batch.append(make_job)
                if len(batch) == args.batch_size:
                    n_batch += 1
                    if n_batch > skip:
                        materialized = []
                        for mk in batch:
                            try:
                                materialized.append(mk())
                            except Exception as e:  # unreadable raw data
                                print(f"raw read failed: {e}",
                                      file=sys.stderr)
                        if materialized:
                            trainer.process_batch(materialized, epoch)
                    batch = []
                    if args.max_batches and trainer.batch_num >= args.max_batches:
                        break
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()

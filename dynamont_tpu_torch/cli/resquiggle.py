"""dynamont-resquiggle on PyTorch + CUDA (counterpart of
dynamont_tpu/cli/resquiggle.py).

Reads come from a plain TSV (--tsv) or a dorado BAM + raw directory; they
are bucketed and segmented by the banded engine (--mode basic) or the NTC
engine (--mode resquiggle, models/ntc_batch), buckets round-robin over
every visible GPU for --device cuda (one for cuda:N), and the results
stream to a zstd CSV with the reference's columns and `.errors` sidecar.
--ntc-native-9mer runs a >5-mer model at its native K in resquiggle mode
instead of reducing it to 5-mer tables. --distributed splits the read
stream over processes (read i to rank i % world, torch.distributed on
gloo; DYNAMONT_COORDINATOR / DYNAMONT_NUM_PROCESSES / DYNAMONT_PROCESS_ID
or torchrun's variables), each writing <outfile>.rank<k>.

    python -m dynamont_tpu_torch.cli.resquiggle --tsv reads.tsv \\
        -o out.csv.zst --mode basic|resquiggle -p rna002 [--device cuda]
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser
from collections import deque

from dynamont_tpu_torch.constants import PORES


def build_parser() -> ArgumentParser:
    p = ArgumentParser(prog="dynamont-resquiggle")
    p.add_argument("-r", "--raw", metavar="DIR", default=None,
                   help="Path to raw ONT data (pod5/fast5/slow5 directory)")
    p.add_argument("-b", "--basecalls", metavar="BAM", default=None,
                   help="Basecalls of ONT training data as .bam file")
    p.add_argument("--tsv", metavar="TSV", default=None,
                   help="Plain-TSV read source (readid, signalid, signal, read)")
    p.add_argument("-o", "--outfile", metavar="CSV", required=True,
                   help="Outfile path (.csv.zst)")
    p.add_argument("--mode", choices=["basic", "resquiggle"], required=True)
    p.add_argument("-p", "--pore", required=True, choices=list(PORES))
    p.add_argument("--model_path", default=None)
    p.add_argument("-q", "--qscore", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=None,
                   help="reads per device bucket (default 32 basic, 16 "
                        "resquiggle)")
    p.add_argument("-t", "--processes", type=int, default=None,
                   help="accepted for reference compatibility; device "
                        "batching replaces the process pool")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default) every "
                        "visible GPU, buckets round-robin, cuda:N one, cpu "
                        "the plain-torch path; the run fails rather than "
                        "fall back to the CPU")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process run over torch.distributed (gloo): "
                        "each process takes every world-th read (round-robin "
                        "shard of the job stream; output files get a "
                        ".rank<k> suffix). Set DYNAMONT_COORDINATOR, "
                        "DYNAMONT_NUM_PROCESSES, DYNAMONT_PROCESS_ID (or run "
                        "under torchrun); a failed bring-up ends the run")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run: reads already in the "
                        "output CSV are skipped, new results are appended")
    p.add_argument("--ntc-native-9mer", action="store_true",
                   help="resquiggle mode with a >5-mer model: run NTC at "
                        "native K (true 9-mer polish calls, ref: "
                        "NTC_main.cpp:95-99) instead of the reduced 5-mer "
                        "tables; memory-heavy")
    p.add_argument("--profile", action="store_true",
                   help="trace the engine (dynamont_tpu_torch/tracing.py; "
                        "totals per span name, in constant memory) and print "
                        "to stderr, per span name, its count, host seconds, "
                        "self seconds and summed counts (reads, samples, "
                        "bytes each way, basic mode's band matrices), then "
                        "reads a bucket and the padded-sample share over "
                        "every bucket run, the largest bucket's band "
                        "matrices, and the rungs' retry counts")
    return p


def main(argv=None):
    """Runs the CLI; returns the engine (for in-process callers)."""
    args = build_parser().parse_args(argv)
    if args.tsv is None and (args.raw is None or args.basecalls is None):
        print("provide either --tsv or both --raw and --basecalls", file=sys.stderr)
        raise SystemExit(2)
    # reads per bucket: the flag, else the mode's default (32 basic, 16
    # resquiggle); the chunk (_pump_engine) reads the flag as given
    bucket = args.batch_size or (32 if args.mode == "basic" else 16)

    import os

    import torch

    from dynamont_tpu_torch import tracing
    from dynamont_tpu_torch.constants import is_rna
    from dynamont_tpu_torch.io import output as out_io
    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.models.batch import BandedBatchEngine
    from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
    from dynamont_tpu_torch.parallel.mesh import (
        init_distributed, local_devices, rank_world,
    )

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: torch sees no CUDA device (pass --device cpu "
              "to run the plain-torch path)", file=sys.stderr)
        raise SystemExit(2)
    devices = local_devices(args.device)

    rna = is_rna(args.pore)
    model = load_model_for_pore(args.pore, args.model_path)
    # multi-process data parallelism: reads are embarrassingly parallel, so
    # each process handles a round-robin shard of the job stream and
    # writes its own output file (no cross-process tensor traffic)
    rank, world = 0, 1
    outfile = args.outfile
    if args.distributed:
        init_distributed(required=True)
        rank, world = rank_world()
        if world > 1:
            outfile = f"{args.outfile}.rank{rank}"
    done: set = set()
    resume = args.resume and os.path.exists(outfile)
    if resume:
        done = out_io.prepare_resume(outfile)
        print(f"resume: skipping {len(done)} already-segmented reads",
              file=sys.stderr)
    writer = out_io.SegmentationWriter(outfile, append=resume)

    def jobs():
        if args.tsv is not None:
            source = readers.generate_tsv_jobs(args.tsv, rna, args.qscore)
            for i, job in enumerate(source):
                if i % world == rank and job.readid not in done:
                    yield job
            return
        for i, raw in enumerate(readers.generate_bam_jobs(
                args.raw, args.basecalls, args.qscore)):
            if i % world != rank or raw[6] in done:
                continue
            try:
                yield readers.materialize_bam_job(raw, rna)
            except Exception as e:  # unreadable raw data -> sidecar
                writer.put_error(
                    f"error: raw read failed, {e}\tRid: {raw[6]}\tSid: {raw[7]}")

    if args.profile:
        tracing.enable()
    try:
        if args.mode == "basic":
            eng = BandedBatchEngine(model, args.pore, devices=devices,
                                    batch_size=bucket)
            _pump_engine(args, eng, jobs(), writer, rna, model, "error: 3, ")
        else:
            # cap-overflow reads re-run inside the engine (wide rung, then
            # the exact per-read path)
            eng = NTCBatchEngine(model, args.pore, devices=devices,
                                 batch_size=bucket,
                                 native_kmer=args.ntc_native_9mer)
            _pump_engine(args, eng, jobs(), writer, rna, model, "error: ")
    finally:
        writer.close()
        if args.profile:
            tracing.disable()
    if args.profile:
        if args.mode == "basic":
            _print_profile(eng, "banded.bucket", ("z_retries",))
        else:
            _print_profile(eng, "ntc.bucket", ("wide_retries", "exact_retries"))
    return eng


def _print_profile(eng, bucket: str, rungs) -> None:
    """--profile's lines: per span name its count, host seconds, self
    seconds (less its child spans') and summed counts, then the fill of the
    `bucket` spans, their largest band matrices (models/batch.
    pack_card_buckets bounds those of buckets of more than one read) and
    the engine's retries."""
    from dynamont_tpu_torch import tracing

    totals = tracing.totals()
    for name, t in totals.items():
        counts = "".join(f" {k} {v}" for k, v in t.counts.items())
        print(f"profile: {name} {t.n} spans {t.ns / 1e9:.6f} s self "
              f"{t.self_ns / 1e9:.6f} s{counts}", file=sys.stderr)
    b = totals.get(bucket, tracing.Total())
    reads, padded = b.counts.get("reads", 0), b.counts.get("padded_samples", 0)
    share = 100.0 * (1.0 - b.counts["samples"] / padded) if padded else 0.0
    line = (f"profile: {reads} reads in {b.n} buckets, "
            f"{reads / max(1, b.n):.3f} reads a bucket, "
            f"padded samples {share:.3f} %")
    if "band_bytes" in b.peak:
        line += f", band_bytes at most {b.peak['band_bytes']} a bucket"
    for k in rungs:
        line += f", {k} {eng.profile.get(k, 0)}"
    print(line, file=sys.stderr)


def _emit(writer, job, out, model, rna) -> None:
    """CSV bytes of one read: the native formatter straight from the
    device summaries, else the Python one (byte-identical)."""
    from dynamont_tpu_torch.io import output as out_io
    from dynamont_tpu_torch.native import summaries_csv_native

    last = len(job.signal) + job.sig_offset
    if out.summaries is not None:
        starts_row, medians_row, N, kmer_size = out.summaries
        data = summaries_csv_native(
            f"{job.readid},{job.signalid},", starts_row, medians_row, N,
            job.read, kmer_size, rna, job.sig_offset, last)
        if data is not None:
            writer.put_result(data)
            return
    writer.put_result(out_io.format_segments_csv(
        job.readid, job.signalid, out.segments, job.sig_offset, last,
        job.read, model.kmer_size, rna))


def _dump_failed_input(job) -> str:
    """Repro dump for a read that crashed the engine: the reference stdin
    format (signal csv line + read line), like the reference's training
    repro dump (ref: FileIO.py:281-283). Returns the dump path."""
    path = f"failed_input_{job.readid}.txt"
    with open(path, "w") as fh:
        fh.write(",".join(repr(float(v)) for v in job.signal))
        fh.write("\n")
        fh.write(job.read)
        fh.write("\n")
    return path


# chunks dispatched ahead of collection, as in the JAX CLI: 3 chunks of
# (--batch_size or 32) * 4 reads, 128 by default in both modes (8 buckets
# of 16 in resquiggle mode); queued launches hold their inputs and outputs,
# the DP working set is per launch
INFLIGHT = 3


def _pump_engine(args, eng, jobs, writer, rna, model, err_prefix: str) -> None:
    """Stream jobs through the engine with a rolling window: up to INFLIGHT
    chunks are dispatched before the oldest is collected, so the device
    does not drain between chunks. A chunk whose run raises is re-run read
    by read, so one bad read costs only itself a sidecar line and a repro
    dump (_dump_failed_input, in the working directory). A chunk is
    (--batch_size, or 32) * 4 reads in both modes, as in dynamont_tpu: four
    buckets in basic mode, eight of the 16-read default buckets in
    resquiggle mode."""
    from dynamont_tpu_torch.models.batch import BatchItem

    chunk_size = (args.batch_size or 32) * 4
    window: deque = deque()

    def emit(outs):
        for o in outs:
            job = o.item.meta
            if o.error is not None:
                writer.put_error(
                    f"{err_prefix}{o.error}\tT: {len(job.signal)}"
                    f"\tN: {len(job.read)}\tRid: {job.readid}"
                    f"\tSid: {job.signalid}")
            else:
                _emit(writer, job, o, model, rna)

    def isolate(part, why):
        print(f"engine exception on a {len(part)}-read chunk: {why}; "
              "isolating per read", file=sys.stderr)
        for job in part:
            try:
                emit(eng.run([BatchItem(job.signal, job.read, job)]))
            except Exception as e:  # the read itself breaks the engine
                path = _dump_failed_input(job)
                writer.put_error(
                    f"error: engine exception, {e}\tT: {len(job.signal)}"
                    f"\tN: {len(job.read)}\tRid: {job.readid}"
                    f"\tSid: {job.signalid}\tdump: {path}")

    def collect_oldest():
        handle, part = window.popleft()
        try:
            outs = eng.collect(handle)
        except Exception as e:
            isolate(part, e)
            return
        emit(outs)

    def submit(part):
        try:
            handle = eng.dispatch([BatchItem(j.signal, j.read, j) for j in part])
        except Exception as e:
            isolate(part, e)
            return
        window.append((handle, part))
        if len(window) > INFLIGHT:
            collect_oldest()

    chunk: list = []
    for job in jobs:
        chunk.append(job)
        if len(chunk) >= chunk_size:
            submit(chunk)
            chunk = []
    if chunk:
        submit(chunk)
    while window:
        collect_oldest()


if __name__ == "__main__":
    main()

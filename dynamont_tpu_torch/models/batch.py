"""Batched banded segmentation engine (counterpart of
dynamont_tpu/models/batch.py): reads are packed into padded buckets, each
bucket runs as one device program, and reads that fail the fp32 Z gate
escalate to the exact per-read fp64 rung.

Two routes, as in the JAX package. The device pipeline (the default):
wire -> decode -> three kernels (K1-K3) -> summaries; dispatch() queues
every bucket on the current CUDA stream and starts the summaries' copies
into pinned host memory, collect() waits for them, so host formatting of
one chunk can overlap the device work of the next. The matrix route
(device_pipeline=False): raw signals prepared on the host with no wire
quantization, the full posterior matrices from K5 -> K1 -> K4
(ops/nt_banded_batch.banded_batch_run), walked on the host by the native
traceback; collect() runs it bucket by bucket.

The devices are given explicitly: `device=` one, or `devices=` a list that
buckets go to round-robin (counterpart of the JAX engine's `devices`, which
defaults to every local chip; the CLIs turn `--device cuda` into every
visible GPU, parallel/mesh.local_devices). Each device holds its own copy
of the k-mer tables, and a bucket's fp64 retries run on its own device.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from dynamont_tpu_torch import tracing
from dynamont_tpu_torch.constants import NT_TRANSITIONS
from dynamont_tpu_torch.models.packing import pack_buckets, t_pad_ladder
from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.models.nt import ZConsistencyError, _validate
from dynamont_tpu_torch.models.nt_banded import run_nt_banded
from dynamont_tpu_torch.models.params import params_from_numpy
from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops import nt_banded_device as dv
from dynamont_tpu_torch.ops.nt_banded_kernels import band_bytes
from dynamont_tpu_torch.parallel.mesh import on_device

# bucket limits of the JAX engine's defaults: padded lengths on the
# t_pad_ladder floored at 512 rows; the matrix route's buckets at most 4M
# padded samples
T_PAD_TO = 512
MAX_BATCH_SAMPLES = 4_000_000
# the device route's bound on the band matrices that a bucket of more than
# one read stores (band_bytes): every read of a bucket runs at once on the
# card, so padding costs it memory, not time, and the budget bounds that
# memory in bytes. A chunk whose reads x rows packing (pack_buckets) makes a
# larger bucket gets that bucket's bytes as its budget, so its buckets cost
# no more rows than that packing's, and no more memory than the larger of
# the two; float32 buckets hold twice the reads of float64 ones
BAND_BYTES_BUDGET = 7 * 2**29


@dataclass
class BatchItem:
    """One read prepared for the DP (already normalized/filtered/oriented)."""

    signal: np.ndarray
    read: str
    meta: object = None  # carried through untouched (read id, signal id, ...)


@dataclass
class BatchOutput:
    item: BatchItem
    _segments: list | None  # None => failed read (or lazily built below)
    Z: float
    error: str | None = None
    # device summaries (starts_row, medians_row, N, kmer_size): the CLI
    # formats CSV from these; segment tuples are built on demand
    summaries: tuple | None = None

    @property
    def segments(self) -> list | None:
        if self._segments is None and self.summaries is not None:
            self._segments = dv.summaries_to_segments(*self.summaries)
        return self._segments


def device_list(device, devices) -> list[torch.device]:
    """The engines' device list: `devices`, else [`device`]; every CUDA
    entry must be visible."""
    if (device is None) == (devices is None):
        raise TypeError("give exactly one of device= and devices=")
    devs = [torch.device(d) for d in (devices if devices is not None else [device])]
    if not devs:
        raise ValueError("devices= is empty")
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {d} requested but torch sees no CUDA device")
    return devs


def next_device(eng) -> torch.device:
    """The device of an engine's next bucket, round-robin over
    eng.devices, counted in eng.profile["device_buckets"]."""
    slot = eng._next_dev % len(eng.devices)
    eng._next_dev += 1
    eng.profile["device_buckets"][slot] += 1
    return eng.devices[slot]


def nbytes(arrays) -> int:
    """Bytes of the tensors and arrays among `arrays` (a bucket's wire or
    results)."""
    return sum(a.nbytes for a in arrays
               if isinstance(a, (torch.Tensor, np.ndarray)))


def fill_counts(T, t_pad: int) -> dict:
    """A bucket's counts of its fill: its reads, their samples (each read's
    T) and its padded samples (reads x t_pad, the rows the kernels run)."""
    return {"reads": len(T), "samples": int(T.sum()),
            "padded_samples": len(T) * t_pad}


def pack_card_buckets(lengths, N, *, batch_size: int, band: int,
                      itemsize: int, budget: int = BAND_BYTES_BUDGET):
    """The device route's buckets: reads (signal `lengths`, `N` k-mers + 1)
    in buckets, each a list of indices ordered short-to-long, that minimize
    the rows the card runs in sequence.

    K1-K3 run one thread block a read and each read's rows to its own T, so
    a bucket of up to `batch_size` reads (no more than the card's SMs)
    costs its longest read's padded rows, not reads x rows as
    models/packing.pack_buckets charges (the TPU's read groups ran a
    bucket's reads one after another):

        rows(bucket) = t_pad(longest) + 512 (a launch)

    A bucket holds at most `batch_size` reads, and one of more than one
    read at most max(`budget`, the largest bucket of pack_buckets) bytes of
    band matrices (band_bytes, at its own B and `itemsize`). pack_buckets'
    buckets, contiguous runs of the same sorted order, are thus one split
    the DP weighs, so its buckets never cost more rows. An exact interval
    DP over the reads sorted by length, as pack_buckets: a bucket's bytes
    grow with each read added, so each bucket end's search stops at the
    first that does not fit.
    """
    n = len(lengths)
    order = sorted(range(n), key=lambda i: lengths[i])
    pads = [t_pad_ladder(lengths[i] + 1, T_PAD_TO) for i in order]
    widths = [dv.band_width(band, N[i]) for i in order]
    for b in pack_buckets(lengths, batch_size=batch_size, group=1,
                          max_batch_samples=MAX_BATCH_SAMPLES, t_pad_to=T_PAD_TO):
        budget = max(budget, band_bytes(
            len(b), t_pad_ladder(max(lengths[i] for i in b) + 1, T_PAD_TO),
            max(dv.band_width(band, N[i]) for i in b), itemsize))
    cost = [0] + [math.inf] * n
    cut = [0] * (n + 1)
    for i in range(1, n + 1):
        t_pad, B = pads[i - 1], 0  # sorted: the last read is the longest
        for j in range(i - 1, max(0, i - batch_size) - 1, -1):
            B = max(B, widths[j])
            if i - j > 1 and band_bytes(i - j, t_pad, B, itemsize) > budget:
                break
            c = cost[j] + t_pad + 512
            if c <= cost[i]:  # ties: the larger last bucket
                cost[i], cut[i] = c, j
    buckets = []
    i = n
    while i > 0:
        buckets.append(order[cut[i]:i])
        i = cut[i]
    return buckets[::-1]


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """Start a copy of x into pinned host memory (no wait on CUDA)."""
    if x.device.type == "cpu":
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x, non_blocking=True)
    return out


class BandedBatchEngine:
    """Runs banded segmentation over arbitrary read lists, its buckets
    round-robin over its devices."""

    def __init__(self, model, pore: str, *, device=None, devices=None,
                 dtype=torch.float32, batch_size: int = 32, band: int = 400,
                 fp64_fallback: bool = True, device_pipeline: bool = True,
                 hampel_on_device: bool = False):
        self.devices = device_list(device, devices)
        self.device = self.devices[0]
        self._next_dev = 0
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be float32 or float64, not {dtype}")
        self.model = model
        self.pore = pore
        self.m1, self.e2 = NT_TRANSITIONS[pore]["m1"], NT_TRANSITIONS[pore]["e2"]
        self.band = band
        self.dtype = dtype
        self.batch_size = batch_size
        self.fp64_fallback = fp64_fallback
        self.device_pipeline = device_pipeline
        # always-on totals across run() calls: dispatch_s = host prep and
        # queueing, collect_s = summary decode and the gate, each with the
        # waits on the card inside it (a full launch queue, the buckets'
        # done events; on a busy card nearly all of it); device_buckets
        # counts the buckets sent to each entry of the device list
        self.profile = {"buckets": 0, "reads": 0, "dispatch_s": 0.0,
                        "collect_s": 0.0,
                        "device_buckets": [0] * len(self.devices)}
        # the k-mer tables once per distinct device
        self._dev_run = {}
        for d in self.devices:
            if d not in self._dev_run:
                p = params_from_numpy(model, self.m1, self.e2, device=d,
                                      dtype=dtype)
                self._dev_run[d] = dv.make_device_fn(
                    p.means, p.c1, p.c2, p.log_m1, p.log_e2,
                    hampel=hampel_on_device)
        self._run = bb.make_banded_batch_fn(self.m1, self.e2)

    def _buckets(self, items: list[BatchItem]):
        """Reads packed into padded buckets: the device route's by what a
        bucket costs the card (pack_card_buckets), the matrix route's by
        reads x rows (models/packing.py, group 1), as its cost is the
        matrices it moves to the host."""
        lengths = [len(it.signal) for it in items]
        if not self.device_pipeline:
            return pack_buckets(lengths, batch_size=self.batch_size,
                                max_batch_samples=MAX_BATCH_SAMPLES,
                                t_pad_to=T_PAD_TO, group=1)
        k = self.model.kmer_size
        return pack_card_buckets(
            lengths, [len(it.read) - k + 2 for it in items],
            batch_size=self.batch_size, band=self.band,
            itemsize=self.dtype.itemsize)

    def dispatch(self, items: list[BatchItem]):
        """Validate and queue every bucket; returns a handle for collect()."""
        with tracing.entry("banded.dispatch"):
            outputs: list[BatchOutput | None] = [None] * len(items)
            valid: list[int] = []
            for i, it in enumerate(items):
                err = self._validate(it)
                if err is not None:
                    outputs[i] = BatchOutput(it, None, math.nan, err)
                else:
                    valid.append(i)
            t0 = time.perf_counter()
            with tracing.span("banded.pack"):
                groups = [[valid[g] for g in group]
                          for group in self._buckets([items[i] for i in valid])]
            if self.device_pipeline:
                pending = [self._dispatch_bucket([items[i] for i in gidx], gidx)
                           for gidx in groups]
            else:
                pending = [(gidx, next_device(self)) for gidx in groups]
            self.profile["dispatch_s"] += time.perf_counter() - t0
        return items, outputs, valid, pending

    def collect(self, handle) -> list[BatchOutput]:
        """Wait for the handle's buckets (the matrix route: run them) and
        build outputs."""
        items, outputs, valid, pending = handle
        with tracing.entry("banded.collect"):
            t1 = time.perf_counter()
            for bucket in pending:
                if self.device_pipeline:
                    self._collect_bucket(bucket, outputs)
                else:
                    gidx, dev = bucket
                    self._run_bucket([items[i] for i in gidx], gidx, outputs, dev)
            self.profile["buckets"] += len(pending)
            self.profile["reads"] += len(valid)
            self.profile["collect_s"] += time.perf_counter() - t1
        return outputs  # type: ignore[return-value]

    def run(self, items: list[BatchItem]) -> list[BatchOutput]:
        return self.collect(self.dispatch(items))

    def _dispatch_bucket(self, its: list[BatchItem], gidx: list[int]):
        T = np.array([len(it.signal) + 1 for it in its])
        t_pad = t_pad_ladder(int(T.max()), T_PAD_TO)
        with tracing.span("banded.bucket") as sp:
            with tracing.span("banded.kmers"):
                kmer_ids = [
                    seq_to_kmer_ids(it.read, self.model.kmer_size,
                                    self.model.alphabet_size)
                    for it in its
                ]
            dev = next_device(self)
            with on_device(dev):
                with tracing.span("banded.wire"):
                    wire = dv.prepare_wire(
                        [it.signal for it in its], kmer_ids, band=self.band,
                        device=dev, t_pad=t_pad,
                    )
                with tracing.span("banded.launch"):
                    res = self._dev_run[dev](wire)
                with tracing.span("banded.to_host"):
                    host = dv.DeviceSegResult(*(_to_host(x) for x in res))
                    done = None
                    if dev.type == "cuda":
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(dev))
            if tracing.on():
                sp.add(**fill_counts(T, t_pad), h2d_bytes=nbytes(wire),
                       d2h_bytes=nbytes(host),
                       band_bytes=band_bytes(len(T), t_pad, wire.B,
                                             self.dtype.itemsize))
        N = np.array([len(k) + 1 for k in kmer_ids])
        return its, gidx, T, N, host, done, dev

    def _collect_bucket(self, bucket, outputs):
        its, gidx, T, N, host, done, dev = bucket
        if done is not None:
            with tracing.span("banded.wait"):
                done.synchronize()
        with tracing.span("banded.gate"):
            Zf = host.Zf.numpy().astype(np.float64)
            Zb = host.Zb.numpy().astype(np.float64)
            starts = host.starts.numpy()
            medians = host.medians.numpy()
            # each read gated at its own band width, as if alone in its
            # bucket: which reads share a bucket does not move the gate
            B = np.array([dv.band_width(self.band, int(n)) for n in N])
            ok = bb.check_z_batch(Zf, Zb, T, B, self.dtype)
            for j, out_i in enumerate(gidx):
                if not ok[j]:
                    outputs[out_i] = self._z_fail(its[j], float(Zf[j]),
                                                  float(Zb[j]), dev)
                else:
                    outputs[out_i] = BatchOutput(
                        its[j], None, float(Zb[j]),
                        summaries=(starts[j], medians[j], int(N[j]),
                                   self.model.kmer_size),
                    )

    def _run_bucket(self, its: list[BatchItem], gidx: list[int], outputs,
                    dev: torch.device):
        """One bucket through the matrix route on `dev`: host-prepared raw
        signals, the posterior matrices on the device, the native host
        walk."""
        with tracing.span("banded.bucket") as sp:
            kmer_ids = [
                seq_to_kmer_ids(it.read, self.model.kmer_size,
                                self.model.alphabet_size)
                for it in its
            ]
            with on_device(dev):
                batch = bb.prepare_batch(
                    [it.signal for it in its], kmer_ids, self.model, self.band,
                    device=dev, dtype=self.dtype, t_pad_to=T_PAD_TO)
                res = self._run(batch)
            T, N, bw = (x.cpu().numpy() for x in (batch.T, batch.N, batch.bw))
            Zf = res.Zf.cpu().numpy().astype(np.float64)
            Zb = res.Zb.cpu().numpy().astype(np.float64)
            ok = bb.check_z_batch(Zf, Zb, T, batch.B, self.dtype)
            seg_lists = bb.traceback_batch(res, batch.bstart.cpu().numpy(), T,
                                           N, bw, self.model.kmer_size)
            if tracing.on():
                sp.add(**fill_counts(T, batch.bstart.shape[1]),
                       h2d_bytes=nbytes(batch),
                       d2h_bytes=nbytes((batch.T, batch.N, batch.bw,
                                         batch.bstart, res.Zf, res.Zb,
                                         res.choices, res.PM, res.PE)))
            for j, out_i in enumerate(gidx):
                if not ok[j]:
                    outputs[out_i] = self._z_fail(its[j], float(Zf[j]),
                                                  float(Zb[j]), dev)
                else:
                    outputs[out_i] = BatchOutput(its[j], seg_lists[j],
                                                 float(Zb[j]))

    def _validate(self, it: BatchItem) -> str | None:
        try:
            _validate(len(it.signal), len(it.read), self.model.kmer_size)
        except SystemExit as e:
            return f"input validation failed (reference exit {e.code})"
        return None

    def _z_fail(self, it: BatchItem, zf: float, zb: float,
                dev: torch.device) -> BatchOutput:
        """A read failing the fp32 gate is usually fp32 round-off: it
        re-runs on the exact per-read fp64 rung, on its bucket's device.
        fp64 gate failures are terminal — the reference's exit-3 contract
        (NT_banded_main.cpp:156-183)."""
        err = f"Z values between matrices do not match! Zf: {zf}, Zb: {zb}"
        if self.dtype == torch.float32 and self.fp64_fallback:
            self.profile["z_retries"] = self.profile.get("z_retries", 0) + 1
            with tracing.span("banded.fp64_rung"):
                try:
                    res = run_nt_banded(
                        it.signal, it.read, self.model, self.pore,
                        {"m1": self.m1, "e2": self.e2}, band=self.band,
                        device=dev, dtype=torch.float64, validate=False,
                    )
                    return BatchOutput(it, res.segments, res.Z)
                except ZConsistencyError as e:
                    return BatchOutput(it, None, zb, str(e))
        return BatchOutput(it, None, zb, err)

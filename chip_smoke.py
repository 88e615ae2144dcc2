#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU: python3 chip_smoke.py

Phases (each raises on failure; the run exits nonzero and prints no
result line):
  1. the card, its name and power limit, torch / CUDA / nvcc versions;
  2. a fresh nvcc build of the kernels from dynamont_tpu_torch/csrc/;
  3. each kernel against its plain-torch version on the card, on the CPU
     tests' three short reads in fp32 and fp64 and on one (2, 16384, 512)
     bucket in fp64 (fp32 at full width is phase 5's): K1 (banded_bwd,
     its rows' inputs staged in chunks of up to 256 rows, top down),
     K2 (banded_fwd_vit) and K3 (banded_walk) bit for bit (bM, bE, choice
     bits, LPM, LPE and Zf, band rows after the same -inf pattern on rows
     < T; walked paths, probabilities and segment starts: both compute the
     same float operations in the same order); the matrix route's K4
     (banded_vit) over K5's and K1's stored rows: ch, LPM and LPE bit for
     bit, and bb.banded_batch_run's PM, PE and choices bit for bit those of
     the plain K4's posteriors;
  4. the main path: 64 reads of 1800 bases (mean dwell 9, T trimmed to
     16000, rna002) through BandedBatchEngine on the card, batch 32, run
     RUNS times after a warm-up, with the launch counters reset right
     before and read right after; every
     read must yield CSV rows, every kernel must have launched and no
     plain version run; three short reads are held against the exact fp64
     rung (borders identical, probabilities within 2e-3);
  5. each kernel against its plain version at its path's bucket shape,
     fp32, as phases 3 and 6 hold them: (32, 16384, 512) for the
     segmentation kernels and K4, (24, 16384, 512) for the training
     kernels; K5 -> K1 -> K4 against K2 on the (32, 16384, 512) bucket
     (one Viterbi step in both: equal wherever K5's stored forward rows
     equal K2's; the largest difference is printed); then CUDA-event
     times of each kernel beside its plain version's run;
  6. the training kernels (banded_fwd, banded_bwd_train) against their
     plain versions on the short reads in fp32 and fp64 and on one
     (2, 16384, 512) bucket in fp64: every output bit for bit;
  7. the training path: 48 reads of the phase-4 shape through
     dynamont_tpu_torch.cli.train.main in-process (batch 24, 2 batches,
     fp32, cuda), launch counters reset right before and read right
     after: both training kernels launched, no plain version, no read on
     the per-read fp64 rung, 2 finite params.csv rows and 2 checkpoints; a
     second identical run writes byte-identical files; fp32 and fp64
     trainers on 4 short reads agree on m1/e2 within rel 1e-3; the
     training step's reads/s at (24, 16384, 512), split into host prep,
     banded_fwd, banded_bwd_train, emission statistics and transfer back;
  8. the NTC pre-pass kernels (ntc_tn_fwd, ntc_tn_bwd_sel, ntc_tk_bwd,
     ntc_tk_fwd_u) against their plain versions on the CPU tests' three
     short reads in fp32 and fp64, and on one (2, 16384) bucket at N2 2048
     and K 1024 in fp64 (fp32 at full width is phase 9's): every output bit
     for bit (both stores, the TN pack, E0, U, finalE), then identical
     candidates, counts and overflow flags (ntc_tn_bwd_sel is two kernels,
     the chain into a u store, then the selection, one warp a row);
  9. the batched pre-pass at the resquiggle engine's bucket shape: 16
     reads of the phase-4 shape, (16, 16384), N2 2048, K 1024, CN 8,
     CK0 120, fp32, through pre_tn_batch and pre_tk_batch with the launch
     counters reset right before and read right after (all four kernels,
     both of ntc_tn_bwd_sel's, no plain version); the preProcTN/TK Z gates
     per read (at most one may fail); overflowing reads and the share of
     columns at the cap; each kernel against its plain version there, every
     output bit for bit, and its CUDA-event time beside the plain version's
     (and ntc_tn_bwd_sel's two kernels alone); peak memory;
 10. the exact per-read NTC through dynamont_tpu_torch.cli.ntc_main.main in
     process: three short reads in segment, calcZ and train mode on cuda
     against cpu (borders and polish k-mers identical, probabilities and
     trained values within 1e-9 — a k-mer reported on one side only must
     have a stdev within that bound —, Z within rel 1e-12), no pre-pass
     kernel launched; then the first phase-4 read in segment mode with
     its wall time and CAP_LADDER rung, and the batched fp64 kernels at
     R = 1 and that rung's caps, whose candidate sets must equal the
     per-read pre-pass's. The long read's signal is Hampel-filtered as the
     TSV reader delivers it, so that phase 12 can hold the engine to it;
 11. the NTC lattice kernels (ntc_tab_gather, ntc_bwd, ntc_pv, ntc_walk)
     and the training kernels (ntc_fwd_store, ntc_train: phase 13(a))
     against their plain versions on the CPU tests' three short reads, in
     fp32 and fp64, at the engine's caps (8, 120) and at its wide rung's
     (16, 240): the bucket runs through the engine's own resquiggle and
     training bucket programs, which keep each kernel's inputs and
     outputs, and each plain version runs on the same inputs, shared as in
     phase 12; every output bit for bit (gathered tables, stores, lp
     written over the store, choices, slots, both finals, walk records,
     segment summaries, tacc, em, b0). At (16, 240) the engine's own route
     is the checkpointed one: ntc_bwd_ckpt and ntc_pv's checkpoint mode
     (ntc_pv_ckpt), each launched once in the instance its picker takes
     there (a thread block cluster a read in both dtypes), against their
     plain versions there, and its outputs against the full store's
     (checkpoints = the store's rows (c+1)*8, row 0, Zb, lp, choices,
     slots, finals, walk), bit for bit; K17 and K18 each launched once in
     the instance its picker takes (fwd_store_instance, train_instance);
 12. the resquiggle engine through dynamont_tpu_torch.cli.resquiggle.main
     in process on the 16 phase-9 reads from a TSV (--mode resquiggle,
     --device cuda, --profile), every launch counter reset right before
     and read right after: K7-K11, K13, K15, K16 all launched, every K15
     launch in its shared-column instance (pv_shared_kernel) and every K13
     launch in its (bwd_shared_kernel), no plain version; at most 2 reads
     on the exact rung; the natural run's wide retries and their time
     (any K14 or K15 checkpoint-mode launch there in its cluster
     instance); the engine's profile, reads/s and peak memory;
     read 0 against phase 10's exact fp64 run
     (at most max(1, segments/50) borders differ, Z within rel 1e-3); no
     training kernel launched. Then the engine's (16, 16384) bucket again,
     fp32, N2 2048, through the resquiggle and the training bucket
     programs with their kernels' inputs kept (phase 13's full-width part):
     K11, K13, K15, K16, K17 and K18 against their plain versions there,
     bit for bit as in phase 11, K17's row T_r-1 E bit for bit K15's fwdEf
     and K18's b0 K13's row 0, K17 and K18 each launched once in its
     shared-column instance (fwd_store_shared_kernel, train_shared_kernel);
     plain K13 and K18 are one run of ntc_train_batch, which keeps the
     backward store, and plain K15 and
     K17 one run of ntc_posterior_viterbi_batch, which keeps the forward
     store, so each pair reports that run's time; each kernel's CUDA-event
     time beside it (and, for ntc_tab_gather, the indexing call's). Then
     the wide rung at full width: 8 of the reads at caps (2, 2), which all
     overflow and re-run in one bucket at (16, 240) on the checkpointed
     route; the pre-pass kernels, K11 and K16 launched twice, K13 and K15
     once (the tiny main bucket), K14 and K15's checkpoint mode once, each
     in its cluster instance (bwd_ckpt_cluster_kernel, G 8;
     pv_ckpt_cluster_kernel, G 8), no plain version, no exact retry, each
     read within the bounds above of
     its main-rung result; wall time and peak memory. That wide bucket
     through both routes: each route's wall time and peak memory, the
     outputs bit for bit equal (the full store's K15 and K13 in their
     device-memory instances, pv_kernel and bwd_kernel), K14's checkpoints
     and row 0 bit for bit its plain version's (run in the parent beside
     the spawned processes),
     K15's checkpoint mode's lp, choices, slots and both finals bit for bit
     its plain version's (run in a spawned process), and the kernels' times
     beside their plain versions';
 13. NTC training: (a) the short reads, in phase 11; (b) the full-width
     bucket, in phase 12; (c) the training path: the 48 phase-7 reads
     through dynamont_tpu_torch.cli.train.main --mode resquiggle in process
     (batch 24, 2 batches, fp32, cuda), every launch counter reset right
     before and read right after: K7-K11, K17, K18 launched (K17 and K18
     every time in their shared-column instances), K13, K15, K16 not, no
     plain version, at most one read on the exact rung, 2 finite
     params.csv rows and 2 checkpoints; a second run writes byte-identical
     files; fp32 and fp64 trainers on the three short reads agree on the
     13 transitions within rel 1e-3; the training step's reads/s on a
     (24, 16384) batch, split into pre-pass, plan + K11, K17, K18 and host
     post-processing, with its peak memory;
 14. native 9-mer NTC on a seeded synthetic table of the real shape (K =
     4^9, means U(-2, 2), stdevs U(0.15, 0.4)): (a) the checkpoint-recompute
     TK pre-pass (torch ops) against K9 -> K10 on phase 9's 5-mer bucket,
     cand, cnt, overflow, Zf and Zb bit for bit; (b) K11, K13, K15, K16 at
     (8, 120) and K11, K13, K14, K15 and its checkpoint mode, K16 at
     (16, 256) against their plain versions at K = 4^9 on two short reads,
     fp32 (the native path's dtype; K14 in its cluster instance, K15's
     checkpoint mode in pv_kernel<S, true>, where CK 272 breaks the fp32
     normalization's order across a cluster), and the two routes against
     each other; (c) 16 reads of
     1800 bases drawn from the table (dwell and trim as phase 4's) through
     dynamont_tpu_torch.cli.resquiggle.main --ntc-native-9mer with the table
     as --model_path, every counter reset right before and read right
     after: K7, K8, K11, K13, K15, K16 launched, K9 and K10 not, no plain
     version, no out-of-memory, every read segmented or on an error line;
     reads/s, retries, peak memory, and the bucket programs' stages on CUDA
     events recorded around each stage of that run;
 15. (a) the matrix route: the 64 phase-4 reads, snapped to the int16 wire
     grid, through BandedBatchEngine(device_pipeline=False) (batch 32,
     fp32) after a one-bucket warm-up, every counter reset right before
     and read right after: K5, K1, K4 launched, K2, K3 and every plain
     version not; every read segmented; reads/s and peak memory; then the
     same reads through the device route: borders identical on every read,
     probabilities within 2e-3 (the largest difference printed);
     (b) the stacked table gather #12 (ntc_table_gather) on phase 12's
     bucket, on the index rows K11 reads (ops/ntc_batch.gather_index): bit
     for bit its plain version, and its rows bit for bit K11's mu/c1/c2,
     successor and n-slot parameters; its time beside tabT[:, ks]'s;
     (c) dynamont-NT and dynamont-NT-banded in process, --device cuda
     against --device cpu, on the three short reads in segment, -z,
     --train and -p mode: dynamont-NT-banded's stdout identical,
     dynamont-NT's borders identical and its numbers within 1e-9 (as
     phase 10); then the first phase-4 read at full width through both
     with -p: dynamont-NT-banded's segments equal the exact fp64 rung's
     (run_nt_banded), -p prints T values, -inf where a row holds no live M
     cell (rows 0 and T-1 among them, as in the JAX CLIs), no NaN or +inf;
     each CLI's wall time;
 16. the probes of K13 (dynamont_tpu_torch/probes/, the counterparts of the
     TPU probes scripts/probe_ntc_bwd_synth.py, probe_ntc_bwd_variants.py and
     probe_ntc_microops.py): first every ntc_bwd_variant variant against its
     plain version on a short synthetic bucket (R 2, T_pad 256), the
     forward-order ones included, and every ntc_microop block at ITERS 64
     on the standard normal tiles and on the tiles its gathers need, bit
     for bit; then, with the probe kernels' counters reset right before
     and read right after, (a) the variants through the synthetic probe's
     run at (16, 16384), caps (8, 120), fp32, each reverse-order variant
     (every C that fits, every thread count, both stores at row 0) bit for
     bit ntc_bwd's store on the same inputs, and K15 timed on the prod
     variant's store; (b) the same variants on the engine's bucket of the
     16 phase-9 reads, against the engine's own K13 store; in (a) and (b)
     every variant that stores all rows, forward order and K13's own path
     included, also has seven of its chunks (the first two visited, three
     in the middle, the last two) recomputed by the plain column from the
     row it stored before them, bit for bit (same_steps: no plain run over
     all 16384 rows, no kernel launch); (c) every microop block at ITERS
     16384; a C whose staged rows do not fit the card's shared memory is
     printed with its bytes, not run; no plain version stands in for a
     kernel in the counted window;
 17. several devices and processes on the one card, every kernel counter
     reset right before each path and read right after: (a) 8 phase-4
     reads through BandedBatchEngine(devices=[cuda:0, cuda:0], batch 4)
     and 4 through NTCBatchEngine(devices=[cuda:0, cuda:0], batch 2,
     no fallback), each bucket on the next entry, outputs identical to
     the same engines on [cuda:0], K1-K3 and K7-K11, K13, K15, K16
     launched once a bucket; (b) one 4-read bucket's decode with the
     device Hampel (hampel_on_device) on the card bit for bit the same
     decode on CPU tensors, and the engine with the flag on that bucket;
     (c) 16 phase-4 reads through the resquiggle CLI --mode basic in
     process, then through two processes sharing the card with
     --distributed over gloo on 127.0.0.1 (python -m
     dynamont_tpu_torch.cli.resquiggle through runpy, behind the zstandard
     stand-in): reads split by index into .rank0/.rank1, the union the
     one-process rows (byte for byte where a read's bucket shape is the
     same in both runs, else borders identical and probabilities within
     2e-3), each rank's K1-K3 launched; (d) dynamont-train --mode basic,
     fp32, one 24-read batch of phase-7 reads, in process and in two
     processes with --distributed: params.csv and the checkpoints against
     the one-process run (identical, or within rel 1e-5, Zchange within
     0.1 nats, with the differences printed), each rank's K5 -> K6
     launched; (e) make_ntc_sharded_train_step([cuda:0, cuda:0]) on 32
     phase-13 reads, two shares of 16: Zf, Zb, the 13 term sums and the
     k-mer moments of every read bit for bit the one-device training
     bucket program's on the same padded 32-read bucket, the gate the
     same, the pooled sums within rel 1e-5 of the one-device sums,
     K7-K11, K17, K18 launched once a share. The card has one GPU: no run
     here has two distinct GPUs.
Each phase prints its wall time. The line before the last is
{"kernels": [...]} with each kernel's bound (bytes each input read once and
each output written once over 3.35 TB/s, or operations over 67 TFLOP/s
fp32, whichever is larger); the last is {"ok": true, "device": {...}}.
ntc_pv's entry carries its checkpoint mode's time as `ckpt`; banded_bwd's,
banded_fwd_vit's, banded_vit's, banded_fwd's, banded_bwd_train's, ntc_tn_fwd's,
ntc_tk_bwd's, ntc_tk_fwd_u's, ntc_bwd's, ntc_bwd_ckpt's, ntc_walk's and
ntc_pv's (and its `ckpt`'s) say which design ran (`design`: the staged
chunks, the threads and their columns, the instance); the pre-pass
kernels' (K7-K10) launches are those of phase 12's counted run and phase
13(c)'s (both run them), banded_fwd's phase 7's first training run's and
phase 15(a)'s matrix route's (both run it; `launches_by_path`),
banded_vit's phase 15(a)'s, ntc_table_gather's the one run of its own
entry in phase 15(b) (it lies on no path), ntc_bwd_variant's and
ntc_microop's those of phase 16's probe runs (no path runs them):
ntc_bwd_variant's ms is the staged C=8 reverse variant's on the engine's
bucket, its plain_ms the plain version's at (2, 256) (`plain_at`), beside
the kernel's there (`short_ms`), with every variant's ms in `variants_ms`;
ntc_microop's ms and plain_ms sum the blocks' launches at ITERS 16384 and
the plain versions' runs at ITERS 64 (`plain_iters`), with each block's us
per iteration in `us_per_iter`. Needs no JAX and no network.
`--phases 1,2,11` runs a subset (the kernels line then lists only what was
measured).
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

N_READS, N_BASES, MEAN_DWELL, T_TRIM, BATCH = 64, 1800, 9.0, 16000, 32
TRAIN_READS, TRAIN_BATCH = 48, 24
SOURCE = {
    "banded_bwd": "dynamont_tpu_torch/csrc/nt_banded.cu",
    "banded_fwd_vit": "dynamont_tpu_torch/csrc/nt_banded.cu",
    "banded_walk": "dynamont_tpu_torch/csrc/nt_banded.cu",
    "banded_vit": "dynamont_tpu_torch/csrc/nt_banded.cu",
    "banded_fwd": "dynamont_tpu_torch/csrc/nt_banded_train.cu",
    "banded_bwd_train": "dynamont_tpu_torch/csrc/nt_banded_train.cu",
    "ntc_tn_fwd": "dynamont_tpu_torch/csrc/ntc_pre.cu",
    "ntc_tn_bwd_sel": "dynamont_tpu_torch/csrc/ntc_pre.cu",
    "ntc_tk_bwd": "dynamont_tpu_torch/csrc/ntc_pre.cu",
    "ntc_tk_fwd_u": "dynamont_tpu_torch/csrc/ntc_pre.cu",
    "ntc_tab_gather": "dynamont_tpu_torch/csrc/ntc_lattice.cu",
    "ntc_table_gather": "dynamont_tpu_torch/csrc/ntc_lattice.cu",
    "ntc_bwd": "dynamont_tpu_torch/csrc/ntc_lattice.cu",
    "ntc_bwd_ckpt": "dynamont_tpu_torch/csrc/ntc_lattice.cu",
    "ntc_pv": "dynamont_tpu_torch/csrc/ntc_lattice.cu",
    "ntc_walk": "dynamont_tpu_torch/csrc/ntc_lattice.cu",
    "ntc_fwd_store": "dynamont_tpu_torch/csrc/ntc_train.cu",
    "ntc_train": "dynamont_tpu_torch/csrc/ntc_train.cu",
    "ntc_bwd_variant": "dynamont_tpu_torch/csrc/ntc_lattice.cu",
    "ntc_microop": "dynamont_tpu_torch/csrc/ntc_probe.cu",
}
REPLACES = {
    "banded_bwd": "dynamont_tpu/ops/nt_banded_pallas.py:273",
    "banded_fwd_vit": "dynamont_tpu/ops/nt_banded_pallas.py:584",
    "banded_walk": "dynamont_tpu/ops/nt_banded_pallas.py:747",
    "banded_vit": "dynamont_tpu/ops/nt_banded_pallas.py:426",
    "banded_fwd": "dynamont_tpu/ops/nt_banded_pallas.py:113",
    "banded_bwd_train": "dynamont_tpu/ops/nt_banded_train.py:90",
    "ntc_tn_fwd": "dynamont_tpu/ops/ntc_pre_pallas.py:78",
    "ntc_tn_bwd_sel": "dynamont_tpu/ops/ntc_pre_pallas.py:113",
    "ntc_tk_bwd": "dynamont_tpu/ops/ntc_pre_pallas.py:336",
    "ntc_tk_fwd_u": "dynamont_tpu/ops/ntc_pre_pallas.py:381",
    "ntc_tab_gather": "dynamont_tpu/ops/ntc_pallas.py:244",
    "ntc_table_gather": "dynamont_tpu/ops/ntc_pallas.py:177",
    "ntc_bwd": "dynamont_tpu/ops/ntc_pallas.py:839",
    "ntc_bwd_ckpt": "dynamont_tpu/ops/ntc_pallas.py:864",
    "ntc_pv": "dynamont_tpu/ops/ntc_pallas.py:984",
    "ntc_walk": "dynamont_tpu/ops/ntc_pallas.py:1298",
    "ntc_fwd_store": "dynamont_tpu/ops/ntc_pallas.py:1564",
    "ntc_train": "dynamont_tpu/ops/ntc_pallas.py:1681",
    "ntc_bwd_variant": "scripts/probe_ntc_bwd_synth.py:90, scripts/probe_ntc_bwd_variants.py:70",
    "ntc_microop": "scripts/probe_ntc_microops.py:46",
}
# floors of the operations per unit of work, counted as the kernels are
# written: each add, multiply, compare, max and each exp, log, log1p is one
# operation. Unit: a live band cell (banded kernels), a live (row, column)
# of both states (TN/TK pre-pass), a live lattice cell (ntc_bwd, ntc_pv,
# ntc_fwd_store, ntc_train: K15's forward half; K13 plus 13 term
# logaddexps and the moments; ntc_bwd_ckpt: K13's; ntc_pv_ckpt: K15's plus
# K13's re-derivation), a walk step (banded_walk, ntc_walk); banded_vit:
# the two posteriors (add, subtract each) and the Viterbi step (two adds,
# a max, the choice's add and compare); ntc_tab_gather and
# ntc_table_gather only move bytes; ntc_bwd_variant: K13's per live cell;
# ntc_microop: the decay multiply every block does, per cell and iteration
OPS_PER_UNIT = {
    "banded_bwd": 16, "banded_fwd_vit": 24, "banded_walk": 10, "banded_vit": 9,
    "banded_fwd": 16, "banded_bwd_train": 30,
    "ntc_tn_fwd": 16, "ntc_tn_bwd_sel": 30, "ntc_tk_bwd": 25,
    "ntc_tk_fwd_u": 31, "ntc_tab_gather": 0, "ntc_table_gather": 0,
    "ntc_bwd": 130, "ntc_pv": 150,
    "ntc_walk": 40, "ntc_fwd_store": 100, "ntc_train": 190,
    "ntc_bwd_ckpt": 130, "ntc_pv_ckpt": 280, "ntc_bwd_variant": 130, "ntc_microop": 1,
}
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM peak HBM3 bandwidth
FP32_OPS_PER_S = 67e12     # H100 SXM peak fp32 rate outside the tensor cores
NTC_READS, CN, CK0 = 16, 8, 120  # the resquiggle engine's kernel geometry
WIDE_CN, WIDE_CK0 = 16, 240  # its wide rung
K9 = 4 ** 9  # native 9-mer NTC (phase 14), on a seeded synthetic table
MAIN_RUNG = ("ntc_tab_gather", "ntc_bwd", "ntc_pv", "ntc_walk")  # K11, K13, K15, K16
CKPT_ROUTE = ("ntc_tab_gather", "ntc_bwd_ckpt", "ntc_pv_ckpt", "ntc_walk")
PV_OUTS = ("lp", "choices", "slots", "apEf", "fwdEf")  # K15's outputs, in order
FP32_EPSILON = 1e-6  # per-cell Z tolerance of the fp32 engine gates
RUNS = 5
STEPS = 5  # timed training steps after a warm-up
PROBE_T_PAD, MICRO_ITERS = 16384, 16384  # phase 16's synthetic bucket, microop iterations


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def plain_run(name: str, fn, plain_ms: dict | None):
    """fn(), its CUDA-event time put into plain_ms[name] when given."""
    if plain_ms is None:
        return fn()
    out, plain_ms[name] = timed_once(fn)
    return out


def band_same(name: str, got, want, T) -> None:
    """Raise unless got equals want bit for bit on every read's rows < T:
    the same -inf pattern first, then every cell."""
    import torch

    for i, t in enumerate(T.tolist()):
        x, y = got[i, :t], want[i, :t]
        if not torch.equal(torch.isneginf(x), torch.isneginf(y)):
            raise AssertionError(f"{name} read {i}: -inf patterns differ")
        same(f"{name} read {i}", x, y)


def compare_kernels(batch, N_max, lm, le, plain_ms: dict | None = None):
    """Run each kernel and its plain version on one batch; returns the max
    abs error per kernel (0.0: K1, K2 and K3 bit for bit) and raises on
    disagreement. plain_ms, if given, receives each plain version's
    CUDA-event time."""
    import torch

    from dynamont_tpu_torch.ops import nt_banded_batch as bb
    from dynamont_tpu_torch.ops import nt_banded_kernels as kk

    T = batch.T.cpu()
    errs = {}
    bM, bE = kk.backward(batch, lm, le)
    pM, pE = plain_run("banded_bwd", lambda: kk.backward_plain(batch, lm, le), plain_ms)
    band_same("banded_bwd bM", bM, pM, T)
    band_same("banded_bwd bE", bE, pE, T)
    errs["banded_bwd"] = 0.0
    del bM, bE
    r = torch.arange(T.numel(), device=pE.device)
    Zb = pE[r, 0, batch.bw.long() + 1]
    ch, LPM, LPE, Zf = kk.fwd_vit(batch, pM, pE, Zb, lm, le)
    pch, pLPM, pLPE, pZf = plain_run(
        "banded_fwd_vit", lambda: kk.fwd_vit_plain(batch, pM, pE, Zb, lm, le), plain_ms)
    del pM, pE
    if not torch.equal(ch, pch):
        raise AssertionError(f"fwd_vit: {(ch != pch).sum().item()} choice bits differ")
    band_same("fwd_vit LPM", LPM, pLPM, T)
    band_same("fwd_vit LPE", LPE, pLPE, T)
    same("fwd_vit Zf", Zf, pZf)
    errs["banded_fwd_vit"] = 0.0  # bit for bit, or the checks raised
    del ch, LPM, LPE
    walked = kk.walk(pLPM, pLPE, pch, batch, N_max)
    plain = plain_run("banded_walk", lambda: kk.walk_plain(pLPM, pLPE, pch, batch, N_max),
                      plain_ms)
    if not (torch.equal(walked[0], plain[0]) and torch.equal(walked[2], plain[2])):
        raise AssertionError("walk: paths differ")
    same("walk prob", walked[1], plain[1])
    errs["banded_walk"] = 0.0
    s_k, _ = bb.path_summaries(*walked, N_max)
    s_p, _ = bb.path_summaries(*plain, N_max)
    if not torch.equal(s_k, s_p):
        raise AssertionError("walk: segment starts differ")
    torch.cuda.synchronize()
    return errs


def compare_vit(batch, lm, le, plain_ms: dict | None = None, rows=None,
                check_run: bool = True):
    """K4 (banded_vit) over K5's and K1's stored rows (or `rows` = (fM, fE,
    bM, bE, Zb)) against its plain version: ch, LPM, LPE bit for bit; with
    check_run, bb.banded_batch_run's PM, PE and choices bit for bit the
    plain K4's posteriors'. Raises otherwise; returns K4's outputs."""
    import torch

    from dynamont_tpu_torch.ops import nt_banded_batch as bb
    from dynamont_tpu_torch.ops import nt_banded_kernels as kk

    if rows is None:
        fM, fE = kk.forward(batch, lm, le)
        bM, bE = kk.backward(batch, lm, le)
        r = torch.arange(fM.shape[0], device=fM.device)
        rows = (fM, fE, bM, bE, bE[r, 0, batch.bw.long() + 1])
    got = kk.viterbi_post(batch, *rows)
    want = plain_run("banded_vit", lambda: kk.viterbi_post_plain(batch, *rows), plain_ms)
    for f, g, w in zip(("ch", "LPM", "LPE"), got, want):
        same(f"banded_vit {f}", g, w)
    if check_run:
        res = bb.banded_batch_run(batch, lm, le)
        same("banded_batch_run PM", res.PM, bb._prob(want[1]))
        same("banded_batch_run PE", res.PE, bb._prob(want[2]))
        same("banded_batch_run choices", res.choices, want[0].bool())
    return got


def max_diff(a, b) -> float:
    """Largest |a - b| over the cells where a and b differ (inf where one
    is infinite or NaN there); 0.0 when they are equal cell for cell."""
    ne = a != b
    if not bool(ne.any()):
        return 0.0
    return (a[ne] - b[ne]).abs().nan_to_num(nan=math.inf).max().item()


def timed_once(fn):
    """(fn(), its CUDA-event time in ms)."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn()
    ev[1].record()
    ev[1].synchronize()
    return out, ev[0].elapsed_time(ev[1])


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tensors_of(x) -> list:
    """The tensors of a kernel wrapper's result (a tensor or a tuple of them)."""
    import torch

    return [x] if isinstance(x, torch.Tensor) else [t for t in x if isinstance(t, torch.Tensor)]


def timed(name: str, kern, plain, inputs, units: int, reps: int, extra_bytes: int = 0,
          library=None) -> dict:
    """One kernel's entry of the kernels line: its CUDA-event time (mean of
    `reps` launches after one), its plain version's (one run; or the time
    already measured, when `plain` is a number), its bound from the bytes
    of `inputs` and of what it returns (plus extra_bytes) and `units` of
    work, and the library call's time where there is one."""
    moved = nbytes(*inputs, *tensors_of(kern())) + extra_bytes
    ms = cuda_ms(kern, reps)
    plain_ms = plain if isinstance(plain, float) else cuda_ms(plain, 1)
    bound_ms, bound_by = bound(name, moved, units)
    lib_ms = cuda_ms(library, reps) if library is not None else None
    log(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {moved / 1e6:.1f} MB, {units} units)"
        + (f", library call {lib_ms:.3f} ms" if lib_ms is not None else ""))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


def bound(name: str, moved: int, units: int) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of `moved` bytes over the memory
    rate and units * OPS_PER_UNIT[name] operations over the fp32 rate."""
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = units * OPS_PER_UNIT[name] / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


class Phases:
    """Prints each phase's wall time as the next one starts."""

    def __init__(self):
        self.name, self.t0 = None, time.perf_counter()

    def start(self, name: str) -> None:
        self.end()
        self.name, self.t0 = name, time.perf_counter()

    def end(self) -> None:
        if self.name is not None:
            log(f"[{self.name}] phase wall {time.perf_counter() - self.t0:.1f} s")
        self.name = None


def compare_train_kernels(batch, lm, le, plain_ms: dict | None = None):
    """banded_fwd and banded_bwd_train against their plain versions on one
    batch: every output bit for bit. Returns the max abs error per kernel
    (0.0) and raises on any difference. plain_ms, if given, receives each
    plain version's CUDA-event time."""
    import torch

    from dynamont_tpu_torch.ops import nt_banded_kernels as kk

    fM, fE = kk.forward(batch, lm, le)
    pfM, pfE = plain_run("banded_fwd", lambda: kk.forward_plain(batch, lm, le), plain_ms)
    torch.cuda.synchronize()
    if not (torch.equal(fM, pfM) and torch.equal(fE, pfE)):
        raise AssertionError("banded_fwd differs from its plain version")
    del fM, fE, pfM
    got = kk.backward_train(batch, pfE, lm, le)
    want = plain_run("banded_bwd_train",
                     lambda: kk.backward_train_plain(batch, pfE, lm, le), plain_ms)
    torch.cuda.synchronize()
    for name, g, w in zip(("bM", "bE", "rawM1", "rawE2"), got, want):
        if not torch.equal(g, w):
            fin = torch.isfinite(w)
            raise AssertionError(
                f"banded_bwd_train {name} differs from its plain version: "
                f"max abs {(g[fin] - w[fin]).abs().max().item()}")
    return {"banded_fwd": 0.0, "banded_bwd_train": 0.0}


def write_tsv(path: str, reads) -> None:
    """(signal, read in processing orientation) pairs as the TSV the CLIs
    read: RNA 5'->3', without the polyA stub the reader adds back."""
    with open(path, "w") as f:
        for i, (sig, read) in enumerate(reads):
            f.write(f"r{i}\tr{i}\t{','.join(repr(float(x)) for x in sig)}"
                    f"\t{read[9:][::-1]}\n")


def files_of(outdir: str) -> dict:
    out = {}
    for name in sorted(os.listdir(outdir)):
        with open(os.path.join(outdir, name), "rb") as f:
            out[name] = f.read()
    return out


def pre_bucket(model, reads, t_pad: int, n2: int):
    """(sig, kid, N_r, T_r) on the card for (signal, read) pairs, zero-padded
    to (R, t_pad - 1) and (R, n2 - 1) as the batched NTC engine pads."""
    import numpy as np
    import torch

    from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids

    R = len(reads)
    sig = np.zeros((R, t_pad - 1))
    kid = np.zeros((R, n2 - 1), np.int32)
    T, N = np.zeros(R, np.int32), np.zeros(R, np.int32)
    for i, (s, r) in enumerate(reads):
        k = seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size)
        sig[i, : len(s)] = s
        kid[i, : len(k)] = k
        T[i], N[i] = len(s) + 1, len(k) + 1
    return tuple(torch.from_numpy(a).cuda() for a in (sig, kid, N, T))


def model_tensors(model):
    """means, stdevs, c1, c2 of the pore model as float64 tensors on the card."""
    import torch

    means, c1, c2 = model.score_params()
    return tuple(torch.from_numpy(a).cuda() for a in (means, model.stdevs, c1, c2))


def same(name: str, got, want) -> None:
    """Raise unless got equals want bit for bit (infinities included)."""
    import torch

    try:
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    except AssertionError as e:
        raise AssertionError(f"{name} differs from its plain version: {e}") from None


def compare_pre_kernels(model, bucket, dtype, lm, le, cap_n=CN, cap_k=CK0):
    """K7-K10 and their plain versions on one bucket: every output bit for
    bit, then the selections made from them identical. Raises otherwise."""
    import torch

    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

    sig, kid, N_r, T_r = bucket
    sig = sig.to(dtype)
    means, stdevs, c1, c2 = model_tensors(model)
    tab = nb.tn_tables(kid, means, stdevs, dtype)
    tabk = nb.tk_tables(means, c1, c2, dtype)
    N2 = kid.shape[1] + 1
    fwd = kn.tn_fwd_plain(sig, tab, N_r, lm, le)
    same("ntc_tn_fwd", kn.tn_fwd(sig, tab, N_r, lm, le), fwd)
    got = kn.tn_bwd_sel(sig, tab, kid, N_r, T_r, fwd, cap_n, lm, le)
    want = kn.tn_bwd_sel_plain(sig, tab, kid, N_r, T_r, fwd, cap_n, lm, le)
    del fwd
    for part, g, w in zip(("pack", "E0"), got, want):
        same(f"ntc_tn_bwd_sel {part}", g, w)
    sel_g = nb.tn_select(got[0], T_r, cap_n, N2)
    sel_w = nb.tn_select(want[0], T_r, cap_n, N2)
    for key in sel_w:
        same(f"TN selection {key}", sel_g[key], sel_w[key])
    bwd = kn.tk_bwd_plain(sig, tabk, T_r, 4, lm, le)
    same("ntc_tk_bwd", kn.tk_bwd(sig, tabk, T_r, 4, lm, le), bwd)
    got = kn.tk_fwd_u(sig, tabk, T_r, bwd, 4, lm, le)
    want = kn.tk_fwd_u_plain(sig, tabk, T_r, bwd, 4, lm, le)
    del bwd
    for part, g, w in zip(("U", "finalE"), got, want):
        same(f"ntc_tk_fwd_u {part}", g, w)
    sel_g, sel_w = nb.tk_select(got[0], T_r, cap_k), nb.tk_select(want[0], T_r, cap_k)
    for key in sel_w:
        same(f"TK selection {key}", sel_g[key], sel_w[key])
    torch.cuda.synchronize()
    return dict.fromkeys(kn.KERNELS, 0.0)


def run_cli(sig, read, device: str, flags=(), cli: str = "ntc_main"):
    """dynamont_tpu_torch.cli.<cli>.main in process on one read (the
    per-read NTC by default; nt_main, nt_banded_main): (its result,
    stdout)."""
    import importlib

    from dynamont_tpu_torch.models.registry import get_model_path
    from dynamont_tpu_torch.utils.synthetic import signal_to_text

    main = importlib.import_module(f"dynamont_tpu_torch.cli.{cli}").main
    stdin, out = sys.stdin, io.StringIO()
    sys.stdin = io.StringIO(f"{signal_to_text(sig)}\n{read}\n")
    try:
        with contextlib.redirect_stdout(out):
            res = main(["-m", get_model_path("rna002"), "-r", "rna002",
                        "--device", device, *flags])
    finally:
        sys.stdin = stdin
    return res, out.getvalue()


def ntc_agree(got, want, mode: str) -> float:
    """cuda against cpu results of the per-read NTC: borders and polish
    k-mers identical, probabilities and trained values within 1e-9, Z
    within rel 1e-12. Returns the largest difference seen."""
    if abs(got.Z - want.Z) > 1e-12 * abs(want.Z):
        raise AssertionError(f"{mode}: Z {got.Z} vs {want.Z}")
    err = abs(got.Z - want.Z)
    if mode == "segment":
        if [s[:3] + s[4:] for s in got.segments] != [s[:3] + s[4:] for s in want.segments]:
            raise AssertionError("segment: borders or polish k-mers differ")
        err = max([err] + [abs(g[3] - w[3]) for g, w in zip(got.segments, want.segments)])
    elif mode == "train":
        pairs = [(got.trained_transitions[k], v) for k, v in want.trained_transitions.items()]
        ge, we = got.trained_emissions, want.trained_emissions
        for kmer in set(ge) | set(we):
            if kmer in ge and kmer in we:
                pairs += list(zip(ge[kmer], we[kmer]))
            elif (ge.get(kmer) or we.get(kmer))[1] > 1e-9:
                raise AssertionError(f"train: k-mer {kmer} reported on one side only")
            # else: a k-mer trained on one cell has a stdev of 0 or ~1e-16
            # depending on the last bit of its weight, and the reference
            # reports only stdev != 0: equal within the bound
        err = max([err] + [abs(g - w) for g, w in pairs])
        if any(abs(g - w) > 1e-9 * max(1.0, abs(w)) for g, w in pairs):
            raise AssertionError("train: trained values differ beyond 1e-9")
    if err > 1e-9 * max(1.0, abs(want.Z)):
        raise AssertionError(f"{mode}: off by {err}")
    return err


def same_candidates(per_read, batched, sentinel_batched: int, sort_batched: bool):
    """Columns whose candidate sets differ between the per-read pre-pass
    (cand (T, cap) ascending, count (T,)) and the batched one at R = 1
    (cand (T, 1, cap), cnt (T, 1))."""
    import torch

    cnt_p = per_read.count.long()
    cnt_b = batched.cnt[:, 0].long()
    cap = per_read.cand.shape[1]
    slot = torch.arange(cap, device=cnt_p.device)[None, :]
    cand_p = torch.where(slot < cnt_p[:, None], per_read.cand.long(), sentinel_batched)
    cand_b = batched.cand[:, 0].long()
    if sort_batched:
        cand_b = torch.sort(torch.where(slot < cnt_b[:, None], cand_b,
                                        sentinel_batched), dim=1).values
    bad = (cnt_p != cnt_b) | (cand_p != cand_b).any(dim=1)
    return int(bad.sum())


def phases_ntc(phase, model, bench, lm, le, max_err: dict, launches: dict, want):
    """Phases 8-10 (the NTC pre-pass kernels and the per-read NTC). Fills
    max_err and launches for the four pre-pass kernels; returns their
    timing entries at the engine's bucket shape and phase 10's exact run of
    the long read, (signal, read, NTCResult), or None."""
    import torch

    from dynamont_tpu_torch.models.packing import round_up, t_pad_ladder
    from dynamont_tpu_torch.utils.synthetic import make_read

    n_of = lambda read: len(read) - model.kmer_size + 2  # N = k-mers + 1
    short = [make_read(model, n_bases=n, seed=s) for s, n in ((0, 25), (1, 31), (2, 18))]
    t_short = round_up(max(len(s) for s, _ in short) + 1, 64)   # the CPU tests'
    n_short = round_up(max(n_of(r) for _, r in short), 16)      # engine padding
    t_full = t_pad_ladder(len(bench[0][0]) + 1, 2048)
    n_full = round_up(n_of(bench[0][1]), 256)
    if (t_full, n_full) != (16384, 2048):
        raise AssertionError(f"NTC bucket shape {(t_full, n_full)}")
    times, long_ref = {}, None
    # 8. the pre-pass kernels against their plain versions
    phase.start("8")
    for dtype in (torch.float32, torch.float64) if want("8") else ():
        buckets = [(short, t_short, n_short)]
        if dtype == torch.float64:  # fp32 at full width: phase 9
            buckets.append((bench[:2], t_full, n_full))
        for reads, t_pad, n2 in buckets:
            errs = compare_pre_kernels(model, pre_bucket(model, reads, t_pad, n2),
                                       dtype, lm, le)
            log(f"[8] bucket {(len(reads), t_pad, n2)} K {model.num_kmers} {dtype}: "
                f"every output and the selections bit for bit, max abs err {errs}")
        torch.cuda.empty_cache()
        max_err.update(errs)

    # 9. the batched pre-pass at the engine's bucket shape
    phase.start("9")
    if want("9"):
        times = phase_9(model, bench, lm, le, launches, t_full, n_full)
    # 10. the exact per-read NTC through its CLI
    phase.start("10")
    if want("10"):
        long_ref = phase_10(model, bench, lm, le)
    return times, long_ref


def phase_9(model, bench, lm, le, launches: dict, t_full: int, n_full: int):
    import torch

    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

    sig, kid, N_r, T_r = pre_bucket(model, bench[:NTC_READS], t_full, n_full)
    means, stdevs, c1, c2 = model_tensors(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kn.reset_counts()
    t0 = time.perf_counter()
    pn = nb.pre_tn_batch(sig, kid, N_r, T_r, means, stdevs, lm, le, CN, torch.float32)
    pk = nb.pre_tk_batch(sig, T_r, means, c1, c2, lm, le, model.alphabet_size, CK0,
                         torch.float32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pre_launches, pre_plain = dict(kn.LAUNCHES), dict(kn.PLAIN_RUNS)
    k8_parts = dict(kn.TN_BWD_SEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[9] pre-pass ({NTC_READS}, {t_full}) N2 {n_full} K {model.num_kmers} CN {CN} "
        f"CK0 {CK0} fp32: {wall * 1e3:.1f} ms wall | launches {pre_launches}, "
        f"ntc_tn_bwd_sel's kernels {k8_parts} | plain {pre_plain} | peak device memory "
        f"{peak:.2f} GiB")
    if (any(v == 0 for v in pre_launches.values()) or any(pre_plain.values())
            or any(v != pre_launches["ntc_tn_bwd_sel"] for v in k8_parts.values())):
        raise AssertionError("the pre-pass missed a kernel or ran a plain version")
    launches.update(pre_launches)
    fails = []
    K = model.num_kmers
    for j in range(NTC_READS):
        T, N = int(T_r[j]), int(N_r[j])
        for name, res, cells in (("preProcTN", pn, T * N), ("preProcTK", pk, T * K)):
            zf, zb = float(res.Zf[j]), float(res.Zb[j])
            if math.isinf(zf) or math.isinf(zb) or abs(zf - zb) / cells > FP32_EPSILON:
                fails.append(f"read {j} {name} Zf {zf} Zb {zb}")
    log(f"[9] Z gates (fp32 eps {FP32_EPSILON}, cells T*N and T*K): "
        f"{NTC_READS - len({f.split()[1] for f in fails})}/{NTC_READS} reads pass"
        + "".join(f"; {f}" for f in fails))
    if len(fails) > 1:
        raise AssertionError("more than one read fails the pre-pass Z gates")
    live = torch.arange(t_full, device="cuda")[:, None] < T_r[None, :]
    at_cap = {name: float(((res.cnt == cap) & live).sum() / live.sum())
              for name, res, cap in (("TN", pn, CN), ("TK", pk, CK0))}
    log(f"[9] overflowing reads: TN {int(pn.overflow.sum())}, TK {int(pk.overflow.sum())} "
        f"of {NTC_READS} | share of live columns at the cap: TN {at_cap['TN']:.4%} "
        f"(cap {CN}), TK {at_cap['TK']:.4%} (cap {CK0})")
    del pn, pk
    dtype = torch.float32
    sig = sig.to(dtype)
    tab = nb.tn_tables(kid, means, stdevs, dtype)
    tabk = nb.tk_tables(means, c1, c2, dtype)
    fwd = kn.tn_fwd(sig, tab, N_r, lm, le)
    bwd = kn.tk_bwd(sig, tabk, T_r, 4, lm, le)
    tn_units = int(T_r.sum()) * n_full
    tk_units = int(T_r.sum()) * model.num_kmers
    runs = {
        "ntc_tn_fwd": (lambda: kn.tn_fwd(sig, tab, N_r, lm, le),
                       lambda: kn.tn_fwd_plain(sig, tab, N_r, lm, le),
                       [sig, tab, N_r], tn_units),
        "ntc_tn_bwd_sel": (lambda: kn.tn_bwd_sel(sig, tab, kid, N_r, T_r, fwd, CN, lm, le),
                           lambda: kn.tn_bwd_sel_plain(sig, tab, kid, N_r, T_r, fwd, CN,
                                                       lm, le),
                           [sig, tab, kid, N_r, T_r, fwd], tn_units),
        "ntc_tk_bwd": (lambda: kn.tk_bwd(sig, tabk, T_r, 4, lm, le),
                       lambda: kn.tk_bwd_plain(sig, tabk, T_r, 4, lm, le),
                       [sig, tabk, T_r], tk_units),
        "ntc_tk_fwd_u": (lambda: kn.tk_fwd_u(sig, tabk, T_r, bwd, 4, lm, le),
                         lambda: kn.tk_fwd_u_plain(sig, tabk, T_r, bwd, 4, lm, le),
                         [sig, tabk, T_r, bwd], tk_units),
    }
    times = {}
    log(f"[9] each kernel bit for bit with its plain version at ({NTC_READS}, {t_full}), "
        "and times:")
    for name, (kern, plain, inputs, units) in runs.items():
        want, plain_ms = timed_once(plain)
        for i, (g, w) in enumerate(zip(tensors_of(kern()), tensors_of(want))):
            same(f"{name} output {i}", g, w)
        del want
        times[name] = timed(name, kern, plain_ms, inputs, units, 2)
    # K8's two kernels alone, and the u store between them
    u, _ = kn.tn_bwd_u(sig, tab, N_r, T_r, fwd, lm, le)
    parts = {"tn_bwd_u": cuda_ms(lambda: kn.tn_bwd_u(sig, tab, N_r, T_r, fwd, lm, le), 2),
             "tn_sel": cuda_ms(lambda: kn.tn_sel(u, kid, CN), 2)}
    log(f"  ntc_tn_bwd_sel's kernels: the chain (tn_bwd_u) {parts['tn_bwd_u']:.3f} ms, the "
        f"selection (tn_sel) {parts['tn_sel']:.3f} ms; u store {u.numel() * u.element_size() / 1e9:.2f} GB")
    times["ntc_tn_bwd_sel"].update(
        parts=parts, design="tn_bwd_u_kernel (the chain, one block a read) into a u store, "
                            "then tn_sel_kernel (one warp a row)")
    times["ntc_tk_bwd"]["design"], times["ntc_tk_fwd_u"]["design"] = tk_design(
        model.num_kmers, sig.element_size())
    times["ntc_tn_fwd"]["design"] = tn_fwd_design(n_full, sig.element_size())
    del fwd, bwd, runs, tab, tabk, sig, u
    torch.cuda.empty_cache()
    return times


def tk_design(K: int, itemsize: int) -> tuple[str, str]:
    """K9's and K10's design at K columns, from their launch geometry."""
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

    geo = kn.tk_geometry(K, kn.TK_A, itemsize)
    own = (f"{geo.threads} threads (built for {geo.max_threads}), each owning the "
           f"{kn.TK_A} columns of one k-mer group and its logsumexp, computed once a row; "
           f"mu/c1/c2 in registers; the signal staged in chunks of {kn.TK_CHUNK} (cp.async)")
    return (f"{own}; {geo.bwd_bytes} B of shared memory",
            f"{own}; the backward rows in a ring of {geo.ring} rows (each thread's own "
            f"values, cp.async, {geo.ring - 1} row{'s' if geo.ring > 2 else ''} ahead); "
            f"{geo.fwd_bytes} B of shared memory")


def tn_fwd_design(N2: int, itemsize: int) -> str:
    """K7's design at width N2 and element size `itemsize`, from its launch
    geometry and layout."""
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

    geo = kn.tn_fwd_geometry(N2)
    if kn.tn_fwd_layout(itemsize) == "contiguous":
        cols = (f"{geo.cols} contiguous columns (M and E out as vectors of four); E[n-1] from "
                f"the thread's registers, the lane before (shuffle) or the warp before "
                f"(shared memory)")
    else:
        cols = f"{geo.cols} columns {geo.threads} apart; E[n-1] from a shared copy of the row"
    return (f"{geo.threads} threads, each owning {cols}, one barrier a row; mu/sinv/l2s in "
            f"registers, the score and logaddexp as selects; the signal staged in chunks of "
            f"{kn.TK_CHUNK} (cp.async)")


def walk_design(CN: int, CK: int) -> str:
    """K16's design at its (CN, CK), from its launch geometry."""
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    geo = kern.walk_geometry(CN, CK)
    copies = ("one tensor copy (TMA) of each array a chunk" if geo.instance == "tma"
              else "cp.async by warp 1's lanes")
    return (f"two warps a read: thread 0 walks rows staged in shared memory, chunks of "
            f"{geo.rows} rows of {geo.row_bytes} B ({copies}, a chunk ahead); warp 1 gathers "
            f"lp and writes the records a chunk behind; {geo.nbytes} B of shared memory")


def phase_10(model, bench, lm, le):
    import torch

    from dynamont_tpu_torch.models.ntc import CAP_LADDER
    from dynamont_tpu_torch.models.packing import round_up
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn
    from dynamont_tpu_torch.utils.signal import hampel_filter
    from dynamont_tpu_torch.utils.synthetic import make_read

    n_of = lambda read: len(read) - model.kmer_size + 2  # N = k-mers + 1
    means, stdevs, c1, c2 = model_tensors(model)
    before = dict(kn.LAUNCHES)
    for i, (s, r) in enumerate(make_read(model, n_bases=25, seed=s) for s in range(3)):
        for mode, flags in (("segment", ()), ("calcZ", ("-z",)), ("train", ("--train",))):
            t0 = time.perf_counter()
            got, out_g = run_cli(s, r, "cuda", flags)
            t1 = time.perf_counter()
            want, out_w = run_cli(s, r, "cpu", flags)
            err = ntc_agree(got, want, mode)
            log(f"[10] short read {i} {mode}: cuda {t1 - t0:.2f} s, cpu "
                f"{time.perf_counter() - t1:.2f} s, rung {got.caps}, max diff {err:.3g}, "
                f"stdout {'identical' if out_g == out_w else 'differs'}")
    if kn.LAUNCHES != before:
        raise AssertionError("the per-read NTC launched a pre-pass kernel")
    s, r = bench[0]
    s = hampel_filter(s.copy())  # as the TSV reader delivers it (phase 12)
    t0 = time.perf_counter()
    res, _ = run_cli(s, r, "cuda")
    wall = time.perf_counter() - t0
    if not res.segments or not math.isfinite(res.Z):
        raise AssertionError(f"long read: {len(res.segments or [])} segments, Z {res.Z}")
    log(f"[10] long read ({len(r)} bases, T {len(s) + 1}) segment on cuda: {wall:.1f} s, "
        f"rung {res.caps} (CAP_LADDER index {CAP_LADDER.index(res.caps)}), "
        f"{len(res.segments)} segments, Z {res.Z!r}")
    cap_n, cap_k = res.caps
    sig1, kid1, N1, T1 = pre_bucket(model, [(s, r)], len(s) + 1, round_up(n_of(r), 256))
    pn1 = nb.pre_tn_batch(sig1, kid1, N1, T1, means, stdevs, lm, le, cap_n, torch.float64)
    pk1 = nb.pre_tk_batch(sig1, T1, means, c1, c2, lm, le, model.alphabet_size, cap_k,
                          torch.float64)
    tn_pre, tk_pre = res.prepass
    bad_tn = same_candidates(tn_pre, pn1, kid1.shape[1] + 1, False)
    bad_tk = same_candidates(tk_pre, pk1, model.num_kmers, True)
    log(f"[10] batched fp64 kernels at R = 1, caps {res.caps}: TN {bad_tn}, TK {bad_tk} "
        f"of {len(s) + 1} columns differ from the per-read pre-pass")
    if bad_tn or bad_tk:
        raise AssertionError("batched and per-read candidate sets differ")
    return s, r, res


def s_max_of(n2: int) -> int:
    return -(-(n2 + n2 // 4 + 64) // 128) * 128  # models/ntc_batch._dispatch


def compare_lattice_kernels(k: dict, plain_ms: dict, kt: dict | None = None) -> int:
    """K11, K13, K15 and K16 against their plain versions on the inputs each
    kernel had in one engine bucket (`k`, ntc_bucket_program's keep; K15
    wrote lp over the store there, as the engine runs it): every output
    bit for bit, then the segment summaries. Given `kt`, the training
    program's keep on the same bucket (bucket_keeps), K17 and K18 too
    (compare_backward, compare_forward). Raises otherwise. Fills plain_ms with each plain
    version's CUDA-event time; returns the number of reads walked."""
    compare_tab_gather(k, plain_ms)
    compare_backward(k, plain_ms, kt)
    compare_forward(k, plain_ms, kt)
    return compare_walk(k, plain_ms)


def compare_tab_gather(k: dict, plain_ms: dict) -> None:
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    want, plain_ms["ntc_tab_gather"] = timed_once(
        lambda: kern.tab_gather_plain(k["ks"], k["table"], k["dims"]))
    for f, g, w in zip(want._fields, k["prm"], want):
        same(f"ntc_tab_gather {f}", g, w)


def compare_backward(k: dict, plain_ms: dict, kt: dict | None = None) -> None:
    """K13's store against plain; given kt (from bucket_keeps), plain K13
    and K18 are one run of ntc_train_batch, which keeps the backward store
    on the way, and K18's b0 must be K13's row 0."""
    import torch

    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk

    plan, dims, prm, sig, tl = k["plan"], k["dims"], k["prm"], k["sig"], k["trans_log"]
    N_r, T_r = k["N_r"], k["T_r"]
    if kt is None:
        want, plain_ms["ntc_bwd"] = timed_once(
            lambda: kern.bwd_plain(plan, dims, prm, sig, tl, N_r, T_r))
        same("ntc_bwd store", k["bwd"], want)
        return
    bwd_p = torch.empty_like(k["bwd"])
    want, ms = timed_once(lambda: tk.train_plain(
        plan, dims, prm, sig, kt["fwd"], kt["Zf"], tl, N_r, T_r, kt["K"], bwd_out=bwd_p))
    plain_ms["ntc_bwd"] = plain_ms["ntc_train"] = ms
    same("ntc_bwd store", k["bwd"], bwd_p)
    del bwd_p
    for f, w in zip(("tacc", "em", "b0"), want):
        same(f"ntc_train {f}", kt[f], w)
    same("ntc_train b0 against ntc_bwd's row 0", kt["b0"], k["bwd"][0])


def compare_forward(k: dict, plain_ms: dict, kt: dict | None = None) -> None:
    """K15's outputs against plain; given kt, plain K15 and K17 are one run
    of ntc_posterior_viterbi_batch, which keeps the forward store, and
    K17's row T_r-1 E must be K15's fwdEf. The kernels' lp, choices,
    slots and forward store may lie on the host."""
    import torch

    from dynamont_tpu_torch.ops import ntc_kernels as kern

    plan, dims, prm, sig, tl = k["plan"], k["dims"], k["prm"], k["sig"], k["trans_log"]
    T_r = k["T_r"]
    fwd = None if kt is None else kt["fwd"]
    fwd_out = None if fwd is None else torch.empty(fwd.shape, dtype=fwd.dtype, device=sig.device)
    want, plain_ms["ntc_pv"] = timed_once(lambda: kern.pv_plain(
        plan, dims, prm, sig, k["bwd"], k["Zb"], tl, T_r, fwd_out=fwd_out))
    for f, w in zip(PV_OUTS, want):
        same_blocks(f"ntc_pv {f}", k[f], w)
    del want
    if kt is not None:
        plain_ms["ntc_fwd_store"] = plain_ms["ntc_pv"]
        same_blocks("ntc_fwd_store store", fwd, fwd_out)
        del fwd_out
        r = torch.arange(dims.R, device=fwd.device)
        same("ntc_fwd_store row T_r-1 E against ntc_pv's fwdEf",
             fwd[T_r.long().to(fwd.device) - 1, r, 3].to(sig.device), k["fwdEf"])


def compare_walk(k: dict, plain_ms: dict) -> int:
    """K16's records against plain, then the segment summaries; returns
    the number of reads walked."""
    import torch

    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_walk as nw

    S_max = k["walk_dims"][-1]
    (rec, fin), plain_ms["ntc_walk"] = timed_once(lambda: kern.walk_plain(
        k["lp"], k["choices"], k["slots"], k["plan"], *k["start"], k["N_r"], k["T_r"],
        *k["walk_dims"]))
    same("ntc_walk records", k["rec"], rec)
    same("ntc_walk fin", k["fin"], fin)
    segs = [nw.finish_records(r, f, S_max) for r, f in ((k["rec"], k["fin"]), (rec, fin))]
    for i, (g, w) in enumerate(zip(*segs)):
        same(f"segment summaries {i}", g, w)
    torch.cuda.synchronize()
    return int((segs[0][0] > 0).sum())


def same_blocks(name: str, got, want, rows: int = 1024) -> None:
    """same() a block of leading rows at a time, each block of `got` moved
    to `want`'s device: outputs too large to hold twice on the card are
    kept on the host."""
    for i in range(0, got.shape[0], rows):
        same(f"{name} (rows {i}+)", got[i:i + rows].to(want.device), want[i:i + rows])


def compare_ckpt(kc: dict, plain_ms: dict, bwd: bool = True, pv: bool = True) -> None:
    """K14 (if bwd) and K15's checkpoint mode (if pv) against their plain
    versions on the inputs they had in one engine bucket (`kc`, the
    checkpointed route's keep; its K15 outputs may lie on the host): every
    output bit for bit. Fills plain_ms."""
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    plan, dims, prm, sig, tl = kc["plan"], kc["dims"], kc["prm"], kc["sig"], kc["trans_log"]
    N_r, T_r = kc["N_r"], kc["T_r"]
    if bwd:
        (ckpt, row0), plain_ms["ntc_bwd_ckpt"] = timed_once(
            lambda: kern.bwd_ckpt_plain(plan, dims, prm, sig, tl, N_r, T_r))
        same("ntc_bwd_ckpt checkpoints", kc["ckpt"], ckpt)
        same("ntc_bwd_ckpt row 0", kc["row0"], row0)
        del ckpt, row0
    if not pv:
        return
    want, plain_ms["ntc_pv_ckpt"] = timed_once(lambda: kern.pv_ckpt_plain(
        plan, dims, prm, sig, kc["ckpt"], kc["Zb"], tl, N_r, T_r))
    for f, w in zip(PV_OUTS, want):
        same_blocks(f"ntc_pv_ckpt {f}", kc[f], w)


def same_routes(kc: dict, kf: dict) -> None:
    """The checkpointed route's keep `kc` against the full-store route's
    `kf` on one bucket: the checkpoints are the store's rows (c+1)*C (the
    last -inf), row 0 its row 0, and every later output is equal."""
    import torch

    from dynamont_tpu_torch.ops import ntc_batch as nb

    C = nb.C_CKPT
    rows = kf["ckpt_rows"] if "ckpt_rows" in kf else kf["bwd"][C::C]
    same("checkpoints against the store's rows (c+1)*C", kc["ckpt"][:-1], rows)
    if not bool(torch.isneginf(kc["ckpt"][-1]).all()):
        raise AssertionError("the last chunk's checkpoint is not -inf")
    same("row 0 against the store's", kc["row0"], kf["row0"] if "row0" in kf else kf["bwd"][0])
    for f in ("Zb", "lp", "choices", "slots", "apEf", "fwdEf", "rec", "fin"):
        same(f"checkpointed route {f} against the full store's", kc[f], kf[f])


def bucket_keeps(eng, items, ckpt: bool | None = None) -> tuple[dict, dict]:
    """The resquiggle and the training bucket programs' keeps of `items`
    as one bucket at the engine's caps (the resquiggle program's lattice
    route by `ckpt`, as ntc_bucket_program takes it). The two programs'
    plans, gathered parameters and signals must be equal; kt then shares
    k's."""
    k, kt = {}, {}
    gidx = list(range(len(items)))
    eng._dispatch(gidx, items, eng.cap_n, eng.cap_k, keep=k, ckpt=ckpt)
    eng._train_bucket(gidx, items, keep=kt)
    for f in k["plan"]._fields:
        same(f"training program plan {f}", getattr(kt["plan"], f), getattr(k["plan"], f))
    for f, a, b in zip(k["prm"]._fields, kt["prm"], k["prm"]):
        same(f"training program {f}", a, b)
    same("training program sig", kt["sig"], k["sig"])
    kt.update(plan=k["plan"], prm=k["prm"], sig=k["sig"])
    return k, kt


def phase_12_child(reads: list, part: str):
    """Phase 12's plain K13 + K18 run (`part` "bwd") or plain K16 run
    ("walk") on the engine's (16, 16384) bucket, in a spawned process
    beside the parent's plain runs (the plain versions are host-bound
    loops over 16384 rows): the bucket of `reads`, (signal, read) pairs,
    rebuilt here by the same kernels, each kernel held to its plain
    version as compare_backward and compare_walk do. Returns the plain
    runs' CUDA-event ms, and for "walk" the reads walked too."""
    # set before torch starts CUDA here: expandable segments keep this
    # process's caching allocator from stranding memory the parent needs
    # (not in the parent, whose cold allocations the CLI timings include)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch

    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
    from dynamont_tpu_torch.models.registry import load_model_for_pore

    def bwd(eng, items, plain_ms):
        k, kt = bucket_keeps(eng, items)
        for f in ("lp", "choices", "slots", "rec"):  # K15's and K16's: not read here
            del k[f]
        torch.cuda.empty_cache()  # the card is shared with two more processes
        compare_backward(k, plain_ms, kt)
        return plain_ms

    def walk(eng, items, plain_ms):
        k = {}
        eng._dispatch(list(range(len(items))), items, eng.cap_n, eng.cap_k, keep=k)
        del k["bwd"]
        torch.cuda.empty_cache()
        return plain_ms, compare_walk(k, plain_ms)

    eng = NTCBatchEngine(load_model_for_pore("rna002"), "rna002", device="cuda")
    out = {"bwd": bwd, "walk": walk}[part](eng, [BatchItem(s, r) for s, r in reads], {})
    torch.cuda.empty_cache()  # this worker may take the next task
    return out


def wide_pv_ckpt_child(reads: list) -> float:
    """Plain K15's checkpoint mode on the wide rung's bucket, in a second
    spawned process beside the parent and phase_12_child (the longest of
    the plain runs, a host-bound loop over 16384 rows): `reads`, (signal,
    read) pairs, through the engine's checkpointed route at WIDE_CAPS, its
    K15 outputs moved to the host (the card holds three processes'
    buckets), then the plain version on the same inputs, every output bit
    for bit. Returns the plain run's CUDA-event ms."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"  # as phase_12_child
    import torch

    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.models.ntc_batch import WIDE_CAPS, NTCBatchEngine
    from dynamont_tpu_torch.models.registry import load_model_for_pore

    eng = NTCBatchEngine(load_model_for_pore("rna002"), "rna002", device="cuda")
    kc = {}
    eng._dispatch(list(range(len(reads))), [BatchItem(s, r) for s, r in reads], *WIDE_CAPS,
                  keep=kc)
    del kc["rec"]
    for f in PV_OUTS:
        kc[f] = kc[f].cpu()
    torch.cuda.empty_cache()
    plain_ms = {}
    compare_ckpt(kc, plain_ms, bwd=False)
    del kc
    torch.cuda.empty_cache()
    return plain_ms["ntc_pv_ckpt"]


def phase_11(model, max_err: dict):
    """The lattice kernels, and the training kernels (phase 13(a)), against
    their plain versions on the short reads (module docstring)."""
    import torch

    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.models.ntc_batch import WIDE_CAPS, NTCBatchEngine
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk
    from dynamont_tpu_torch.utils.synthetic import make_read

    items = [BatchItem(*make_read(model, n_bases=n, seed=s))
             for s, n in ((0, 25), (1, 31), (2, 18))]
    for dtype in (torch.float32, torch.float64):
        for caps in ((CN, CK0), WIDE_CAPS):
            t0 = time.perf_counter()
            # the CPU tests' engine padding
            eng = NTCBatchEngine(model, "rna002", device="cuda", dtype=dtype, t_pad_to=64,
                                 n_pad_to=16, cap_n=caps[0], cap_k=caps[1])
            before = train_counts()
            keep, kt = bucket_keeps(eng, items, ckpt=False)  # the full store
            trained = train_launched(kt["dims"], kt["sig"].element_size(), before)
            plain_ms = {}
            walked = compare_lattice_kernels(keep, plain_ms, kt)
            R, t_pad = keep["sig"].shape[0], keep["sig"].shape[1] + 1
            msg = (f"[11] bucket {(R, t_pad)} {keep['dims']} {dtype}: K11, K13, K15, K16 and "
                   f"(13a) K17, K18 ({trained}) every output bit for bit, {walked}/{len(items)} "
                   "reads walked")
            if caps == WIDE_CAPS:  # the engine's own route there: checkpointed
                kc = {}
                before = ckpt_counts()
                eng._dispatch(list(range(len(items))), items, *caps, keep=kc)
                inst = ckpt_launched(kc["dims"], kc["sig"].element_size(), before)
                compare_ckpt(kc, plain_ms)
                same_routes(kc, keep)
                msg += (f"; the engine's checkpointed route ({inst}): K14 and K15's checkpoint "
                        "mode bit for bit with their plain versions and with the full store's "
                        "outputs")
                del kc
            log(f"{msg} ({time.perf_counter() - t0:.1f} s); plain versions ms "
                + ", ".join(f"{k} {v:.1f}" for k, v in plain_ms.items()))
            del keep, kt
        torch.cuda.empty_cache()
    max_err.update(dict.fromkeys((*kern.LATTICE_KERNELS, *tk.KERNELS), 0.0))


def zstd_stand_in() -> bool:
    """The card's machine has no zstandard: give the CLI's CSV writer a
    pass-through stand-in, so that it writes plain CSV. True if it did."""
    import importlib.util
    import types

    if getattr(sys.modules.get("zstandard"), "STAND_IN", False):
        return True
    if importlib.util.find_spec("zstandard") is not None:
        return False

    class Writer:
        def __init__(self, raw):
            self.raw = raw

        def write(self, data):
            return self.raw.write(data)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class ZstdCompressor:
        def __init__(self, level: int = 3):
            pass

        def stream_writer(self, raw):
            return Writer(raw)

    mod = types.ModuleType("zstandard")
    mod.ZstdCompressor = ZstdCompressor
    mod.STAND_IN = True
    sys.modules["zstandard"] = mod
    return True


def read_rows(path: str, plain_csv: bool) -> list:
    """The CSV rows the CLI wrote."""
    with open(path, "rb") as f:
        data = f.read()
    if not plain_csv:
        import io as _io

        import zstandard as zstd

        data = zstd.ZstdDecompressor().stream_reader(
            _io.BytesIO(data), read_across_frames=True).read()
    return [ln.split(",") for ln in data.decode().strip().split("\n")[1:]]


def phase_12(model, bench, launches: dict, long_ref):
    """The resquiggle engine through its CLI at full width, then each
    lattice kernel against its plain version and timed on the bucket the
    engine ran, then the wide rung at full width (module docstring).
    Returns the lattice kernels' timing entries."""
    import numpy as np
    import torch

    from dynamont_tpu_torch.cli import resquiggle
    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.ops import nt_banded_kernels as kk
    from dynamont_tpu_torch.models.ntc_batch import WIDE_CAPS, WIDE_READS
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk

    reads = bench[:NTC_READS]
    plain_csv = zstd_stand_in()
    if plain_csv:
        log("[12] no zstandard here: the CLI writes through a pass-through stand-in, so "
            "the reads/s below leave out the CSV's compression")
    with tempfile.TemporaryDirectory(prefix="dynamont_ntc_") as tmp:
        tsv = os.path.join(tmp, "reads.tsv")
        out = os.path.join(tmp, "out.csv.zst")
        write_tsv(tsv, reads)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in (kk, kn, kern, tk):
            mod.reset_counts()
        t0 = time.perf_counter()
        eng = resquiggle.main(["--tsv", tsv, "-o", out, "--mode", "resquiggle", "-p",
                               "rna002", "--device", "cuda", "--profile"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lat, pre, pv_inst = dict(kern.LAUNCHES), dict(kn.LAUNCHES), dict(kern.PV_LAUNCHES)
        ck_inst = ckpt_counts()
        bwd_inst, k8_parts = dict(kern.BWD_LAUNCHES), dict(kn.TN_BWD_SEL_LAUNCHES)
        plain = {**kern.PLAIN_RUNS, **kn.PLAIN_RUNS}
        peak = torch.cuda.max_memory_allocated() / 2**30
        pr = eng.profile
        log(f"[12] CLI --mode resquiggle, {NTC_READS} reads: {wall:.2f} s wall = "
            f"{NTC_READS / wall:.2f} reads/s | engine dispatch {pr['dispatch_s']:.3f} s, "
            f"collect {pr['collect_s']:.3f} s = "
            f"{NTC_READS / (pr['dispatch_s'] + pr['collect_s']):.2f} reads/s | wide "
            f"retries {pr['wide_retries']} ({pr['wide_s']:.2f} s), exact retries "
            f"{pr['exact_retries']} ({pr['exact_s']:.2f} s) | launches {pre} {lat}, ntc_pv "
            f"by instance {pv_inst}, ntc_bwd by instance {bwd_inst}, ntc_tn_bwd_sel's kernels "
            f"{k8_parts} | plain {plain} | peak device memory {peak:.2f} GiB")
        if (any(lat[k] == 0 for k in MAIN_RUNG) or any(v == 0 for v in pre.values())
                or any(plain.values()) or any(kk.LAUNCHES.values())
                or any(tk.LAUNCHES.values())):
            raise AssertionError("the engine missed a kernel, ran a plain version or a "
                                 "training kernel")
        if pv_inst["shared"] != lat["ntc_pv"]:
            raise AssertionError("ntc_pv ran its device-memory instance on the main rung")
        if bwd_inst["shared"] != lat["ntc_bwd"]:
            raise AssertionError("ntc_bwd ran its device-memory instance on the main rung")
        if any(v != pre["ntc_tn_bwd_sel"] for v in k8_parts.values()):
            raise AssertionError(f"ntc_tn_bwd_sel's two kernels ran {k8_parts} times")
        if pr["exact_retries"] > 2:
            raise AssertionError(f"{pr['exact_retries']} reads reached the exact rung")
        log(f"[12] the natural run's wide rung: {pr['wide_retries']} of {NTC_READS} reads "
            f"retried wide in {pr['wide_s']:.3f} s; K14 by instance {ck_inst[0]}, K15's "
            f"checkpoint mode by instance {ck_inst[1]}")
        if ck_inst[0]["device"] or ck_inst[1]["device"]:
            raise AssertionError("the natural run's wide rung left a cluster instance")
        errors = os.path.join(tmp, "out.errors")
        if os.path.exists(errors):
            with open(errors) as f:
                raise AssertionError(f"errors written: {f.read()[:2000]}")
        rows = read_rows(out, plain_csv)
        per_read = {f"r{i}": 0 for i in range(NTC_READS)}
        for row in rows:
            per_read[row[0]] += 1
        log(f"[12] {len(rows)} CSV rows, per read {min(per_read.values())}-"
            f"{max(per_read.values())}")
        if min(per_read.values()) < 0.5 * N_BASES:
            raise AssertionError(f"a read yields too few rows: {per_read}")
        items = [BatchItem(job.signal, job.read)
                 for job in readers.generate_tsv_jobs(tsv, True)]
    launches.update(pre)
    launches.update({k: lat[k] for k in MAIN_RUNG})

    if long_ref is not None:
        s, r, ref = long_ref
        if not (np.array_equal(items[0].signal, s) and items[0].read == r):
            raise AssertionError("phase 10's long read is not the engine's read 0")
        got = eng.run(items[:1])[0]
        if got.error is not None:
            raise AssertionError(f"read 0: {got.error}")
        bad, n, dz, dp = segments_apart(got, ref)
        log(f"[12] read 0 fp32 engine vs the exact fp64 rung: {bad} of {n} segments differ "
            f"(bound {max(1, n // 50)}), Z {got.Z!r} vs {ref.Z!r} (rel {dz:.2e}), max prob "
            f"diff {dp:.2e}")
        if bad > max(1, n // 50) or dz > 1e-3:
            raise AssertionError("the engine's read 0 is off the exact rung")

    # each lattice kernel, and the training kernels (phase 13's full-width
    # part), against its plain version on the bucket the engine ran, then
    # timed there. Three processes share the card, the longest run (plain
    # K15's checkpoint mode) in one spawned process from the start; the
    # parent's plain K15 + K17 waits for the other's K13 + K18, which
    # holds the same bucket, and runs with its kernel's outputs on the host
    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the card is shared with the spawned processes
    pairs = [(it.signal, it.read) for it in items[:NTC_READS]]
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        bwd_child = pool.apply_async(phase_12_child, (pairs, "bwd"))
        wide_child = pool.apply_async(wide_pv_ckpt_child, (pairs[:WIDE_READS],))
        walk_child = pool.apply_async(phase_12_child, (pairs, "walk"))  # after "bwd"
        wide_plain_ms = {"ntc_bwd_ckpt": wide_ckpt_plain(eng, items[:WIDE_READS])}
        log(f"[12] the wide rung's bucket ({WIDE_READS}, 16384) at {WIDE_CAPS}: K14's "
            f"checkpoints and row 0 bit for bit with its plain version's "
            f"({wide_plain_ms['ntc_bwd_ckpt'] / 1e3:.1f} s, beside the spawned processes)")
        plain_ms = bwd_child.get()
        t1 = time.perf_counter()
        before = train_counts()
        k, kt = bucket_keeps(eng, items[:NTC_READS])
        trained = train_launched(kt["dims"], kt["sig"].element_size(), before, "shared")
        host = ((k, ("lp", "choices", "slots")), (kt, ("fwd",)))  # the kernels' outputs
        for d, fields in host:
            for f in fields:
                d[f] = d[f].cpu()
        torch.cuda.empty_cache()
        shape = (k["sig"].shape[0], k["sig"].shape[1] + 1, k["walk_dims"][-1])
        if shape != (NTC_READS, 16384, s_max_of(2048)):
            raise AssertionError(f"engine bucket (R, T_pad, S_max) {shape}")
        compare_tab_gather(k, plain_ms)
        compare_forward(k, plain_ms, kt)
        t2 = time.perf_counter()
        walk_ms, walked = walk_child.get()
        t3 = time.perf_counter()
        wide_plain_ms["ntc_pv_ckpt"] = wide_child.get()
    plain_ms.update(walk_ms)
    for d, fields in host:
        for f in fields:
            d[f] = d[f].cuda()
    del host
    log(f"[12] the wide rung's bucket: K15's checkpoint mode's lp, choices, slots, apEf and "
        f"fwdEf bit for bit with its plain version's "
        f"({wide_plain_ms['ntc_pv_ckpt'] / 1e3:.1f} s in a spawned process)")
    log(f"[12] bucket {shape[:2]} N2 2048 {k['dims']} fp32: K11, K13, K15, K16, K17, K18 "
        f"every output bit for bit with their plain versions, K17's row T_r-1 E with "
        f"K15's fwdEf and K18's b0 with K13's row 0 ({trained}), {walked}/{NTC_READS} "
        "reads walked "
        f"(from the pool's start: K13 + K18 ended at {t1 - t0:.1f} s, K11, K15 and K17 here "
        f"at {t2 - t0:.1f} s, K16 at {t3 - t0:.1f} s, K15's checkpoint mode at "
        f"{time.perf_counter() - t0:.1f} s)")
    times = lattice_times(k, plain_ms)
    del k
    times.update(train_times(kt, plain_ms))
    del kt
    torch.cuda.empty_cache()
    wide_rung(model, eng, items, launches)
    wide = wide_routes(eng, items[:WIDE_READS], wide_plain_ms)
    times["ntc_bwd_ckpt"] = wide["ntc_bwd_ckpt"]
    times["ntc_pv"]["ckpt"] = dict(wide["ntc_pv_ckpt"], launches=launches.pop("ntc_pv_ckpt"),
                                   max_abs_err=0.0)  # bit for bit, or a check raised
    return times


def segments_apart(got, ref):
    """(borders or polish k-mers that differ, segments, Z rel diff, max
    probability diff) between two NTC results of one read."""
    key = lambda seg: (seg[0], seg[1], seg[2], seg[4])
    n = max(len(got.segments), len(ref.segments))
    bad = n - sum(key(g) == key(w) for g, w in zip(got.segments, ref.segments))
    dz = abs(got.Z - ref.Z) / abs(ref.Z)
    dp = max(abs(g[3] - w[3]) for g, w in zip(got.segments, ref.segments))
    return bad, n, dz, dp


def lattice_times(k: dict, plain_ms: dict) -> dict:
    """Each lattice kernel's timing entry on the inputs it had in the
    engine's bucket `k`, beside its plain version's time there."""
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_walk as nw

    plan, dims, prm, sig, tl = k["plan"], k["dims"], k["prm"], k["sig"], k["trans_log"]
    N_r, T_r, ks, table, bwd, Zb = k["N_r"], k["T_r"], k["ks"], k["table"], k["bwd"], k["Zb"]
    ks64 = ks.clamp(0, table.shape[1] - 1).long()  # dead slots (K) read a clipped row
    walk_args = (k["lp"], k["choices"], k["slots"], plan, *k["start"], N_r, T_r,
                 *k["walk_dims"])
    cells = int(T_r.sum()) * dims.CN * dims.CK
    steps = int(T_r.sum()) * nw.n_micro(dims.CN)
    p = plan
    bwd_in = [sig, p.cand_n, p.allowed, p.hd, p.d01, p.d02, p.brow_same, p.brow_next,
              p.bcol_same, p.bcol_suc, *prm, N_r, T_r]
    pv_in = [sig, p.cand_n, p.allowed, p.hd, p.row_same, p.row_prev, p.col_same,
             p.col_prec, prm.mu_k, prm.c1_k, prm.c2_k, prm.nsl, bwd, Zb, T_r]
    # the walk reads one cell of lp, choices, slots and the row maps per step
    walk_reads = steps * (4 + 2 + 4 + 2 * 4)
    log(f"[12] times at {(sig.shape[0], sig.shape[1] + 1)} N2 2048 {dims} fp32 (plain "
        "versions: their run above):")
    return {
        "ntc_tab_gather": timed(
            "ntc_tab_gather", lambda: kern.tab_gather(ks, table, dims),
            plain_ms["ntc_tab_gather"], [ks, table], ks.numel(), 3,
            library=lambda: table[:, ks64]),
        "ntc_bwd": dict(timed(
            "ntc_bwd", lambda: kern.bwd(plan, dims, prm, sig, tl, N_r, T_r),
            plain_ms["ntc_bwd"], bwd_in, cells, 2), design=bwd_design(dims, sig)),
        "ntc_pv": dict(timed(
            "ntc_pv", lambda: kern.pv(plan, dims, prm, sig, bwd, Zb, tl, T_r),
            plain_ms["ntc_pv"], pv_in, cells, 2), design=pv_design(dims, sig)),
        "ntc_walk": dict(timed(
            "ntc_walk", lambda: kern.walk(*walk_args), plain_ms["ntc_walk"],
            [k["start"][-1], N_r, T_r], steps, 2, walk_reads),
            design=walk_design(dims.CN, dims.CK)),
    }


def pv_design(dims, sig) -> str:
    """Which instance ntc_pv's full store takes at these dims and dtype."""
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    inst = kern.pv_instance(dims.CN, dims.CK, dims.A, sig.element_size())
    if inst.name == "shared":
        return (f"pv_shared_kernel: columns, backward column and plan rows in shared memory "
                f"({inst.shared_bytes} B)")
    return "pv_kernel: columns in a device-memory double buffer"


def bwd_design(dims, sig) -> str:
    """Which instance ntc_bwd takes at these dims and dtype."""
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    inst = kern.bwd_instance(dims.CN, dims.CK, dims.A, sig.element_size())
    if inst.name == "shared":
        return (f"bwd_shared_kernel: rows t + 1 and t and two stages of row inputs in "
                f"shared memory ({inst.nbytes} B)")
    return "bwd_kernel: row t + 1 read back from the device store"


def ckpt_design(name: str, dims, sig) -> str:
    """Which instance ntc_bwd_ckpt or ntc_pv_ckpt (`name`) takes at these
    dims and dtype."""
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    pick = kern.bwd_ckpt_instance if name == "ntc_bwd_ckpt" else kern.pv_ckpt_instance
    inst = pick(dims.CN, dims.CK, dims.A, sig.element_size())
    if inst.name == "cluster":
        kernel = name.removeprefix("ntc_") + "_cluster_kernel"
        return (f"{kernel}: one read on a cluster of {inst.G} CTAs, each holding its "
                f"{dims.CK // inst.G} k-slots of every column in shared memory "
                f"({inst.nbytes} B a CTA)")
    if name == "ntc_bwd_ckpt":
        return "bwd_ckpt_kernel: one block a read, rows in a device-memory double buffer"
    return "pv_kernel<S, true>: one block a read, columns in a device-memory double buffer"


def train_counts() -> tuple[dict, dict]:
    """K17's and K18's launches by instance so far."""
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk

    return dict(tk.FWD_STORE_LAUNCHES), dict(tk.TRAIN_LAUNCHES)


def train_launched(dims, itemsize: int, before: tuple[dict, dict], want: str | None = None,
                   n: int = 1) -> str:
    """Raises unless K17 and K18 each launched n times since `before`
    (train_counts), all in the instance its picker takes at dims (and that
    is `want`, when given); returns the instances, named for the log."""
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk

    named = []
    for label, pick, b, now in (("K17", tk.fwd_store_instance, before[0],
                                 tk.FWD_STORE_LAUNCHES),
                                ("K18", tk.train_instance, before[1], tk.TRAIN_LAUNCHES)):
        inst = pick(dims.CN, dims.CK, dims.A, itemsize).name
        got = {k: now[k] - b[k] for k in now}
        if got != {k: n * (k == inst) for k in now} or want not in (None, inst):
            raise AssertionError(f"{label} launched {got} by instance, not {n} of "
                                 f"{want or inst}")
        named.append(f"{label} {inst}")
    return ", ".join(named)


def ckpt_counts() -> tuple[dict, dict]:
    """K14's and K15's checkpoint mode's launches by instance so far."""
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    return dict(kern.BWD_CKPT_LAUNCHES), dict(kern.PV_CKPT_LAUNCHES)


def ckpt_launched(dims, itemsize: int, before: tuple[dict, dict], n: int = 1) -> str:
    """Raises unless K14 and K15's checkpoint mode each launched n times
    since `before` (ckpt_counts), all in the instance its picker takes at
    dims; returns the instances, named for the log."""
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    named = []
    for label, pick, b, now in (("K14", kern.bwd_ckpt_instance, before[0],
                                 kern.BWD_CKPT_LAUNCHES),
                                ("K15's checkpoint mode", kern.pv_ckpt_instance, before[1],
                                 kern.PV_CKPT_LAUNCHES)):
        inst = pick(dims.CN, dims.CK, dims.A, itemsize)
        got = {k: now[k] - b[k] for k in now}
        if got != {k: n * (k == inst.name) for k in now}:
            raise AssertionError(f"{label} launched {got} by instance, not {n} of {inst.name}")
        named.append(f"{label} {inst.name}" + (f" (G {inst.G})" if inst.G > 1 else ""))
    return ", ".join(named)


def train_times(kt: dict, plain_ms: dict) -> dict:
    """K17's and K18's timing entries on the inputs they had in the
    engine's training bucket `kt`, beside their plain runs' times."""
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk

    plan, dims, prm, sig, tl = kt["plan"], kt["dims"], kt["prm"], kt["sig"], kt["trans_log"]
    N_r, T_r, fwd, Zf, K = kt["N_r"], kt["T_r"], kt["fwd"], kt["Zf"], kt["K"]
    cells = int(T_r.sum()) * dims.CN * dims.CK
    p = plan
    fwd_in = [sig, p.cand_n, p.allowed, p.hd, p.row_same, p.row_prev, p.col_same,
              p.col_prec, prm.mu_k, prm.c1_k, prm.c2_k, prm.nsl]
    train_in = [sig, p.cand_n, p.allowed, p.hd, p.d01, p.d02, p.brow_same, p.brow_next,
                p.bcol_same, p.bcol_suc, p.live, p.ks, *prm, N_r, T_r, fwd, Zf]
    log(f"[12] training kernels at {(sig.shape[0], sig.shape[1] + 1)} N2 2048 {dims} fp32 "
        "(plain: the shared runs above, ntc_fwd_store = ntc_pv's, ntc_train = ntc_bwd's):")
    designs = train_design(dims, sig)
    return {
        "ntc_fwd_store": dict(timed(
            "ntc_fwd_store", lambda: tk.fwd_store(plan, dims, prm, sig, tl),
            plain_ms["ntc_fwd_store"], fwd_in, cells, 2), design=designs[0]),
        "ntc_train": dict(timed(
            "ntc_train", lambda: tk.train(plan, dims, prm, sig, fwd, Zf, tl, N_r, T_r, K),
            plain_ms["ntc_train"], train_in, cells, 2), design=designs[1]),
    }


def train_design(dims, sig) -> tuple[str, str]:
    """Which instances K17 and K18 take at these dims and dtype."""
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk

    fi = tk.fwd_store_instance(dims.CN, dims.CK, dims.A, sig.element_size())
    ti = tk.train_instance(dims.CN, dims.CK, dims.A, sig.element_size())
    fwd = (f"fwd_store_shared_kernel: columns t - 1 and t and two stages of row inputs in "
           f"shared memory ({fi.nbytes} B)" if fi.name == "shared"
           else "fwd_store_kernel: row t - 1 read back from the store")
    train = (f"train_shared_kernel: rows t + 1 and t, three slots of row inputs"
             + (", forward rows and term sums" if ti.fwd_staged else "")
             + f" in shared memory, moments off the chain ({ti.nbytes} B)"
             if ti.name == "shared"
             else "train_kernel: row t + 1 in a device-memory double buffer")
    return fwd, train


def wide_ckpt_plain(eng, items) -> float:
    """Plain K14 on the wide rung's bucket (`items` at WIDE_CAPS, where the
    engine takes the checkpointed route) against the kernel's checkpoints
    and row 0, bit for bit; returns its CUDA-event ms."""
    import torch

    from dynamont_tpu_torch.models.ntc_batch import WIDE_CAPS

    kc = {}
    eng._dispatch(list(range(len(items))), items, *WIDE_CAPS, keep=kc)
    for f in ("lp", "choices", "slots", "rec"):
        del kc[f]
    torch.cuda.empty_cache()  # the card is shared with the spawned processes
    plain_ms = {}
    compare_ckpt(kc, plain_ms, pv=False)
    del kc
    torch.cuda.empty_cache()
    return plain_ms["ntc_bwd_ckpt"]


def wide_routes(eng, items, plain_ms: dict) -> dict:
    """The wide rung's bucket (`items` at WIDE_CAPS) through both lattice
    routes: each route's bucket-program wall time and peak memory; the
    outputs bit for bit equal (same_routes); then K13 and K15 on the full
    store's inputs, and K14 and K15's checkpoint mode on the checkpointed
    route's, timed there. Returns the timing entries of ntc_bwd_ckpt and
    ntc_pv_ckpt (their plain times, `plain_ms`, measured by wide_ckpt_plain
    and wide_pv_ckpt_child)."""
    import torch

    from dynamont_tpu_torch.models.ntc_batch import WIDE_CAPS
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    gidx = list(range(len(items)))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    walls = {}
    for route, ckpt in (("full store, K13 + K15", False),
                        ("checkpointed, K14 + K15's checkpoint mode", True)):
        for rep in range(2):  # the first warms the allocator
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eng._dispatch(gidx, items, *WIDE_CAPS, ckpt=ckpt)
            torch.cuda.synchronize()
            walls[route] = ((time.perf_counter() - t0) * 1e3,
                            (torch.cuda.max_memory_allocated() - held) / 2**30)
            torch.cuda.empty_cache()
    log(f"[12] the wide rung's bucket ({len(items)}, 16384) at {WIDE_CAPS}, each route's "
        "bucket program (host clock, second run; peak above what was held): "
        + "; ".join(f"{r} {ms:.1f} ms, peak {gb:.2f} GiB" for r, (ms, gb) in walls.items()))

    kf, kc = {}, {}
    eng._dispatch(gidx, items, *WIDE_CAPS, keep=kf, ckpt=False)
    p, dims, prm, sig, tl = kf["plan"], kf["dims"], kf["prm"], kf["sig"], kf["trans_log"]
    N_r, T_r, Zb = kf["N_r"], kf["T_r"], kf["Zb"]
    before, before_bwd = dict(kern.PV_LAUNCHES), dict(kern.BWD_LAUNCHES)
    ms_full = {"ntc_bwd": cuda_ms(lambda: kern.bwd(p, dims, prm, sig, tl, N_r, T_r), 1),
               "ntc_pv": cuda_ms(lambda: kern.pv(p, dims, prm, sig, kf["bwd"], Zb, tl, T_r), 1)}
    if kern.PV_LAUNCHES["shared"] != before["shared"]:
        raise AssertionError("the wide full store ran ntc_pv's shared-column instance")
    if (kern.BWD_LAUNCHES["shared"] != before_bwd["shared"]
            or kern.BWD_LAUNCHES["device"] == before_bwd["device"]):
        raise AssertionError("the wide full store did not run ntc_bwd's bwd_kernel")
    full_design = f"{pv_design(dims, sig)}; K13 {bwd_design(dims, sig)}"
    C = nb.C_CKPT
    kf["ckpt_rows"], kf["row0"] = kf["bwd"][C::C].clone(), kf["bwd"][0].clone()
    del kf["bwd"], p, prm, sig
    torch.cuda.empty_cache()
    eng._dispatch(gidx, items, *WIDE_CAPS, keep=kc)
    same_routes(kc, kf)
    del kf
    torch.cuda.empty_cache()
    p, dims, prm, sig, tl = kc["plan"], kc["dims"], kc["prm"], kc["sig"], kc["trans_log"]
    N_r, T_r, ckpt, Zb = kc["N_r"], kc["T_r"], kc["ckpt"], kc["Zb"]
    for f in ("lp", "choices", "slots", "rec"):
        del kc[f]
    cells = int(T_r.sum()) * dims.CN * dims.CK
    bwd_in = [sig, p.cand_n, p.allowed, p.hd, p.d01, p.d02, p.brow_same, p.brow_next,
              p.bcol_same, p.bcol_suc, *prm, N_r, T_r]
    pv_in = bwd_in + [p.row_same, p.row_prev, p.col_same, p.col_prec, ckpt, Zb]
    log(f"[12] the wide rung's bucket {dims} fp32: outputs of both routes bit for bit "
        f"(checkpoints = the store's rows (c+1)*{C}, row 0, Zb, lp, choices, slots, finals, "
        f"walk); full store K13 {ms_full['ntc_bwd']:.3f} ms, K15 {ms_full['ntc_pv']:.3f} ms "
        f"({full_design}); "
        "checkpointed route (plain: the runs beside the spawned processes):")
    times = {
        "ntc_bwd_ckpt": dict(timed(
            "ntc_bwd_ckpt", lambda: kern.bwd_ckpt(p, dims, prm, sig, tl, N_r, T_r),
            plain_ms["ntc_bwd_ckpt"], bwd_in, cells, 2),
            design=ckpt_design("ntc_bwd_ckpt", dims, sig)),
        "ntc_pv_ckpt": dict(timed(
            "ntc_pv_ckpt", lambda: kern.pv_ckpt(p, dims, prm, sig, ckpt, Zb, tl, N_r, T_r),
            plain_ms["ntc_pv_ckpt"], pv_in, cells, 2),
            design=ckpt_design("ntc_pv_ckpt", dims, sig)),
    }
    del kc, p, prm, sig, ckpt
    torch.cuda.empty_cache()
    return times


def wide_rung(model, eng, items, launches: dict) -> None:
    """The engine's wide rung at full width: caps (2, 2) overflow every one
    of WIDE_READS phase-12 reads, which then re-run in one bucket at the
    wide caps. The pre-pass kernels, K11 and K16 launch twice (the tiny
    main bucket, the wide one), K13 and K15 once (the main bucket's full
    store) and K14 and K15's checkpoint mode once (the wide bucket's
    checkpointed route); no plain version runs, no read reaches the exact
    rung, and each read stays within the fp32-against-exact bounds of its
    main-rung result (`eng`'s). Puts the checkpointed kernels' launches
    into `launches`."""
    import torch

    from dynamont_tpu_torch.models.batch import BatchOutput
    from dynamont_tpu_torch.models.ntc_batch import WIDE_CAPS, WIDE_READS, NTCBatchEngine
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

    wide_items = items[:WIDE_READS]
    main = eng.run(wide_items)
    weng = NTCBatchEngine(model, "rna002", device="cuda", cap_n=2, cap_k=2)
    # a read on the exact rung would cost ~50 s: count it as a failure instead
    weng._run_exact = lambda it: BatchOutput(it, None, math.nan, "reached the exact rung")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kern.reset_counts()
    kn.reset_counts()
    before = ckpt_counts()
    held = torch.cuda.memory_allocated() / 2**30  # by the earlier phases
    t0 = time.perf_counter()
    outs = weng.run(wide_items)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lat = {k: kern.LAUNCHES[k] for k in kern.LATTICE_KERNELS}
    pre = dict(kn.LAUNCHES)
    plain = {**kern.PLAIN_RUNS, **kn.PLAIN_RUNS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    pr = weng.profile
    log(f"[12] wide rung, {WIDE_READS} reads at caps {WIDE_CAPS} after caps (2, 2): "
        f"{wall:.2f} s wall, of which the wide rung {pr['wide_s']:.2f} s | wide retries "
        f"{pr['wide_retries']}, exact retries {pr['exact_retries']} | launches {pre} {lat} | "
        f"plain {plain} | peak device memory {peak:.2f} GiB, {peak - held:.2f} GiB above "
        f"the {held:.2f} GiB held before")
    want = {"ntc_tab_gather": 2, "ntc_walk": 2, "ntc_bwd": 1, "ntc_pv": 1,
            "ntc_bwd_ckpt": 1, "ntc_pv_ckpt": 1}
    if (pr["wide_retries"] != WIDE_READS or pr["exact_retries"] or lat != want
            or any(v != 2 for v in pre.values()) or any(plain.values())):
        raise AssertionError("the wide rung missed a kernel, a read or fell further")
    # CK = CK0 + CN k-slots (ops/ntc_batch.NTCPlan): 256
    wide_dims = nb.PlanDims(WIDE_READS, WIDE_CAPS[0], WIDE_CAPS[1] + WIDE_CAPS[0], 4)
    log(f"[12] the wide bucket's instances: {ckpt_launched(wide_dims, 4, before)}")
    launches.update(ntc_bwd_ckpt=lat["ntc_bwd_ckpt"], ntc_pv_ckpt=lat["ntc_pv_ckpt"])
    worst = (0, 0.0, 0.0)
    for i, (got, ref) in enumerate(zip(outs, main)):
        if got.error is not None or ref.error is not None:
            raise AssertionError(f"wide rung read {i}: {got.error} / {ref.error}")
        bad, n, dz, dp = segments_apart(got, ref)
        if bad > max(1, n // 50) or dz > 1e-3:
            raise AssertionError(f"wide rung read {i}: {bad} of {n} segments differ from "
                                 f"the main rung, Z rel {dz:.2e}")
        worst = max(worst[0], bad), max(worst[1], dz), max(worst[2], dp)
    log(f"[12] wide rung against the main rung: at most {worst[0]} segments differ per "
        f"read, Z rel at most {worst[1]:.2e}, probabilities within {worst[2]:.2e}")
    del weng, outs
    torch.cuda.empty_cache()


def phase_13(model, bench, launches: dict, after_12: bool) -> dict:
    """NTC training: the training kernels on the short reads, then the
    training path through its CLI at full width and the training step's
    split (module docstring; the full-width kernel checks are phase 12's).
    Adds the counted run's K7-K10 launches to phase 12's (after_12) or
    replaces phase 9's. Returns K17's and K18's launches by instance on the
    counted run."""
    import torch

    from dynamont_tpu_torch.cli import train as train_cli
    from dynamont_tpu_torch.constants import TRAIN_INIT_NTK
    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
    from dynamont_tpu_torch.ops import nt_banded_kernels as kk
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk
    from dynamont_tpu_torch.training.trainer import Trainer
    from dynamont_tpu_torch.utils.synthetic import make_read

    # (c) the training path through its CLI (a and b: phases 11 and 12)
    short = [make_read(model, n_bases=n, seed=s) for s, n in ((0, 25), (1, 31), (2, 18))]
    path_kernels = (*kn.KERNELS, "ntc_tab_gather", *tk.KERNELS)
    with tempfile.TemporaryDirectory(prefix="dynamont_ntc_train_") as tmp:
        tsv = os.path.join(tmp, "train.tsv")
        write_tsv(tsv, bench[:TRAIN_READS])
        args = ["--tsv", tsv, "-p", "rna002", "--mode", "resquiggle", "-q", "0",
                "--batch_size", str(TRAIN_BATCH), "--max_batches", "2",
                "--precision", "fp32", "--device", "cuda"]
        outs = []
        for rep in range(2):
            out = os.path.join(tmp, f"run{rep}")
            for mod in (kk, kn, kern, tk):
                mod.reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = train_cli.main(args + ["-o", out])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            used = {**kn.LAUNCHES, **kern.LAUNCHES, **tk.LAUNCHES}
            plain = {**kn.PLAIN_RUNS, **kern.PLAIN_RUNS, **tk.PLAIN_RUNS}
            by_inst = dict(zip(tk.KERNELS, train_counts()))
            log(f"[13] CLI --mode resquiggle run {rep}: {TRAIN_READS} reads in {wall:.2f} s | "
                f"launches {used}, K17 and K18 by instance {by_inst} | plain {plain} | exact "
                f"rung {trainer.fp64_reads} | peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if any(by_inst[k]["shared"] != used[k] for k in tk.KERNELS):
                raise AssertionError("the NTC training path ran a device-memory instance of "
                                     "K17 or K18")
            if (any(used[k] == 0 for k in path_kernels)
                    or any(used[k] for k in (*MAIN_RUNG[1:], *CKPT_ROUTE[1:]))
                    or any(plain.values()) or any(kk.LAUNCHES.values())
                    or trainer.fp64_reads > 1):
                raise AssertionError("the NTC training path missed a kernel, ran one off "
                                     "its path or a plain version, or fell back")
            outs.append(files_of(out))
            if rep == 0:
                launches.update({k: used[k] for k in tk.KERNELS})
                launches.update({k: (launches.get(k, 0) if after_12 else 0) + used[k]
                                 for k in kn.KERNELS})
                path_by_inst = by_inst
        rows = outs[0]["params.csv"].decode().splitlines()
        log("[13] params.csv: " + " | ".join(rows))
        if len(rows) != 3 or not all(math.isfinite(float(v)) for row in rows[1:]
                                     for v in row.split(",")[3:]):
            raise AssertionError("params.csv rows")
        if not {"trained_0_1.model", "trained_0_2.model"} <= set(outs[0]):
            raise AssertionError(f"checkpoints missing: {sorted(outs[0])}")
        if outs[0] != outs[1]:
            raise AssertionError("a repeat run wrote different files")
        log(f"[13] repeat run: {len(outs[0])} files byte-identical")

        short_tsv = os.path.join(tmp, "short.tsv")
        write_tsv(short_tsv, short)
        jobs = list(readers.generate_tsv_jobs(short_tsv, rna=True))
        params = {}
        for prec in ("fp32", "fp64"):
            t = Trainer("resquiggle", "rna002", os.path.join(tmp, prec),
                        os.path.join(tmp, "run0", "trained_0_0.model"),
                        batch_size=len(jobs), precision=prec, device="cuda")
            t.process_batch(jobs, epoch=0)
            t.close()
            params[prec] = t.transition_params
        rel = max(abs(params["fp32"][p] / params["fp64"][p] - 1) for p in nb.TL_KEYS)
        log(f"[13] fp32 vs fp64 trainer on the 3 short reads: the 13 transitions within "
            f"rel {rel:.2e}")
        if rel > 1e-3:
            raise AssertionError("fp32 NTC trainer off the fp64 trainer")

    # the training step at (24, 16384): NTCBatchEngine.train as the trainer
    # runs it (host clock), then its stages on CUDA events
    items = [BatchItem(s, r) for s, r in bench[:TRAIN_BATCH]]
    eng = NTCBatchEngine(model, "rna002", device="cuda", transition_overrides=TRAIN_INIT_NTK,
                         batch_size=TRAIN_BATCH)
    eng.train(items)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        res = eng.train(items)
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if sum(isinstance(r, Exception) for r in res) or eng.profile["exact_retries"] > 1:
        raise AssertionError(f"training step: {eng.profile}")
    split = ntc_train_split(eng, items)
    step = sorted(walls)[len(walls) // 2]
    log(f"[13] training step ({TRAIN_BATCH}, 16384) fp32, median of {STEPS}: {step:.1f} ms = "
        f"{TRAIN_BATCH / (step / 1e3):.2f} reads/s (all ms {[round(w, 1) for w in walls]}) | "
        f"split: " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        + f" | peak device memory {peak:.2f} GiB | exact rung {eng.profile['exact_retries']} "
        f"reads in {STEPS + 1} steps")
    return path_by_inst


def table9(path: str):
    """A seeded synthetic 9-mer table of the real shape (K = 4^9 rows, means
    U(-2, 2), stdevs U(0.15, 0.4), as tests/test_9mer.py builds its tables;
    the rna004_9mer and DNA r10 tables are not in the repository), saved as
    an .npz model at `path` and loaded back as the CLI loads it."""
    import numpy as np

    from dynamont_tpu_torch.models.registry import load_model_for_pore

    rng = np.random.default_rng(9)
    np.savez(path, means=rng.uniform(-2.0, 2.0, K9), stdevs=rng.uniform(0.15, 0.4, K9),
             alphabet_size=4, kmer_size=9)
    return load_model_for_pore("rna004", path)


def phase_14(model, bench, lm, le) -> None:
    """Native 9-mer NTC (module docstring): (a) the checkpoint-recompute TK
    pre-pass against the dense K9/K10 route on phase 9's bucket; (b) the
    lattice kernels against their plain versions at K = 4^9 on short reads;
    (c) 16 reads of 1800 bases through the resquiggle CLI with
    --ntc-native-9mer, and the bucket's stages timed."""
    import torch

    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.models.ntc_batch import BIGK_WIDE_CAPS, NTCBatchEngine
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn
    from dynamont_tpu_torch.utils.synthetic import make_read

    # (a) phase 9's 5-mer bucket through both TK routes
    sig, _, _, T_r = pre_bucket(model, bench[:NTC_READS], 16384, 2048)
    means, _, c1, c2 = model_tensors(model)
    args = (sig, T_r, means, c1, c2, lm, le, model.alphabet_size, CK0, torch.float32)
    kn.reset_counts()
    dense, ms_dense = timed_once(lambda: nb.pre_tk_batch(*args))
    used = dict(kn.LAUNCHES)
    ckpt, ms_ckpt = timed_once(lambda: nb.pre_tk_batch_ckpt(*args, chunk=128))
    if used["ntc_tk_bwd"] != 1 or used["ntc_tk_fwd_u"] != 1 or kn.LAUNCHES != used:
        raise AssertionError(f"TK routes: launches {used} then {kn.LAUNCHES}")
    for f in ("cand", "cnt", "overflow", "Zf", "Zb"):
        same(f"pre_tk_batch_ckpt {f} against the dense route", getattr(ckpt, f),
             getattr(dense, f))
    log(f"[14a] ({NTC_READS}, 16384) K {model.num_kmers} CK0 {CK0} fp32: the checkpoint-"
        f"recompute TK pass bit for bit with K9 -> K10 (cand, cnt, overflow, Zf, Zb); "
        f"{ms_ckpt:.1f} ms against {ms_dense:.1f} ms")
    del sig, T_r, dense, ckpt
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="dynamont_9mer_") as tmp:
        npz = os.path.join(tmp, "rna9.npz")
        m9 = table9(npz)
        # (b) the lattice kernels at K = 4^9 on short reads
        short = [BatchItem(*make_read(m9, n_bases=n, seed=s)) for s, n in ((0, 25), (1, 31))]
        gidx = list(range(len(short)))
        for dtype in (torch.float32,):  # the native path's dtype (fp64: phase 11, 5-mer)
            t0 = time.perf_counter()
            eng9 = NTCBatchEngine(m9, "rna004", device="cuda", dtype=dtype, native_kmer=True,
                                  t_pad_to=64, n_pad_to=16)
            plain_ms = {}
            k = {}
            eng9._dispatch(gidx, short, CN, CK0, keep=k)
            walked = compare_lattice_kernels(k, plain_ms)
            kf, kc = {}, {}
            eng9._dispatch(gidx, short, *BIGK_WIDE_CAPS, keep=kf, ckpt=False)
            compare_lattice_kernels(kf, plain_ms)
            before = ckpt_counts()
            eng9._dispatch(gidx, short, *BIGK_WIDE_CAPS, keep=kc)
            inst = ckpt_launched(kc["dims"], kc["sig"].element_size(), before)
            compare_tab_gather(kc, plain_ms)
            compare_ckpt(kc, plain_ms)
            compare_walk(kc, plain_ms)
            same_routes(kc, kf)
            log(f"[14b] K {K9} bucket {(len(short), k['sig'].shape[1] + 1)} {dtype}: at "
                f"{k['dims']} K11, K13, K15, K16, at {kc['dims']} K11, K13, K14, K15 and its "
                f"checkpoint mode ({inst}), K16 every output bit for bit with their plain versions, "
                f"both routes equal; {walked}/{len(short)} reads walked "
                f"({time.perf_counter() - t0:.1f} s)")
            del k, kf, kc, eng9
            torch.cuda.empty_cache()
        # (c) the CLI on 16 reads of the phase-4 shape drawn from the table
        reads = []
        for s in range(NTC_READS):
            sg, rd = make_read(m9, n_bases=N_BASES, mean_dwell=MEAN_DWELL, seed=s)
            reads.append((sg[:T_TRIM], rd))
        phase_14_cli(m9, npz, reads, tmp)


@contextlib.contextmanager
def stage_events(targets):
    """Wrap each (module, attribute, label) function with CUDA events for
    the duration; yields the {label: [(start, end), ...]} it fills (the
    wrapped functions still count their launches)."""
    import torch

    events: dict = {}
    saved = []
    for mod, attr, label in targets:
        fn = getattr(mod, attr)

        def wrapped(*args, _fn=fn, _label=label, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = _fn(*args, **kw)
            ev[1].record()
            events.setdefault(_label, []).append(ev)
            return out

        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
    try:
        yield events
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def phase_14_cli(m9, npz: str, reads, tmp: str) -> None:
    """Phase 14(c): the resquiggle CLI with --ntc-native-9mer on `reads`,
    every launch counter reset right before and read right after, its
    bucket program's stages on CUDA events (stage_events)."""
    import torch

    from dynamont_tpu_torch.cli import resquiggle
    from dynamont_tpu_torch.models import ntc_batch as mb
    from dynamont_tpu_torch.ops import nt_banded_kernels as kk
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk

    plain_csv = zstd_stand_in()
    tsv, out = os.path.join(tmp, "reads9.tsv"), os.path.join(tmp, "out9.csv.zst")
    write_tsv(tsv, reads)
    stages = [(mb.nb, "pre_tn_batch", "TN pre-pass (K7, K8, selection)"),
              (mb, "_pre_tk", "TK checkpoint-recompute pass"),
              (mb.nb, "build_plan_batch", "plan"), (kern, "tab_gather", "K11"),
              (kern, "bwd", "K13"), (kern, "pv", "K15"), (kern, "bwd_ckpt", "K14"),
              (kern, "pv_ckpt", "K15 checkpoint mode"), (kern, "walk", "K16")]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    for mod in (kk, kn, kern, tk):
        mod.reset_counts()
    with stage_events(stages) as events:
        t0 = time.perf_counter()
        eng = resquiggle.main(["--tsv", tsv, "-o", out, "--mode", "resquiggle", "-p",
                               "rna004", "--model_path", npz, "--ntc-native-9mer",
                               "--device", "cuda", "--profile"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lat, pre = dict(kern.LAUNCHES), dict(kn.LAUNCHES)
    plain = {**kern.PLAIN_RUNS, **kn.PLAIN_RUNS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    pr = eng.profile
    log(f"[14c] CLI --mode resquiggle -p rna004 --ntc-native-9mer, K {eng.model.num_kmers}, "
        f"{len(reads)} reads of {N_BASES} bases, T {T_TRIM}: {wall:.2f} s wall = "
        f"{len(reads) / wall:.2f} reads/s | engine dispatch {pr['dispatch_s']:.3f} s, collect "
        f"{pr['collect_s']:.3f} s | wide retries {pr['wide_retries']} ({pr['wide_s']:.2f} s), "
        f"exact retries {pr['exact_retries']} ({pr['exact_s']:.2f} s) | launches {pre} {lat} | "
        f"plain {plain} | peak device memory {peak:.2f} GiB ({held:.2f} GiB held before)")
    split = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()}
    log(f"[14c] the CLI's bucket programs, stages on CUDA events (ms, summed over "
        f"{pr['buckets']} main and {pr['wide_retries']} wide-rung reads' buckets): "
        + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
    if (eng.model.num_kmers != K9 or pre["ntc_tk_bwd"] or pre["ntc_tk_fwd_u"]
            or not (pre["ntc_tn_fwd"] and pre["ntc_tn_bwd_sel"])
            or any(lat[k] == 0 for k in MAIN_RUNG) or any(plain.values())
            or any(kk.LAUNCHES.values()) or any(tk.LAUNCHES.values())):
        raise AssertionError("the native 9-mer path launched K9/K10, missed a kernel or ran "
                             "a plain version")
    errors = os.path.join(tmp, "out9.errors")
    err_lines = []
    if os.path.exists(errors):
        with open(errors) as f:
            err_lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if any("out of memory" in ln for ln in err_lines):
        raise AssertionError(f"out of memory: {err_lines[:3]}")
    rows = read_rows(out, plain_csv) if os.path.exists(out) else []
    per_read = {f"r{i}": 0 for i in range(len(reads))}
    for row in rows:
        per_read[row[0]] += 1
    failed = {ln.split("Rid: ")[1].split("\t")[0] for ln in err_lines if "Rid: " in ln}
    missing = [r for r, n in per_read.items() if n == 0 and r not in failed]
    log(f"[14c] {len(rows)} CSV rows, {sum(n > 0 for n in per_read.values())} reads segmented "
        f"(rows per read {min(per_read.values())}-{max(per_read.values())}), "
        f"{len(failed)} error lines" + "".join(f"; {ln[:160]}" for ln in err_lines[:3]))
    if missing:
        raise AssertionError(f"reads with neither rows nor an error line: {missing}")
    del eng
    torch.cuda.empty_cache()


def phase_15(model, bench, small, launches: dict, max_err: dict, by_path: dict) -> dict:
    """The matrix route, the stacked table gather and the single-read NT
    CLIs (module docstring). Sets banded_vit's launches and adds the matrix
    route's to banded_fwd's (by_path); returns ntc_table_gather's timing
    entry."""
    import numpy as np
    import torch

    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch.models.batch import T_PAD_TO, BandedBatchEngine, BatchItem
    from dynamont_tpu_torch.models.nt_banded import run_nt_banded
    from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
    from dynamont_tpu_torch.ops import nt_banded_batch as bb
    from dynamont_tpu_torch.ops import nt_banded_device as dv
    from dynamont_tpu_torch.ops import nt_banded_kernels as kk
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids

    # (a) the matrix route on the phase-4 reads, snapped to the wire grid
    items = []
    for sig, read in bench:
        dac, scale, offset = dv.quantize_signal(sig)
        items.append(BatchItem(dac.astype(np.float64) * scale + offset, read))
    eng = BandedBatchEngine(model, "rna002", device="cuda", batch_size=BATCH,
                            device_pipeline=False)
    eng.run(items[:BATCH])  # warm-up: allocator and first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kk.reset_counts()
    t0 = time.perf_counter()
    outs = eng.run(items)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    used, plain = dict(kk.LAUNCHES), dict(kk.PLAIN_RUNS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[15a] matrix route, {len(items)} reads (batch {BATCH}, fp32): {wall:.2f} s = "
        f"{len(items) / wall:.2f} reads/s | peak device memory {peak:.2f} GiB | fp64 retries "
        f"{eng.profile.get('z_retries', 0)} | launches {used} | plain {plain}")
    if (any(used[k] == 0 for k in kk.MATRIX_KERNELS) or used["banded_fwd_vit"]
            or used["banded_walk"] or any(plain.values())):
        raise AssertionError("the matrix route missed a kernel or ran another route")
    launches["banded_vit"] = used["banded_vit"]
    by_path["banded_fwd"]["matrix route (15a)"] = used["banded_fwd"]
    launches["banded_fwd"] = sum(by_path["banded_fwd"].values())
    # one bucket's split: the device program (CUDA events), then the host
    # (the posteriors and choices to the host, the native walk)
    its = items[:BATCH]
    kids = [seq_to_kmer_ids(it.read, model.kmer_size, model.alphabet_size) for it in its]
    batch = bb.prepare_batch([it.signal for it in its], kids, model, device="cuda",
                             dtype=torch.float32, t_pad_to=T_PAD_TO)
    res, dev_ms = timed_once(lambda: eng._run(batch))
    t0 = time.perf_counter()
    host = [x.cpu() for x in (res.PM, res.PE, res.choices)]
    t1 = time.perf_counter()
    bb.traceback_batch(res, batch.bstart.cpu().numpy(), batch.T.cpu().numpy(),
                       batch.N.cpu().numpy(), batch.bw.cpu().numpy(), model.kmer_size)
    t2 = time.perf_counter()
    log(f"[15a] one {(BATCH, batch.bstart.shape[1], batch.B)} bucket: device program "
        f"{dev_ms:.2f} ms (K5, K1, K4, posteriors), PM/PE/choices to the host "
        f"{(t1 - t0) * 1e3:.1f} ms ({nbytes(*host) / 1e9:.2f} GB), the same again and "
        f"the native walk {(t2 - t1) * 1e3:.1f} ms")
    del res, host, batch
    dev = BandedBatchEngine(model, "rna002", device="cuda", batch_size=BATCH).run(items)
    dp = 0.0
    for i, (m, d) in enumerate(zip(outs, dev)):
        if m.error is not None or d.error is not None or not m.segments:
            raise AssertionError(f"read {i}: {m.error} / {d.error}")
        if [x[1:3] for x in m.segments] != [x[1:3] for x in d.segments]:
            raise AssertionError(f"read {i}: borders differ between the routes")
        dp = max([dp] + [abs(x[3] - y[3]) for x, y in zip(m.segments, d.segments)])
    log(f"[15a] against the device route: borders identical on every read, probabilities "
        f"within {dp!r}")
    if dp > 2e-3:
        raise AssertionError("probabilities differ between the routes beyond 2e-3")
    del eng, outs, dev, items
    torch.cuda.empty_cache()

    # (b) #12 on phase 12's bucket, on K11's index rows
    with tempfile.TemporaryDirectory(prefix="dynamont_tg_") as tmp:
        tsv = os.path.join(tmp, "reads.tsv")
        write_tsv(tsv, bench[:NTC_READS])
        its = [BatchItem(job.signal, job.read)
               for job in readers.generate_tsv_jobs(tsv, True)]
    ntc = NTCBatchEngine(model, "rna002", device="cuda")
    k = {}
    ntc._dispatch(list(range(NTC_READS)), its, ntc.cap_n, ntc.cap_k, keep=k)
    ks, prm, (R, CN, CK, A) = k["ks"], k["prm"], k["dims"]
    T_pad, K = ks.shape[0], k["table"].shape[1]
    tabT = nb.combined_tablesT(ntc.tensors["means"], ntc.tensors["c1"], ntc.tensors["c2"], A)
    same("combined_tablesT", tabT[: nb.NTAB], k["table"])
    kern.reset_counts()
    out = kern.table_gather(ks, tabT)
    torch.cuda.synchronize()
    launches["ntc_table_gather"] = kern.LAUNCHES["ntc_table_gather"]
    if launches["ntc_table_gather"] != 1 or any(kern.PLAIN_RUNS.values()):
        raise AssertionError("ntc_table_gather did not launch")
    want, plain_ms = timed_once(lambda: kern.table_gather_plain(ks, tabT))
    same("ntc_table_gather", out, want)
    RCK = R * CK
    kpart = out[:, :, :RCK].reshape(T_pad, nb.TG_ROWS, R, CK)
    for f, row in (("mu_k", 0), ("c1_k", 1), ("c2_k", 2)):
        same(f"ntc_table_gather row {row} vs K11's {f}", kpart[:, row], getattr(prm, f))
    suc = (kpart[:, 3 : nb.NTAB].reshape(T_pad, 3, A, R, CK).permute(0, 1, 3, 2, 4)
           .reshape(T_pad, 3, R, A * CK))
    same("ntc_table_gather rows 3-14 vs K11's suc", suc, prm.suc)
    same("ntc_table_gather rows 0-2 vs K11's nsl", out[:, :3, RCK:], prm.nsl)
    max_err["ntc_table_gather"] = 0.0
    log(f"[15b] ntc_table_gather on ks {tuple(ks.shape)} (K = {K}): bit for bit its plain "
        "version and K11's mu/c1/c2, successor and n-slot parameters")
    ks64 = ks.clamp(0, K - 1).long()
    times = {"ntc_table_gather": timed(
        "ntc_table_gather", lambda: kern.table_gather(ks, tabT), plain_ms, [ks, tabT],
        ks.numel(), 3, library=lambda: tabT[:, ks64])}
    del ntc, k, ks, prm, out, want, kpart, suc, ks64
    torch.cuda.empty_cache()

    # (c) the single-read NT CLIs, cuda against cpu
    for i, (s, r) in enumerate(small):
        for mode, flags in (("segment", ()), ("calcZ", ("-z",)), ("train", ("--train",)),
                            ("prob", ("-p",))):
            for cli in ("nt_banded_main", "nt_main"):
                t0 = time.perf_counter()
                got, out_g = run_cli(s, r, "cuda", flags, cli)
                t1 = time.perf_counter()
                ref, out_w = run_cli(s, r, "cpu", flags, cli)
                if cli == "nt_banded_main":
                    if out_g != out_w:
                        bad = [(a, b) for a, b in zip(out_g.splitlines(), out_w.splitlines())
                               if a != b]
                        raise AssertionError(f"dynamont-NT-banded {mode}: stdout differs "
                                             f"from --device cpu: {str(bad)[:2000]}")
                    err = 0.0
                else:
                    err = ntc_agree(got, ref, "segment" if mode == "prob" else mode)
                    if mode == "prob":
                        g, w = got.per_t_logprob, ref.per_t_logprob
                        fin = np.isfinite(w)
                        d = np.abs(g[fin] - w[fin]).max()
                        if not np.array_equal(fin, np.isfinite(g)) or d > 1e-9:
                            raise AssertionError("dynamont-NT -p differs beyond 1e-9")
                        err = max(err, float(d))
                log(f"[15c] short read {i} {cli} {mode}: cuda {t1 - t0:.2f} s, cpu "
                    f"{time.perf_counter() - t1:.2f} s, stdout "
                    f"{'identical' if out_g == out_w else 'differs'}, max diff {err:.3g}")
    s, r = bench[0]
    T = len(s) + 1
    exact = run_nt_banded(s, r, model, "rna002", device="cuda")
    for cli in ("nt_banded_main", "nt_main"):
        t0 = time.perf_counter()
        got, out = run_cli(s, r, "cuda", ("-p",), cli)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        vals = got.per_t_logprob  # -inf where a row holds no live M cell (row 0, T-1)
        n_fin = int(np.isfinite(vals).sum())
        if len(vals) != T or not np.isneginf(vals[[0, -1]]).all() \
                or (np.isnan(vals) | (vals == np.inf)).any() or n_fin < T // 2:
            raise AssertionError(f"{cli} -p: {len(vals)} values ({n_fin} finite), want "
                                 f"T = {T}, -inf at rows 0 and T-1, no NaN or +inf")
        if len(out.splitlines()[1].split(",")) != T + 1:
            raise AssertionError(f"{cli} -p printed another count of values")
        if cli == "nt_banded_main" and got.segments != exact.segments:
            raise AssertionError("dynamont-NT-banded's segments differ from the exact rung's")
        log(f"[15c] long read ({len(r)} bases, T {T}) {cli} -p on cuda: {wall:.2f} s, "
            f"{len(got.segments)} segments, -p: {T} values, {n_fin} finite"
            + (", segments equal run_nt_banded's" if cli == "nt_banded_main" else ""))
    return times


def same_steps(label: str, inp, kw: dict, out) -> int:
    """Raise unless rows of a variant's full store `out` at its size equal,
    bit for bit, the plain column (ntc_probe_kernels.plain_rows) over the
    same rows started from the row the kernel stored just before them: the
    first two chunks visited, three in the middle and the last two. Each
    row is thus held to its plain version at long T and many chunks in,
    without the plain run over all T_pad rows. Returns the rows checked."""
    from dynamont_tpu_torch.ops import ntc_probe_kernels as pk

    T_pad, C = inp.sig.shape[1] + 1, kw["C"]
    order, nc = pk.row_order(T_pad, C, kw["reverse"]), T_pad // C
    n = 0
    for k in sorted({0, 1, nc // 3, nc // 2, 2 * nc // 3, nc - 2, nc - 1}):
        nxt = out[order[k * C - 1]] if k else None
        for t, row in pk.plain_rows(*inp, order[k * C:(k + 1) * C], nxt):
            same(f"{label} row {t}", out[t], row)
            n += 1
    return n


def phase_16(model, bench, launches: dict, max_err: dict) -> dict:
    """The probes of K13 (module docstring). Returns ntc_bwd_variant's and
    ntc_microop's timing entries."""
    import torch

    from dynamont_tpu_torch import probes
    from dynamont_tpu_torch.models.batch import BatchItem
    from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_probe_kernels as pk
    from dynamont_tpu_torch.probes import ntc_bwd_synth, ntc_bwd_variants, ntc_microops

    dev = torch.device("cuda")
    names = probes.ALL_VARIANTS
    # every variant and block against its plain version at a short size
    short = ntc_bwd_synth.synth_inputs(256, 1024, nb.PlanDims(2, CN, CN + CK0, 4), seed=16,
                                       device=dev)
    plain, ran = {}, []
    for name in names:
        kw = probes.variant_kwargs(name)
        if pk.smem_bytes(short.dims, kw["C"], kw["stage"]) > pk.SMEM_LIMIT:
            continue  # reported with its bytes by the runs below
        key = (kw["reverse"], 0 if kw["reverse"] else kw["C"], kw["store"])
        if key not in plain:
            plain[key] = timed_once(lambda: pk.bwd_variant_plain(*short, **kw))
        same(f"ntc_bwd_variant {name} at (2, 256)", pk.bwd_variant(*short, **kw), plain[key][0])
        ran.append(name)
    rev_kw = probes.variant_kwargs("rev")
    short_ms = cuda_ms(lambda: pk.bwd_variant(*short, **rev_kw), 3)
    plain_short_ms = plain[(True, 0, "full")][1]
    del plain, short
    micro_plain_ms, checked = 0.0, 0
    for block in pk.MICRO_BLOCKS:
        for kind in dict.fromkeys(("normal", pk.MICRO_KIND.get(block, "normal"))):
            x, aux = (torch.from_numpy(a).to(dev) for a in pk.micro_inputs(0, kind))
            want, ms = timed_once(lambda: pk.microop_plain(block, x, aux, 64))
            same(f"ntc_microop {block} ({kind} tiles) at ITERS 64", pk.microop(block, x, aux, 64),
                 want)
            micro_plain_ms += ms if kind == "normal" else 0.0
            checked += 1
    log(f"[16] at (2, 256): {', '.join(ran)} bit for bit with their plain versions; "
        f"{checked} microop runs at ITERS 64 bit for bit with theirs")

    # the references: K13 on the synthetic inputs (a), the engine's K13 on its bucket (b)
    dims = nb.PlanDims(NTC_READS, CN, CN + CK0, 4)
    ref_a = kern.bwd(*ntc_bwd_synth.synth_inputs(PROBE_T_PAD, 1024, dims, seed=0, device=dev))
    eng = NTCBatchEngine(model, "rna002", device=dev)
    k = {}
    eng._dispatch(list(range(NTC_READS)), [BatchItem(s, r) for s, r in bench[:NTC_READS]],
                  eng.cap_n, eng.cap_k, keep=k)
    ref_b = k["bwd"]
    for f in ("bwd", "lp", "choices", "slots", "rec"):
        del k[f]
    torch.cuda.empty_cache()
    matched, stepped = [], []

    def against(ref, label):
        def check(name, inp, out):
            kw = probes.variant_kwargs(name)
            if kw["reverse"]:
                same(f"ntc_bwd_variant {name} ({label}) against ntc_bwd", out,
                     ref if kw["store"] == "full" else ref[0])
                matched.append(f"{name} ({label})")
            if kw["store"] == "full":
                stepped.append(same_steps(f"ntc_bwd_variant {name} ({label})", inp, kw, out))
        return check

    pk.reset_counts()
    log("[16] (a) #19, synthetic inputs:")
    synth_ms = ntc_bwd_synth.run(PROBE_T_PAD, names + ("pv",), dev, against(ref_a, "synthetic"),
                                 lambda m: log(f"    {m}"))
    log("[16] (b) #20, the engine's bucket of the phase-9 reads:")
    real_ms = ntc_bwd_variants.run(T_TRIM, N_BASES, dev, check=against(ref_b, "real"),
                                   log=lambda m: log(f"    {m}"))
    log("[16] (c) #21, K13's building blocks on one (128, 128) tile:")
    micro = ntc_microops.run(MICRO_ITERS, dev, lambda m: log(f"    {m}"))
    torch.cuda.synchronize()
    used, plain_runs = dict(pk.LAUNCHES), dict(pk.PLAIN_RUNS)
    if any(v == 0 for v in used.values()) or any(plain_runs.values()):
        raise AssertionError(f"the probes missed a kernel or ran a plain version: {used} "
                             f"{plain_runs}")
    log(f"[16] launches {used}; bit for bit ntc_bwd: {', '.join(matched)}; "
        f"{len(stepped)} full stores, {sum(stepped)} rows in all, bit for bit with the "
        f"plain column from the row stored before them")
    del ref_a, ref_b
    log("[16] variant: synthetic | real ms (us per column step), the card of phase 1")
    steps = (PROBE_T_PAD, k["sig"].shape[1] + 1)
    for name in names:
        cells = [f"{d[name]:.3f} ({d[name] * 1e3 / n:.3f})" if name in d else "not run"
                 for d, n in zip((synth_ms, real_ms), steps)]
        log(f"    {name:7s} {cells[0]:>22s} | {cells[1]:>22s}")
    log(f"    pv (K15 on the prod store, synthetic) {synth_ms['pv']:.3f} ms")
    launches.update(used)
    max_err.update({n: 0.0 for n in pk.KERNELS})  # bit for bit, or a check raised

    p, prm, sig, N_r, T_r = k["plan"], k["prm"], k["sig"], k["N_r"], k["T_r"]
    bwd_in = [sig, p.cand_n, p.allowed, p.hd, p.d01, p.d02, p.brow_same, p.brow_next,
              p.bcol_same, p.bcol_suc, *prm, N_r, T_r]
    store = sig.shape[0] * (sig.shape[1] + 1) * 5 * CN * (CN + CK0) * 4
    b_ms, b_by = bound("ntc_bwd_variant", nbytes(*bwd_in) + store,
                       int(T_r.sum()) * CN * (CN + CK0))
    nb_ = len(pk.MICRO_BLOCKS)
    m_ms, m_by = bound("ntc_microop", 3 * pk.M_RC * pk.M_CK * 4 * nb_,
                       MICRO_ITERS * pk.M_RC * pk.M_CK * nb_)
    return {
        "ntc_bwd_variant": {
            "ms": real_ms["rev"], "plain_ms": plain_short_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "variant": "rev", "plain_at": [2, 256],
            "short_ms": short_ms, "pv_ms": synth_ms["pv"],
            "variants_ms": {n: {"synthetic": synth_ms.get(n), "real": real_ms.get(n)}
                            for n in names}},
        "ntc_microop": {
            "ms": sum(ms for ms, _ in micro.values()), "plain_ms": micro_plain_ms,
            "bound_ms": m_ms, "bound_by": m_by, "library_ms": None, "plain_iters": 64,
            "us_per_iter": {b: us for b, (_, us) in micro.items()}},
    }


def ntc_train_split(eng, items) -> dict:
    """ms of each stage of one training bucket as ntc_train_bucket_program
    runs it (CUDA events), and of the host post-processing (host clock)."""
    import torch

    from dynamont_tpu_torch.models import ntc_batch as mb
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk
    from dynamont_tpu_torch.utils.logmath import logsumexp

    T_arr, N_arr, sig, kid, _ = eng._pad_bucket(list(range(len(items))), items)
    sig, kid, N_r, T_r = (torch.from_numpy(a).cuda() for a in (sig, kid, N_arr, T_arr))
    sig = sig.to(eng.dtype)
    te, A, K = eng.tensors, eng.model.alphabet_size, eng.model.num_kmers
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    pn = nb.pre_tn_batch(sig, kid, N_r, T_r, te["means"], te["stdevs"], eng.log_ppm,
                         eng.log_ppe, eng.cap_n, eng.dtype)
    pk = nb.pre_tk_batch(sig, T_r, te["means"], te["c1"], te["c2"], eng.log_ppm,
                         eng.log_ppe, A, eng.cap_k, eng.dtype)
    ev[1].record()
    plan, dims = nb.build_plan_batch(pn.cand, pn.cnt, pk.cand, pk.cnt, kid, N_r, K, A,
                                     eng.model.kmer_size, pn.kn1, pn.kn2)
    prm = kern.tab_gather(nb.gather_index(plan), te["table"], dims)
    ev[2].record()
    fwd = tk.fwd_store(plan, dims, prm, sig, eng.trans_log)
    r = torch.arange(dims.R, device=sig.device)
    Zf = nb.ntc_zf_batch(plan, fwd[T_r.long() - 1, r, nb.E_ST], N_r, T_r)
    ev[3].record()
    tacc, em, b0 = tk.train(plan, dims, prm, sig, fwd, Zf, eng.trans_log, N_r, T_r, K)
    Zb = nb.ntc_zb_batch(plan, b0)
    term_lse = logsumexp(tacc.reshape(len(nb.TERMS), dims.R, -1), dim=2)
    ev[4].record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = [x.cpu().numpy() for x in (term_lse, em, Zf, Zb)]
    for j in range(dims.R):
        mb.trans_from_terms(host[0][:, j])
        mb.emissions_from_moments(host[1][j], eng.model)
    host_ms = (time.perf_counter() - t0) * 1e3
    names = ("pre-pass K7-K10", "plan + K11", "K17 + Zf", "K18 + Zb + term sums")
    out = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    out["host post-processing"] = host_ms
    return out


# a process of phase 17(c)/(d): the CLI module given first, run as
# `python -m` runs it (runpy), behind the CSV writer's zstandard stand-in;
# prints the kernels' launch counts on a line of its own when it succeeds
CHILD = r"""
import json, runpy, sys
import chip_smoke
chip_smoke.zstd_stand_in()
from dynamont_tpu_torch.ops import nt_banded_kernels as kk
mod = sys.argv[1]
sys.argv = [mod] + sys.argv[2:]
runpy.run_module(mod, run_name="__main__", alter_sys=True)
print("LAUNCHES " + json.dumps(dict(kk.LAUNCHES)), flush=True)
"""


def run_ranks(module: str, args: list, cwd: str, world: int = 2,
              timeout: float = 300.0) -> list:
    """`module` with `args` in `world` processes of CHILD at once, joined
    by --distributed over gloo on 127.0.0.1; returns each rank's (launch
    counts, wall seconds). Raises if a rank fails or outlasts timeout."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(world):
            env = {k: v for k, v in os.environ.items() if not k.startswith("DYNAMONT_")}
            env.update(PYTHONPATH=root, DYNAMONT_COORDINATOR=f"127.0.0.1:{port}",
                       DYNAMONT_NUM_PROCESSES=str(world), DYNAMONT_PROCESS_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CHILD, module, *args, "--distributed"], cwd=cwd,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        out = []
        for rank, pr in enumerate(procs):
            so, se = pr.communicate(timeout=timeout)
            if pr.returncode != 0:
                raise AssertionError(f"rank {rank} of {module} exited {pr.returncode}: "
                                     f"{se[-3000:]}")
            counts = [ln for ln in so.splitlines() if ln.startswith("LAUNCHES ")]
            out.append((json.loads(counts[-1][9:]), time.perf_counter() - t0))
        return out
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()


def basic_bucket_shapes(jobs, batch_size: int) -> list:
    """(t_pad, B, N_max) of the bucket each job lands in when the banded
    engine of `resquiggle --mode basic` (its defaults: float32, band 400,
    the device route) runs `jobs` as one chunk: the engine's own packing,
    the wire's B and N_max."""
    from dynamont_tpu_torch.models.batch import T_PAD_TO, BandedBatchEngine
    from dynamont_tpu_torch.models.packing import round_up, t_pad_ladder
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.ops.nt_banded_device import band_width
    from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids

    eng = BandedBatchEngine(load_model_for_pore("rna002"), "rna002", device="cpu",
                            batch_size=batch_size)
    shapes = [None] * len(jobs)
    for group in eng._buckets(jobs):
        N = [len(seq_to_kmer_ids(jobs[i].read, 5, 4)) + 1 for i in group]
        shape = (t_pad_ladder(max(len(jobs[i].signal) for i in group) + 1, T_PAD_TO),
                 max(band_width(eng.band, n) for n in N), round_up(max(N), 128))
        for i in group:
            shapes[i] = shape
    return shapes


def numbers_apart(a: bytes, b: bytes) -> float:
    """The largest relative difference between the numeric fields of two
    text files of the same layout (inf if the layouts differ)."""
    la, lb = a.decode().split(), b.decode().split()
    if len(la) != len(lb):
        return math.inf
    worst = 0.0
    for x, y in zip(la, lb):
        fx = [f for f in x.split(",")]
        fy = [f for f in y.split(",")]
        if len(fx) != len(fy):
            return math.inf
        for u, v in zip(fx, fy):
            if u == v:
                continue
            try:
                fu, fv = float(u), float(v)
            except ValueError:
                return math.inf
            worst = max(worst, abs(fu - fv) / max(abs(fu), abs(fv), 1e-300))
    return worst


def phase_17(model, bench) -> None:
    """Several devices and processes on the one card (module docstring):
    the round-robin engines, the device Hampel, the two-process
    resquiggle and training CLIs, the sharded NTC step."""
    import numpy as np
    import torch

    from dynamont_tpu_torch.cli import resquiggle
    from dynamont_tpu_torch.cli import train as train_cli
    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch.models.batch import BandedBatchEngine, BatchItem
    from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine, ntc_train_bucket_program
    from dynamont_tpu_torch.models.params import params_from_numpy
    from dynamont_tpu_torch.ops import nt_banded_device as dv
    from dynamont_tpu_torch.ops import nt_banded_kernels as kk
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk
    from dynamont_tpu_torch.parallel import ntc_step
    from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids

    mods = (kk, kn, kern, tk)
    two = [torch.device("cuda", 0)] * 2
    one = [torch.device("cuda", 0)]

    def reset():
        torch.cuda.synchronize()
        for mod in mods:
            mod.reset_counts()

    def counts():
        torch.cuda.synchronize()
        used = {k: v for mod in mods for k, v in mod.LAUNCHES.items() if v}
        plain = {k: v for mod in mods for k, v in mod.PLAIN_RUNS.items() if v}
        return used, plain

    def expect(label, used, plain, kernels, n):
        log(f"[17] {label}: launches {used} | plain {plain}")
        if plain or any(used.get(k, 0) != n for k in kernels) or set(used) - set(kernels):
            raise AssertionError(f"{label}: expected {kernels} {n} times each, no plain run")

    def key(o):
        summ = None if o.summaries is None else tuple(
            np.asarray(x).tobytes() if hasattr(x, "shape") else x for x in o.summaries)
        segs = None if o._segments is None else tuple(map(tuple, o._segments))
        return o.error, segs, summ, o.Z

    # (a) the round-robin engines
    items = [BatchItem(s, r) for s, r in bench[:8]]
    ref = BandedBatchEngine(model, "rna002", devices=one, batch_size=4).run(items)
    eng = BandedBatchEngine(model, "rna002", devices=two, batch_size=4)
    reset()
    got = eng.run(items)
    expect("17(a) banded [cuda:0, cuda:0]", *counts(), kk.SEGMENT_KERNELS, 2)
    if eng.profile["device_buckets"] != [1, 1]:
        raise AssertionError(f"buckets by device {eng.profile['device_buckets']}")
    if any(o.error for o in got) or [key(o) for o in got] != [key(o) for o in ref]:
        raise AssertionError("the banded engine on [cuda:0, cuda:0] differs from [cuda:0]")
    log("[17] (a) BandedBatchEngine, 8 reads in buckets of 4 on [cuda:0, cuda:0]: "
        "outputs identical to [cuda:0]")
    items = [BatchItem(s, r) for s, r in bench[:4]]
    kw = dict(batch_size=2, fallback=False)
    ref = NTCBatchEngine(model, "rna002", devices=one, **kw).run(items)
    eng = NTCBatchEngine(model, "rna002", devices=two, **kw)
    reset()
    got = eng.run(items)
    expect("17(a) NTC [cuda:0, cuda:0]", *counts(),
           (*kn.KERNELS, "ntc_tab_gather", "ntc_bwd", "ntc_pv", "ntc_walk"), 2)
    if eng.profile["device_buckets"] != [1, 1]:
        raise AssertionError(f"buckets by device {eng.profile['device_buckets']}")
    if [key(o) for o in got] != [key(o) for o in ref]:
        raise AssertionError("the NTC engine on [cuda:0, cuda:0] differs from [cuda:0]")
    log(f"[17] (a) NTCBatchEngine, 4 reads in buckets of 2 on [cuda:0, cuda:0]: outputs "
        f"identical to [cuda:0] ({sum(o.error is None for o in got)} of 4 segmented, the "
        "rest the same no-fallback error)")
    torch.cuda.empty_cache()

    # (b) the device Hampel
    rng = np.random.default_rng(17)
    spiky = []
    for s, r in bench[:4]:
        s = s.copy()
        s[rng.integers(1, len(s) - 3, 40)] += 8.0
        spiky.append((s, r))
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size) for _, r in spiky]
    decoded = []
    for dev in ("cuda", "cpu"):
        wire = dv.prepare_wire([s for s, _ in spiky], kids, device=dev, t_pad=16384)
        p = params_from_numpy(model, 0.03, 0.97, device=dev, dtype=torch.float32)
        decoded.append([x.cpu() for x in dv.decode(wire, p.means, p.c1, p.c2,
                                                   torch.float32, hampel=True)[:5]])
        if dev == "cuda":
            raw = dv.decode(wire, p.means, p.c1, p.c2, torch.float32).sig.cpu()
    for name, a, b in zip(("sig", "mu_pad", "c1_pad", "c2_pad", "bstart"), *decoded):
        if not torch.equal(a.view(torch.uint8) if a.is_floating_point() else a,
                           b.view(torch.uint8) if b.is_floating_point() else b):
            raise AssertionError(f"device Hampel decode: {name} differs from the CPU's")
    n_filtered = int((decoded[0][0] != raw).sum())
    on = BandedBatchEngine(model, "rna002", device="cuda", hampel_on_device=True)
    off = BandedBatchEngine(model, "rna002", device="cuda")
    its = [BatchItem(s, r) for s, r in spiky]
    got_on, got_off = on.run(its), off.run(its)
    if any(o.error for o in got_on):
        raise AssertionError("the engine with the device Hampel failed a read")
    log(f"[17] (b) device Hampel on a (4, 16384) bucket: decode bit for bit the CPU's, "
        f"{n_filtered} samples replaced; engine with hampel_on_device: {len(got_on)} reads "
        f"segmented, {sum(key(a) != key(b) for a, b in zip(got_on, got_off))} differ from "
        "the unfiltered run")

    plain_csv = zstd_stand_in()
    with tempfile.TemporaryDirectory(prefix="dynamont_multi_") as tmp:
        # (c) the two-process resquiggle CLI
        tsv = os.path.join(tmp, "reads.tsv")
        write_tsv(tsv, bench[:16])
        args = ["--tsv", tsv, "--mode", "basic", "-p", "rna002", "--device", "cuda"]
        one_out = os.path.join(tmp, "one.csv.zst")
        reset()
        t0 = time.perf_counter()
        resquiggle.main(args + ["-o", one_out])
        one_wall = time.perf_counter() - t0
        expect("17(c) resquiggle, one process", *counts(), kk.SEGMENT_KERNELS, 1)
        two_out = os.path.join(tmp, "two.csv.zst")
        ranks = run_ranks("dynamont_tpu_torch.cli.resquiggle", args + ["-o", two_out], tmp)
        for rank, (used, wall) in enumerate(ranks):
            log(f"[17] (c) rank {rank}: launches {used}, done {wall:.2f} s after the start")
            if any(used.get(k, 0) < 1 for k in kk.SEGMENT_KERNELS):
                raise AssertionError(f"rank {rank} missed a segmentation kernel")
        jobs = list(readers.generate_tsv_jobs(tsv, True))
        shapes_one = basic_bucket_shapes(jobs, 32)
        shapes_rank = [basic_bucket_shapes(jobs[k::2], 32) for k in range(2)]
        rows_one = {}
        for row in read_rows(one_out, plain_csv):
            rows_one.setdefault(row[0], []).append(row)
        same = near = 0
        worst = 0.0
        for k in range(2):
            rows = {}
            for row in read_rows(f"{two_out}.rank{k}", plain_csv):
                rows.setdefault(row[0], []).append(row)
            if sorted(rows) != sorted(j.readid for j in jobs[k::2]):
                raise AssertionError(f"rank {k} wrote reads {sorted(rows)}")
            for j, job in enumerate(jobs[k::2]):
                g, w = rows[job.readid], rows_one[job.readid]
                if shapes_rank[k][j] == shapes_one[2 * j + k]:
                    if g != w:
                        raise AssertionError(f"{job.readid}: rows differ in the same bucket shape")
                    same += 1
                    continue
                if [r[:8] + r[9:] for r in g] != [r[:8] + r[9:] for r in w]:
                    raise AssertionError(f"{job.readid}: borders differ")
                d = max(abs(float(a[8]) - float(b[8])) for a, b in zip(g, w))
                worst = max(worst, d)
                if d > 2e-3:
                    raise AssertionError(f"{job.readid}: probabilities off by {d}")
                near += 1
        log(f"[17] (c) resquiggle --mode basic, 16 reads: one process {one_wall:.2f} s; two "
            f"processes sharing the card {max(w for _, w in ranks):.2f} s (start to the last "
            f"rank's end); the union of .rank0/.rank1 is the one-process CSV: {same} reads "
            f"byte for byte in the same bucket shape, {near} in another shape with borders "
            f"identical (probabilities within {worst:.2e})")

        # (d) the two-process training CLI
        tsv = os.path.join(tmp, "train.tsv")
        write_tsv(tsv, bench[:TRAIN_BATCH])
        args = ["--tsv", tsv, "-p", "rna002", "--mode", "basic", "-q", "0",
                "--batch_size", str(TRAIN_BATCH), "--max_batches", "1",
                "--precision", "fp32", "--device", "cuda"]
        out1 = os.path.join(tmp, "train1")
        reset()
        t0 = time.perf_counter()
        train_cli.main(args + ["-o", out1])
        one_wall = time.perf_counter() - t0
        expect("17(d) train, one process", *counts(), kk.TRAIN_KERNELS, 2)
        out2 = os.path.join(tmp, "train2")
        ranks = run_ranks("dynamont_tpu_torch.cli.train", args + ["-o", out2], tmp)
        for rank, (used, wall) in enumerate(ranks):
            log(f"[17] (d) rank {rank}: launches {used}, done {wall:.2f} s after the start")
            if any(used.get(k, 0) != 2 for k in kk.TRAIN_KERNELS):
                raise AssertionError(f"rank {rank} did not run K5 -> K6 on its share")
        f1, f2 = files_of(out1), files_of(out2)
        if sorted(f1) != sorted(f2):
            raise AssertionError(f"files {sorted(f1)} against {sorted(f2)}")
        p1, p2 = (f["params.csv"].decode().splitlines() for f in (f1, f2))
        log("[17] (d) params.csv one process: " + " | ".join(p1))
        log("[17] (d) params.csv two processes: " + " | ".join(p2))
        if f1 == f2:
            log(f"[17] (d) dynamont-train --mode basic, {TRAIN_BATCH} reads: one process "
                f"{one_wall:.2f} s, two {max(w for _, w in ranks):.2f} s; all "
                f"{len(f1)} files byte-identical")
        else:
            r1, r2 = p1[1].split(","), p2[1].split(",")
            rel = max(numbers_apart(f1[n], f2[n]) for n in f1 if n != "params.csv")
            rel = max(rel, numbers_apart(",".join(r1[3:-1]).encode(),
                                         ",".join(r2[3:-1]).encode()))
            dz = abs(float(r1[-1]) - float(r2[-1]))
            log(f"[17] (d) dynamont-train --mode basic, {TRAIN_BATCH} reads: one process "
                f"{one_wall:.2f} s, two {max(w for _, w in ranks):.2f} s; files differ: "
                f"largest relative difference {rel:.2e}, Zchange {dz:.3e} apart")
            if p1[0] != p2[0] or r1[:3] != r2[:3] or rel > 1e-5 or dz > 0.1:
                raise AssertionError("two-process training off the one-process run")

    # (e) the sharded NTC step against the one-device training program
    reads = bench[:32]
    shard = ntc_step.prepare_ntc_shard(reads, model, two)
    step = ntc_step.make_ntc_sharded_train_step(two, model, "rna002")
    reset()
    t0 = time.perf_counter()
    res = step(shard)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    expect("17(e) sharded NTC step", *counts(), (*kn.KERNELS, "ntc_tab_gather", *tk.KERNELS), 2)
    eng = NTCBatchEngine(model, "rna002", device="cuda")
    T_arr, N_arr, sig, kid, _ = eng._pad_bucket(list(range(32)),
                                                [BatchItem(s, r) for s, r in reads])
    for name, whole in (("sig", sig), ("kid", kid)):
        parts = np.concatenate([getattr(q, name).cpu().numpy() for q in shard.parts])
        if not np.array_equal(parts, whole):
            raise AssertionError(f"the shares' {name} is not the engine's padded bucket")
    put = lambda a: torch.from_numpy(a).cuda()
    t0 = time.perf_counter()
    want = ntc_train_bucket_program(
        put(sig), put(kid), put(N_arr), put(T_arr), eng.tensors, A=model.alphabet_size,
        S=model.kmer_size, log_ppm=eng.log_ppm, log_ppe=eng.log_ppe, trans_log=eng.trans_log,
        CN=eng.cap_n, CK0=eng.cap_k, dtype=torch.float32)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    for k in ("Zf", "Zb", "term_lse", "em"):
        a, b = res[k].cpu(), want[k].cpu()
        if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            raise AssertionError(f"sharded NTC step: {k} differs from the one-device program")
    ok1, pooled1 = ntc_step.bucket_sums(want, put(T_arr), put(N_arr), eng.tensors["means"],
                                        (eng.cap_n, eng.cap_k), torch.float32)
    if not torch.equal(res["ok"].cpu(), ok1.cpu()):
        raise AssertionError("sharded NTC step: the gate differs")
    rel = 0.0
    for name, a, b in zip(ntc_step.NTCPooled._fields, res["pooled"], pooled1):
        a, b = a.double().cpu(), b.double().cpu()
        rel = max(rel, float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()))
    if rel > 1e-5:
        raise AssertionError(f"sharded NTC step: pooled sums off by rel {rel}")
    log(f"[17] (e) make_ntc_sharded_train_step([cuda:0, cuda:0]), 32 reads in two shares "
        f"of 16: {step_ms:.1f} ms against the one-device 32-read program's {one_ms:.1f} ms "
        f"(host clock); Zf, Zb, term sums and moments of every read bit for bit, "
        f"{int(res['ok'].sum())} of 32 pass the gate as there, pooled sums within rel "
        f"{rel:.2e}")
    del res, want
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description="smoke run of the port on one GPU")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run after 1-2 (default: all)")
    args = ap.parse_args(argv)
    chosen = None if args.phases is None else set(args.phases.split(","))
    want = lambda n: chosen is None or n in chosen
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamont_tpu_torch.constants import NT_TRANSITIONS
    from dynamont_tpu_torch.io.output import format_segments_csv
    from dynamont_tpu_torch.models.packing import t_pad_ladder
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.native import summaries_csv_native
    from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids
    from dynamont_tpu_torch.utils.synthetic import make_read
    from dynamont_tpu_torch.io import readers
    from dynamont_tpu_torch import _build
    from dynamont_tpu_torch.cli import train as train_cli
    from dynamont_tpu_torch.models.batch import BandedBatchEngine, BatchItem
    from dynamont_tpu_torch.models.nt_banded import run_nt_banded
    from dynamont_tpu_torch.models.params import params_from_numpy
    from dynamont_tpu_torch.ops import nt_banded_batch as bb
    from dynamont_tpu_torch.ops import nt_banded_device as dv
    from dynamont_tpu_torch.ops import nt_banded_kernels as kk
    from dynamont_tpu_torch.ops import nt_banded_train as nt
    from dynamont_tpu_torch.training.trainer import T_PAD_TO, Trainer

    phase = Phases()
    # 1. the card
    phase.start("1")
    kind = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"[1] device {kind} x{torch.cuda.device_count()} | torch "
        f"{torch.__version__} | CUDA {torch.version.cuda} | nvcc {nvcc} | "
        f"python {sys.version.split()[0]}")
    log(card)

    # 2. a fresh build from the checkout's sources
    phase.start("2")
    lib_path = _build.library_path()
    if os.path.exists(lib_path):
        os.remove(lib_path)
    _build.load()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    log(f"[2] nvcc build {_build.build_seconds:.1f} s -> {lib_path}")
    for ln in ptxas:
        log(f"    {ln}")

    model = load_model_for_pore("rna002")
    m1, e2 = NT_TRANSITIONS["rna002"]["m1"], NT_TRANSITIONS["rna002"]["e2"]
    lm, le = math.log(m1), math.log(e2)

    def bucket(reads, dtype):
        """The main path's decoded bucket for (signal, read) pairs, padded
        as the engine pads it."""
        kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size)
                for _, r in reads]
        t_pad = t_pad_ladder(max(len(s) for s, _ in reads) + 1, 512)
        wire = dv.prepare_wire([s for s, _ in reads], kids, device="cuda",
                               t_pad=t_pad)
        p = params_from_numpy(model, m1, e2, device="cuda", dtype=dtype)
        return dv.decode(wire, p.means, p.c1, p.c2, dtype), wire.N_max

    small = [make_read(model, n_bases=40 + 10 * s, seed=s) for s in range(3)]
    bench = []
    for s in range(N_READS):
        sig, read = make_read(model, n_bases=N_BASES, mean_dwell=MEAN_DWELL, seed=s)
        bench.append((sig[:T_TRIM], read))
    kids_of = lambda reads: [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size)
                             for _, r in reads]
    max_err, launches, times = {}, {}, {}
    by_instance = {}  # K17's and K18's launches by instance (phase 13)
    by_path = {"banded_fwd": {}}  # K5's launches by path (phases 7, 15(a))

    # 3. kernels against their plain versions
    phase.start("3")
    if want("3"):
        for dtype in (torch.float32, torch.float64):
            # fp32 at full width: phase 5, on its plain runs
            for reads in (small,) if dtype == torch.float32 else (small, bench[:2]):
                b, nmax = bucket(reads, dtype)
                shape = (b.sig.shape[0], b.bstart.shape[1], b.B)
                errs = compare_kernels(b, nmax, lm, le)
                compare_vit(b, lm, le)
                errs["banded_vit"] = 0.0  # bit for bit, or compare_vit raised
                log(f"[3] bucket {shape} {dtype}: max abs err {errs}")
                del b
            if dtype == torch.float32:
                max_err.update(errs)
            torch.cuda.empty_cache()
        if shape != (2, 16384, 512):
            raise AssertionError(f"production bucket shape {shape}")

    # 4. the main path
    phase.start("4")
    if want("4"):
        items = [BatchItem(sig, read) for sig, read in bench]
        eng = BandedBatchEngine(model, "rna002", device="cuda", batch_size=BATCH)
        eng.run(items[:BATCH])  # warm-up: allocator and first launches
        torch.cuda.synchronize()
        prof0 = dict(eng.profile)
        kk.reset_counts()
        walls = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            outs = eng.run(items)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        plain_runs = dict(kk.PLAIN_RUNS)
        launches.update(kk.LAUNCHES)
        rates = sorted(len(items) / w for w in walls)
        per_run = lambda k: (eng.profile[k] - prof0[k]) / RUNS
        log(f"[4] {len(items)} reads x {RUNS} runs: reads/s median {rates[RUNS // 2]:.2f} "
            f"(min {rates[0]:.2f}, max {rates[-1]:.2f}; all {[round(r, 2) for r in rates]}) | "
            f"per run: {per_run('buckets'):.0f} buckets, host dispatch "
            f"{per_run('dispatch_s') * 1e3:.1f} ms, wait+collect "
            f"{per_run('collect_s') * 1e3:.1f} ms | fp64 retries "
            f"{eng.profile.get('z_retries', 0)} | launches {launches} | plain {plain_runs}")
        if any(launches[k] == 0 for k in kk.SEGMENT_KERNELS) or any(plain_runs.values()):
            raise AssertionError(f"main path missed a kernel: {launches} {plain_runs}")
        n_rows = 0
        for o, (sig, read) in zip(outs, bench):
            if o.error is not None:
                raise AssertionError(f"read failed: {o.error}")
            starts, med, N, ks = o.summaries
            data = summaries_csv_native("r,s,", starts, med, N, read, ks, True, 0, len(sig))
            if data is None:  # no native library: the byte-identical Python formatter
                data = format_segments_csv("r", "s", o.segments, 0, len(sig), read,
                                           model.kmer_size, True)
            rows = data.decode().strip().split("\n")
            probs = [float(r.split(",")[8]) for r in rows]
            if len(rows) < 0.5 * N_BASES or not all(0.0 <= p <= 1.0 for p in probs):
                raise AssertionError(f"read yields {len(rows)} CSV rows")
            n_rows += len(rows)
        log(f"[4] {n_rows} CSV rows from {len(outs)} reads")
        check = []
        for s in range(3):  # snapped to the wire's int16 grid, so both see one signal
            sig, read = make_read(model, n_bases=60, seed=100 + s)
            dac, scale, offset = dv.quantize_signal(sig)
            check.append(BatchItem(dac.astype(np.float64) * scale + offset, read))
        for it, got in zip(check, eng.run(check)):
            ref = run_nt_banded(it.signal, it.read, model, "rna002", device="cuda")
            if [s[1:3] for s in got.segments] != [s[1:3] for s in ref.segments]:
                raise AssertionError("fp32 borders differ from the fp64 rung")
            dp = max(abs(x[3] - y[3]) for x, y in zip(got.segments, ref.segments))
            if dp > 2e-3:
                raise AssertionError(f"fp32 probability off the fp64 rung by {dp}")
        log("[4] short reads: fp32 borders identical to the fp64 rung, probabilities within 2e-3")

    # 5. kernel and plain-version times at each path's bucket shape
    phase.start("5")
    if want("5"):
        main_b, nmax = bucket(bench[:BATCH], torch.float32)
        log(f"[5] timing bucket {(main_b.sig.shape[0], main_b.bstart.shape[1], main_b.B)}")
        r = torch.arange(BATCH, device="cuda")
        bM, bE = kk.backward(main_b, lm, le)
        Zb = bE[r, 0, main_b.bw.long() + 1]
        ch, LPM, LPE, _ = kk.fwd_vit(main_b, bM, bE, Zb, lm, le)
        fields = lambda b: list(b[:8])   # the tensors of a BandedBatch
        cells = lambda b: int(b.T.sum()) * b.B
        train_b = bb.prepare_batch([s for s, _ in bench[:TRAIN_BATCH]], kids_of(bench[:TRAIN_BATCH]),
                                   model, device="cuda", dtype=torch.float32,
                                   t_pad_to=T_PAD_TO)
        if (train_b.sig.shape[0], train_b.bstart.shape[1], train_b.B) != (TRAIN_BATCH, 16384, 512):
            raise AssertionError("training bucket shape")
        # each kernel against its plain version here (fp32 at full width),
        # the plain runs timed
        plain_ms = {}
        errs = compare_kernels(main_b, nmax, lm, le, plain_ms)
        log(f"[5] bucket {(BATCH, 16384, 512)} fp32: max abs err {errs}")
        max_err.update(errs)
        errs = compare_train_kernels(train_b, lm, le, plain_ms)
        log(f"[5] bucket {(TRAIN_BATCH, 16384, 512)} fp32: bitwise equal, max abs err {errs}")
        max_err.update(errs)
        fM, fE = kk.forward(train_b, lm, le)
        del fM
        # the walk reads LPM, LPE, ch and bstart at one cell of each row
        walk_reads = int(main_b.T.sum()) * (2 * 4 + 1 + 4)
        runs = {
            "banded_bwd": (lambda: kk.backward(main_b, lm, le),
                           fields(main_b), cells(main_b), 0),
            "banded_fwd_vit": (lambda: kk.fwd_vit(main_b, bM, bE, Zb, lm, le),
                               fields(main_b) + [bM, bE, Zb], cells(main_b), 0),
            "banded_walk": (lambda: kk.walk(LPM, LPE, ch, main_b, nmax),
                            [main_b.T, main_b.N, main_b.bw], int(main_b.T.sum()), walk_reads),
            "banded_fwd": (lambda: kk.forward(train_b, lm, le),
                           fields(train_b), cells(train_b), 0),
            "banded_bwd_train": (lambda: kk.backward_train(train_b, fE, lm, le),
                                 fields(train_b) + [fE], cells(train_b), 0),
        }
        for name, (kern, inputs, units, extra) in runs.items():
            times[name] = timed(name, kern, plain_ms[name], inputs, units, 3, extra)
        st = kk.staging(main_b.B, main_b.sig.element_size())
        times["banded_bwd"]["design"] = (f"staged: chunks of {st.bwd_rows} rows, "
                                         f"{st.bwd_bytes} B of shared memory")
        times["banded_fwd_vit"]["design"] = (f"staged: chunks of {st.fwd_vit_rows} rows, "
                                             f"{st.fwd_vit_bytes} B of shared memory")
        tst = kk.train_staging(train_b.B, train_b.sig.element_size())
        times["banded_fwd"]["design"] = (f"staged: chunks of {tst.fwd_rows} rows, "
                                         f"{tst.fwd_bytes} B of shared memory")
        times["banded_bwd_train"]["design"] = (
            f"staged with its fE rows: chunks of {tst.bwd_train_rows} rows, "
            f"{tst.bwd_train_bytes} B of shared memory; one exp a numerator fold")
        # the matrix route's K4 over K5's and K1's rows of the same bucket:
        # against its plain version, then against K2's (ch, LPM, LPE)
        vfM, vfE = kk.forward(main_b, lm, le)
        vit_rows = (vfM, vfE, bM, bE, Zb)
        vit = compare_vit(main_b, lm, le, plain_ms, vit_rows, check_run=False)
        max_err["banded_vit"] = 0.0
        n_ch = int((vit[0] != ch).sum())
        d_lp = max(max_diff(vit[1], LPM), max_diff(vit[2], LPE))
        log(f"[5] K5 -> K1 -> K4 against K2 on {(BATCH, 16384, 512)} fp32: "
            + ("ch, LPM, LPE bit for bit" if n_ch == 0 and d_lp == 0.0 else
               f"{n_ch} choice bits differ, LPM/LPE off by up to {d_lp!r}"))
        del vit
        times["banded_vit"] = timed(
            "banded_vit", lambda: kk.viterbi_post(main_b, *vit_rows), plain_ms["banded_vit"],
            [*vit_rows, main_b.bstart, main_b.T, main_b.N, main_b.bw], cells(main_b), 3)
        times["banded_vit"]["design"] = (
            f"staged: chunks of {st.vit_rows} rows of fM/fE/bM/bE moved by bulk copies, "
            f"{st.vit_bytes} B of shared memory; a chunk's posteriors formed there and "
            "stored by bulk copies; two columns a thread")
        del main_b, bM, bE, ch, LPM, LPE, fE, train_b, runs, vit_rows, vfM, vfE
        torch.cuda.empty_cache()

    # 6. the training kernels against their plain versions
    phase.start("6")
    if want("6"):
        for dtype in (torch.float32, torch.float64):
            # fp32 at full width: phase 5, on its plain runs
            for reads in (small,) if dtype == torch.float32 else (small, bench[:2]):
                b = bb.prepare_batch([s for s, _ in reads], kids_of(reads), model,
                                     device="cuda", dtype=dtype, t_pad_to=T_PAD_TO)
                errs = compare_train_kernels(b, lm, le)
                log(f"[6] bucket {(b.sig.shape[0], b.bstart.shape[1], b.B)} {dtype}: "
                    f"bitwise equal, max abs err {errs}")
                del b
            if dtype == torch.float32:
                max_err.update(errs)
        torch.cuda.empty_cache()

    # 7. the training path through the CLI
    phase.start("7")
    if want("7"):
        with tempfile.TemporaryDirectory(prefix="dynamont_train_") as tmp:
            tsv = os.path.join(tmp, "train.tsv")
            write_tsv(tsv, bench[:TRAIN_READS])
            args = ["--tsv", tsv, "-p", "rna002", "--mode", "basic", "-q", "0",
                    "--batch_size", str(TRAIN_BATCH), "--max_batches", "2",
                    "--precision", "fp32", "--device", "cuda"]
            outs = []
            for rep in range(2):
                out = os.path.join(tmp, f"run{rep}")
                kk.reset_counts()
                t0 = time.perf_counter()
                trainer = train_cli.main(args + ["-o", out])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                train_launches, train_plain = dict(kk.LAUNCHES), dict(kk.PLAIN_RUNS)
                log(f"[7] CLI run {rep}: {TRAIN_READS} reads in {wall:.2f} s | launches "
                    f"{train_launches} | plain {train_plain} | fp64 rung {trainer.fp64_reads}")
                if (train_launches["banded_fwd"] < 4 or train_launches["banded_bwd_train"] < 4
                        or any(train_plain.values()) or trainer.fp64_reads):
                    raise AssertionError("training path missed a kernel or fell back")
                outs.append(files_of(out))
                if rep == 0:
                    launches.update({k: train_launches[k] for k in kk.TRAIN_KERNELS})
                    by_path["banded_fwd"]["training (7)"] = train_launches["banded_fwd"]
            rows = outs[0]["params.csv"].decode().splitlines()
            log("[7] params.csv: " + " | ".join(rows))
            if len(rows) != 3 or not all(math.isfinite(float(v)) for row in rows[1:]
                                         for v in row.split(",")[4:7]):
                raise AssertionError("params.csv rows")
            if not {"trained_0_1.model", "trained_0_2.model"} <= set(outs[0]):
                raise AssertionError(f"checkpoints missing: {sorted(outs[0])}")
            if outs[0] != outs[1]:
                raise AssertionError("a repeat run wrote different files")
            log(f"[7] repeat run: {len(outs[0])} files byte-identical")

            short_tsv = os.path.join(tmp, "short.tsv")
            write_tsv(short_tsv, [make_read(model, n_bases=30, seed=80 + s) for s in range(4)])
            jobs = list(readers.generate_tsv_jobs(short_tsv, rna=True))
            params = {}
            for prec in ("fp32", "fp64"):
                t = Trainer("basic", "rna002", os.path.join(tmp, prec),
                            os.path.join(tmp, "run0", "trained_0_0.model"),
                            batch_size=4, precision=prec, device="cuda")
                t.process_batch(jobs, epoch=0)
                t.close()
                params[prec] = t.transition_params
            rel = {p: abs(params["fp32"][p] / params["fp64"][p] - 1) for p in ("m1", "e2")}
            log(f"[7] fp32 vs fp64 trainer on 4 short reads: m1/e2 rel diff {rel}")
            if max(rel.values()) > 1e-3:
                raise AssertionError("fp32 trainer off the fp64 trainer")

        # the training step at (24, 16384, 512): prepare_batch and
        # banded_batch_train with the results brought to the host, as the
        # trainer runs them (host clock); then the same stages one by one,
        # kernels and emission statistics on CUDA events
        step_reads = bench[:TRAIN_BATCH]

        def prepare():
            kids = kids_of(step_reads)
            b = bb.prepare_batch([s for s, _ in step_reads], kids, model, device="cuda",
                                 dtype=torch.float32, t_pad_to=T_PAD_TO)
            kid_pad = np.zeros((len(kids), max(len(k) for k in kids)), np.int32)
            for i, k in enumerate(kids):
                kid_pad[i, : len(k)] = k
            return b, kid_pad

        split = {k: [] for k in ("step", "host_prep", "banded_fwd", "banded_bwd_train",
                                 "emission_stats", "to_host")}
        torch.cuda.reset_peak_memory_stats()
        for it in range(STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b, kid_pad = prepare()
            res = nt.banded_batch_train(b, lm, le, kid_pad, model.num_kmers)
            host = [x.cpu() for x in res]
            step_ms = (time.perf_counter() - t0) * 1e3
            del res, host, b
            t0 = time.perf_counter()
            b, kid_pad = prepare()
            plan = nt.stats_plan(b.bstart.cpu().numpy(), b.T.cpu().numpy(),
                                 b.N.cpu().numpy(), kid_pad, model.num_kmers,
                                 b.sig.device, b.sig.dtype)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            fM, fE = kk.forward(b, lm, le)
            ev[1].record()
            bM, bE, rawM1, rawE2 = kk.backward_train(b, fE, lm, le)
            ev[2].record()
            Zb = bE[torch.arange(TRAIN_BATCH, device="cuda"), 0, b.bw.long() + 1]
            means, stdevs = nt.emission_stats(b, fM, fE, bM, bE, Zb, plan,
                                              kid_pad.shape[1] + 1)
            ev[3].record()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host = [x.cpu() for x in (rawM1, rawE2, Zb, means, stdevs)]
            t3 = time.perf_counter()
            del fM, fE, bM, bE, means, stdevs, host, b
            if it == 0:
                continue  # warm-up
            split["step"].append(step_ms)
            split["host_prep"].append((t1 - t0) * 1e3)
            split["banded_fwd"].append(ev[0].elapsed_time(ev[1]))
            split["banded_bwd_train"].append(ev[1].elapsed_time(ev[2]))
            split["emission_stats"].append(ev[2].elapsed_time(ev[3]))
            split["to_host"].append((t3 - t2) * 1e3)
        med = {k: sorted(v)[len(v) // 2] for k, v in split.items()}
        log(f"[7] training step (24, 16384, 512) fp32, median of {STEPS}: {med['step']:.2f} ms "
            f"= {TRAIN_BATCH / (med['step'] / 1e3):.2f} reads/s (all steps ms "
            f"{[round(x, 2) for x in split['step']]}) | split, medians: host prep "
            f"{med['host_prep']:.2f} ms, banded_fwd {med['banded_fwd']:.3f} ms, "
            f"banded_bwd_train {med['banded_bwd_train']:.3f} ms, emission stats "
            f"{med['emission_stats']:.3f} ms, to host {med['to_host']:.2f} ms | peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del split, step_reads

    ntc_times, long_ref = phases_ntc(phase, model, bench, lm, le, max_err, launches, want)
    times.update(ntc_times)
    # 11. the lattice kernels against their plain versions
    phase.start("11")
    if want("11"):
        phase_11(model, max_err)
    # 12. the resquiggle engine at full width
    phase.start("12")
    if want("12"):
        times.update(phase_12(model, bench, launches, long_ref))
    # 13. NTC training
    phase.start("13")
    if want("13"):
        by_instance.update(phase_13(model, bench, launches, want("12")))
    # 14. native 9-mer NTC
    phase.start("14")
    if want("14"):
        phase_14(model, bench, lm, le)
    # 15. the matrix route, the stacked table gather, the NT CLIs
    phase.start("15")
    if want("15"):
        times.update(phase_15(model, bench, small, launches, max_err, by_path))
    # 16. the probes of K13
    phase.start("16")
    if want("16"):
        times.update(phase_16(model, bench, launches, max_err))
    # 17. several devices and processes on the card
    phase.start("17")
    if want("17"):
        phase_17(model, bench)
    phase.end()

    kernels = []
    for name, t in times.items():
        if name not in launches or name not in max_err:
            continue  # a subset run (--phases) measured it without its path
        kernels.append({"name": name, "route": "cuda", "source": SOURCE[name],
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": max_err[name], **t})
        if name in by_instance:
            kernels[-1]["launches_by_instance"] = by_instance[name]
        if by_path.get(name):
            kernels[-1]["launches_by_path"] = by_path[name]
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

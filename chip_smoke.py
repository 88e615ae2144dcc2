#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU: python3 chip_smoke.py

Phases (each raises on failure; the run exits nonzero and prints no
result line):
  1. the card, its name and power limit, torch / CUDA / nvcc versions;
  2. a fresh nvcc build of the kernels from dynamont_tpu_torch/csrc/;
  3. each kernel against its plain-torch version on the card, on the CPU
     tests' three short reads and on one (2, 16384, 512) bucket, in fp32
     and fp64: band cells within 1e-5, Z within rtol 1e-6, choice bits,
     walked paths and segment starts identical, walk probabilities within
     1e-6 (both compute the same float operations in the same order);
  4. the main path: 64 reads of 1800 bases (mean dwell 9, T trimmed to
     16000, rna002) through BandedBatchEngine on the card, batch 32, run
     RUNS times after a warm-up, with the launch counters reset right
     before and read right after; every
     read must yield CSV rows, every kernel must have launched and no
     plain version run; three short reads are held against the exact fp64
     rung (borders identical, probabilities within 2e-3);
  5. CUDA-event times of each kernel beside its plain version at its
     path's bucket shape: (32, 16384, 512) for the segmentation kernels,
     (24, 16384, 512) for the training kernels;
  6. the training kernels (banded_fwd, banded_bwd_train) against their
     plain versions on the short reads and on one (2, 16384, 512) bucket,
     fp32 and fp64: every output bit for bit;
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
     ntc_tk_fwd_u) against their plain versions, fp32 and fp64, on the CPU
     tests' three short reads and on one (2, 16384) bucket at N2 2048 and
     K 1024: every output bit for bit (both stores, the TN pack, E0, U,
     finalE), then identical candidates, counts and overflow flags;
  9. the batched pre-pass at the resquiggle engine's bucket shape: 16
     reads of the phase-4 shape, (16, 16384), N2 2048, K 1024, CN 8,
     CK0 120, fp32, through pre_tn_batch and pre_tk_batch with the launch
     counters reset right before and read right after (all four kernels,
     no plain version); the preProcTN/TK Z gates per read (at most one may
     fail); overflowing reads and the share of columns at the cap; each
     kernel's CUDA-event time beside its plain version's; peak memory;
 10. the exact per-read NTC through dynamont_tpu_torch.cli.ntc_main.main in
     process: three short reads in segment, calcZ and train mode on cuda
     against cpu (borders and polish k-mers identical, probabilities and
     trained values within 1e-9 — a k-mer reported on one side only must
     have a stdev within that bound —, Z within rel 1e-12), no pre-pass
     kernel launched; then the first phase-4 read in segment mode with
     its wall time and CAP_LADDER rung, and the batched fp64 kernels at
     R = 1 and that rung's caps, whose candidate sets must equal the
     per-read pre-pass's.
Each phase prints its wall time. The line before the last is
{"kernels": [...]}; the last is {"ok": true, "device": {...}}. Needs no
JAX, no zstandard, no network.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
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
    "banded_fwd": "dynamont_tpu_torch/csrc/nt_banded_train.cu",
    "banded_bwd_train": "dynamont_tpu_torch/csrc/nt_banded_train.cu",
    "ntc_tn_fwd": "dynamont_tpu_torch/csrc/ntc_pre.cu",
    "ntc_tn_bwd_sel": "dynamont_tpu_torch/csrc/ntc_pre.cu",
    "ntc_tk_bwd": "dynamont_tpu_torch/csrc/ntc_pre.cu",
    "ntc_tk_fwd_u": "dynamont_tpu_torch/csrc/ntc_pre.cu",
}
REPLACES = {
    "banded_bwd": "dynamont_tpu/ops/nt_banded_pallas.py:273",
    "banded_fwd_vit": "dynamont_tpu/ops/nt_banded_pallas.py:584",
    "banded_walk": "dynamont_tpu/ops/nt_banded_pallas.py:747",
    "banded_fwd": "dynamont_tpu/ops/nt_banded_pallas.py:113",
    "banded_bwd_train": "dynamont_tpu/ops/nt_banded_train.py:90",
    "ntc_tn_fwd": "dynamont_tpu/ops/ntc_pre_pallas.py:78",
    "ntc_tn_bwd_sel": "dynamont_tpu/ops/ntc_pre_pallas.py:113",
    "ntc_tk_bwd": "dynamont_tpu/ops/ntc_pre_pallas.py:336",
    "ntc_tk_fwd_u": "dynamont_tpu/ops/ntc_pre_pallas.py:381",
}
NTC_READS, CN, CK0 = 16, 8, 120  # the resquiggle engine's kernel geometry
FP32_EPSILON = 1e-6  # per-cell Z tolerance of the fp32 engine gates
CELL_ATOL = 1e-5
RUNS = 5
STEPS = 5  # timed training steps after a warm-up


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def band_err(got, want, T):
    """Max |got - want| over finite band cells of rows < T; raises if the
    -inf patterns differ or a cell is off by more than CELL_ATOL."""
    import torch

    err = 0.0
    for i, t in enumerate(T.tolist()):
        x, y = got[i, :t], want[i, :t]
        if not torch.equal(torch.isneginf(x), torch.isneginf(y)):
            raise AssertionError(f"read {i}: -inf patterns differ")
        fin = torch.isfinite(y)
        d = (x[fin] - y[fin]).abs()
        if d.numel():
            err = max(err, d.max().item())
            if err > CELL_ATOL:
                raise AssertionError(f"read {i}: band cell off by {err}")
    return err


def compare_kernels(batch, N_max, lm, le):
    """Run each kernel and its plain version on one batch; returns the max
    abs error per kernel and raises on disagreement."""
    import torch

    from dynamont_tpu_torch.ops import nt_banded_batch as bb
    from dynamont_tpu_torch.ops import nt_banded_kernels as kk

    T = batch.T.cpu()
    errs = {}
    bM, bE = kk.backward(batch, lm, le)
    pM, pE = kk.backward_plain(batch, lm, le)
    errs["banded_bwd"] = max(band_err(bM, pM, T), band_err(bE, pE, T))
    del bM, bE
    r = torch.arange(T.numel(), device=pE.device)
    Zb = pE[r, 0, batch.bw.long() + 1]
    ch, LPM, LPE, Zf = kk.fwd_vit(batch, pM, pE, Zb, lm, le)
    pch, pLPM, pLPE, pZf = kk.fwd_vit_plain(batch, pM, pE, Zb, lm, le)
    del pM, pE
    if not torch.equal(ch, pch):
        raise AssertionError(f"fwd_vit: {(ch != pch).sum().item()} choice bits differ")
    torch.testing.assert_close(Zf, pZf, rtol=1e-6, atol=0)
    errs["banded_fwd_vit"] = max(band_err(LPM, pLPM, T),
                                 band_err(LPE, pLPE, T),
                                 (Zf - pZf).abs().max().item())
    del ch, LPM, LPE
    walked = kk.walk(pLPM, pLPE, pch, batch, N_max)
    plain = kk.walk_plain(pLPM, pLPE, pch, batch, N_max)
    if not (torch.equal(walked[0], plain[0]) and torch.equal(walked[2], plain[2])):
        raise AssertionError("walk: paths differ")
    torch.testing.assert_close(walked[1], plain[1], rtol=0, atol=1e-6)
    errs["banded_walk"] = (walked[1] - plain[1]).abs().max().item()
    s_k, _ = bb.path_summaries(*walked, N_max)
    s_p, _ = bb.path_summaries(*plain, N_max)
    if not torch.equal(s_k, s_p):
        raise AssertionError("walk: segment starts differ")
    torch.cuda.synchronize()
    return errs


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def compare_train_kernels(batch, lm, le):
    """banded_fwd and banded_bwd_train against their plain versions on one
    batch: every output bit for bit. Returns the max abs error per kernel
    (0.0) and raises on any difference."""
    import torch

    from dynamont_tpu_torch.ops import nt_banded_kernels as kk

    fM, fE = kk.forward(batch, lm, le)
    pfM, pfE = kk.forward_plain(batch, lm, le)
    torch.cuda.synchronize()
    if not (torch.equal(fM, pfM) and torch.equal(fE, pfE)):
        raise AssertionError("banded_fwd differs from its plain version")
    del fM, fE, pfM
    got = kk.backward_train(batch, pfE, lm, le)
    want = kk.backward_train_plain(batch, pfE, lm, le)
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

    from dynamont_tpu.utils.kmer import seq_to_kmer_ids

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


def run_ntc_cli(sig, read, device: str, flags=()):
    """dynamont_tpu_torch.cli.ntc_main.main in process on one read: (the
    NTCResult, stdout)."""
    from dynamont_tpu.models.registry import get_model_path
    from dynamont_tpu.utils.synthetic import signal_to_text
    from dynamont_tpu_torch.cli import ntc_main

    stdin, out = sys.stdin, io.StringIO()
    sys.stdin = io.StringIO(f"{signal_to_text(sig)}\n{read}\n")
    try:
        with contextlib.redirect_stdout(out):
            res = ntc_main.main(["-m", get_model_path("rna002"), "-r", "rna002",
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


def phases_ntc(phase, model, bench, lm, le, max_err: dict, launches: dict):
    """Phases 8-10 (the NTC pre-pass kernels and the per-read NTC). Fills
    max_err and launches for the four pre-pass kernels; returns their
    (kernel ms, plain ms) at the engine's bucket shape."""
    import torch

    from dynamont_tpu.models.packing import round_up, t_pad_ladder
    from dynamont_tpu.utils.synthetic import make_read
    from dynamont_tpu_torch.models.ntc import CAP_LADDER
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

    n_of = lambda read: len(read) - model.kmer_size + 2  # N = k-mers + 1
    # 8. the pre-pass kernels against their plain versions
    phase.start("8")
    short = [make_read(model, n_bases=n, seed=s) for s, n in ((0, 25), (1, 31), (2, 18))]
    t_short = round_up(max(len(s) for s, _ in short) + 1, 64)   # the CPU tests'
    n_short = round_up(max(n_of(r) for _, r in short), 16)      # engine padding
    t_full = t_pad_ladder(len(bench[0][0]) + 1, 2048)
    n_full = round_up(n_of(bench[0][1]), 256)
    if (t_full, n_full) != (16384, 2048):
        raise AssertionError(f"NTC bucket shape {(t_full, n_full)}")
    for dtype in (torch.float32, torch.float64):
        for reads, t_pad, n2 in ((short, t_short, n_short), (bench[:2], t_full, n_full)):
            errs = compare_pre_kernels(model, pre_bucket(model, reads, t_pad, n2),
                                       dtype, lm, le)
            log(f"[8] bucket {(len(reads), t_pad, n2)} K {model.num_kmers} {dtype}: "
                f"every output and the selections bit for bit, max abs err {errs}")
        torch.cuda.empty_cache()
    max_err.update(errs)

    # 9. the batched pre-pass at the engine's bucket shape
    phase.start("9")
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[9] pre-pass ({NTC_READS}, {t_full}) N2 {n_full} K {model.num_kmers} CN {CN} "
        f"CK0 {CK0} fp32: {wall * 1e3:.1f} ms wall | launches {pre_launches} | plain "
        f"{pre_plain} | peak device memory {peak:.2f} GiB")
    if any(v == 0 for v in pre_launches.values()) or any(pre_plain.values()):
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
    runs = {
        "ntc_tn_fwd": (lambda: kn.tn_fwd(sig, tab, N_r, lm, le),
                       lambda: kn.tn_fwd_plain(sig, tab, N_r, lm, le)),
        "ntc_tn_bwd_sel": (lambda: kn.tn_bwd_sel(sig, tab, kid, N_r, T_r, fwd, CN, lm, le),
                           lambda: kn.tn_bwd_sel_plain(sig, tab, kid, N_r, T_r, fwd, CN,
                                                       lm, le)),
        "ntc_tk_bwd": (lambda: kn.tk_bwd(sig, tabk, T_r, 4, lm, le),
                       lambda: kn.tk_bwd_plain(sig, tabk, T_r, 4, lm, le)),
        "ntc_tk_fwd_u": (lambda: kn.tk_fwd_u(sig, tabk, T_r, bwd, 4, lm, le),
                         lambda: kn.tk_fwd_u_plain(sig, tabk, T_r, bwd, 4, lm, le)),
    }
    times = {}
    for name, (kern, plain) in runs.items():
        ms = cuda_ms(kern, 2)
        plain_ms = cuda_ms(plain, 1)
        log(f"[9] {name} ({NTC_READS}, {t_full}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        times[name] = (ms, plain_ms)
    del fwd, bwd, runs, tab, tabk, sig
    torch.cuda.empty_cache()

    # 10. the exact per-read NTC through its CLI
    phase.start("10")
    before = dict(kn.LAUNCHES)
    for i, (s, r) in enumerate(make_read(model, n_bases=25, seed=s) for s in range(3)):
        for mode, flags in (("segment", ()), ("calcZ", ("-z",)), ("train", ("--train",))):
            t0 = time.perf_counter()
            got, out_g = run_ntc_cli(s, r, "cuda", flags)
            t1 = time.perf_counter()
            want, out_w = run_ntc_cli(s, r, "cpu", flags)
            err = ntc_agree(got, want, mode)
            log(f"[10] short read {i} {mode}: cuda {t1 - t0:.2f} s, cpu "
                f"{time.perf_counter() - t1:.2f} s, rung {got.caps}, max diff {err:.3g}, "
                f"stdout {'identical' if out_g == out_w else 'differs'}")
    if kn.LAUNCHES != before:
        raise AssertionError("the per-read NTC launched a pre-pass kernel")
    s, r = bench[0]
    t0 = time.perf_counter()
    res, _ = run_ntc_cli(s, r, "cuda")
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
    return times


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dynamont_tpu.constants import NT_TRANSITIONS
    from dynamont_tpu.io.output import format_segments_csv
    from dynamont_tpu.models.packing import t_pad_ladder
    from dynamont_tpu.models.registry import load_model_for_pore
    from dynamont_tpu.native import summaries_csv_native
    from dynamont_tpu.utils.kmer import seq_to_kmer_ids
    from dynamont_tpu.utils.synthetic import make_read
    from dynamont_tpu.io import readers
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

    # 3. kernels against their plain versions
    phase.start("3")
    small = [make_read(model, n_bases=40 + 10 * s, seed=s) for s in range(3)]
    bench = []
    for s in range(N_READS):
        sig, read = make_read(model, n_bases=N_BASES, mean_dwell=MEAN_DWELL, seed=s)
        bench.append((sig[:T_TRIM], read))
    max_err = {}
    for dtype in (torch.float32, torch.float64):
        for reads in (small, bench[:2]):
            b, nmax = bucket(reads, dtype)
            shape = (b.sig.shape[0], b.bstart.shape[1], b.B)
            errs = compare_kernels(b, nmax, lm, le)
            log(f"[3] bucket {shape} {dtype}: max abs err {errs}")
            del b
        if shape != (2, 16384, 512):
            raise AssertionError(f"production bucket shape {shape}")
        if dtype == torch.float32:
            max_err = errs
        torch.cuda.empty_cache()

    # 4. the main path
    phase.start("4")
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
    launches, plain_runs = dict(kk.LAUNCHES), dict(kk.PLAIN_RUNS)
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
    main_b, nmax = bucket(bench[:BATCH], torch.float32)
    log(f"[5] timing bucket {(main_b.sig.shape[0], main_b.bstart.shape[1], main_b.B)}")
    r = torch.arange(BATCH, device="cuda")
    bM, bE = kk.backward(main_b, lm, le)
    Zb = bE[r, 0, main_b.bw.long() + 1]
    ch, LPM, LPE, _ = kk.fwd_vit(main_b, bM, bE, Zb, lm, le)
    runs = {
        "banded_bwd": (lambda: kk.backward(main_b, lm, le),
                       lambda: kk.backward_plain(main_b, lm, le)),
        "banded_fwd_vit": (lambda: kk.fwd_vit(main_b, bM, bE, Zb, lm, le),
                           lambda: kk.fwd_vit_plain(main_b, bM, bE, Zb, lm, le)),
        "banded_walk": (lambda: kk.walk(LPM, LPE, ch, main_b, nmax),
                        lambda: kk.walk_plain(LPM, LPE, ch, main_b, nmax)),
    }
    kids_of = lambda reads: [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size)
                             for _, r in reads]
    train_b = bb.prepare_batch([s for s, _ in bench[:TRAIN_BATCH]], kids_of(bench[:TRAIN_BATCH]),
                               model, device="cuda", dtype=torch.float32,
                               t_pad_to=T_PAD_TO)
    if (train_b.sig.shape[0], train_b.bstart.shape[1], train_b.B) != (TRAIN_BATCH, 16384, 512):
        raise AssertionError("training bucket shape")
    fM, fE = kk.forward(train_b, lm, le)
    del fM
    runs["banded_fwd"] = (lambda: kk.forward(train_b, lm, le),
                          lambda: kk.forward_plain(train_b, lm, le))
    runs["banded_bwd_train"] = (lambda: kk.backward_train(train_b, fE, lm, le),
                                lambda: kk.backward_train_plain(train_b, fE, lm, le))
    times = {}
    for name, (kern, plain) in runs.items():
        kern()
        ms = cuda_ms(kern, 3)
        plain_ms = cuda_ms(plain, 1)
        log(f"[5] {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        times[name] = (ms, plain_ms)
    del main_b, bM, bE, ch, LPM, LPE, fE, train_b, runs
    torch.cuda.empty_cache()

    # 6. the training kernels against their plain versions
    phase.start("6")
    for dtype in (torch.float32, torch.float64):
        for reads in (small, bench[:2]):
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

    ntc_times = phases_ntc(phase, model, bench, lm, le, max_err, launches)
    times.update(ntc_times)
    phase.end()

    kernels = []
    for name, (ms, plain_ms) in times.items():
        kernels.append({"name": name, "route": "cuda", "source": SOURCE[name],
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": max_err[name], "ms": ms,
                        "plain_ms": plain_ms})
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

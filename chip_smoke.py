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
  5. CUDA-event times of each kernel beside its plain version at the main
     path's bucket shape (32, 16384, 512).
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Needs no JAX, no zstandard, no network.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

N_READS, N_BASES, MEAN_DWELL, T_TRIM, BATCH = 64, 1800, 9.0, 16000, 32
SOURCE = "dynamont_tpu_torch/csrc/nt_banded.cu"
REPLACES = {
    "banded_bwd": "dynamont_tpu/ops/nt_banded_pallas.py:273",
    "banded_fwd_vit": "dynamont_tpu/ops/nt_banded_pallas.py:584",
    "banded_walk": "dynamont_tpu/ops/nt_banded_pallas.py:747",
}
CELL_ATOL = 1e-5
RUNS = 5


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
    from dynamont_tpu_torch import _build
    from dynamont_tpu_torch.models.batch import BandedBatchEngine, BatchItem
    from dynamont_tpu_torch.models.nt_banded import run_nt_banded
    from dynamont_tpu_torch.models.params import params_from_numpy
    from dynamont_tpu_torch.ops import nt_banded_device as dv
    from dynamont_tpu_torch.ops import nt_banded_kernels as kk

    # 1. the card
    kind = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"[1] device {kind} x{torch.cuda.device_count()} | torch "
        f"{torch.__version__} | CUDA {torch.version.cuda} | nvcc {nvcc} | "
        f"python {sys.version.split()[0]}")
    log(card)

    # 2. a fresh build from the checkout's sources
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
    if any(v == 0 for v in launches.values()) or any(plain_runs.values()):
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

    # 5. kernel and plain-version times at the main path's bucket shape
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
    kernels = []
    for name, (kern, plain) in runs.items():
        kern()
        ms = cuda_ms(kern, 3)
        plain_ms = cuda_ms(plain, 1)
        log(f"[5] {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
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

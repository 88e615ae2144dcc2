"""Timing probes of the card's NTC backward kernel (K13, ntc_bwd): the
port's counterparts of the JAX package's TPU probes of K13.

  ntc_bwd_synth     scripts/probe_ntc_bwd_synth.py     (#19): the variants of
                    ops/ntc_probe_kernels.bwd_variant on seeded synthetic
                    inputs (synth_inputs), and K15 on a variant's store
  ntc_bwd_variants  scripts/probe_ntc_bwd_variants.py  (#20): the variants
                    on the engine's own bucket of 16 synthetic reads
  ntc_microops      scripts/probe_ntc_microops.py      (#21): the building
                    blocks of K13 on one (128, 128) tile (ntc_probe_kernels.microop)

Run as `python -m dynamont_tpu_torch.probes.<name> [arguments] [--device
cuda|cpu]`: on the card by default (without one they exit NO_CUDA_EXIT,
12, through cli/_protocol.device_or_exit, as the single-read CLIs do), the
plain versions with --device cpu. Times are CUDA events, the least of
three runs after a warm-up (the host clock on the CPU).
"""

from __future__ import annotations

import time
from typing import NamedTuple

# The variants: K13 as it runs ("prod"), then one axis changed at a time.
# C rows per chunk (staged into shared memory when `stage`), the chunks'
# order, threads per read, and what is stored.
_BASE = dict(C=8, stage=False, reverse=True, nt=512, store="full")
VARIANTS = {
    "prod": ("K13: C=8 unstaged, reverse, 512 thr", {}),
    "rev": ("C=8 staged, reverse", dict(stage=True)),
    "fwd": ("C=8 staged, forward", dict(stage=True, reverse=False)),
    "c4": ("C=4 staged, reverse", dict(C=4, stage=True)),
    "c4fwd": ("C=4 staged, forward", dict(C=4, stage=True, reverse=False)),
    "c16": ("C=16 staged, reverse", dict(C=16, stage=True)),
    "c16fwd": ("C=16 staged, forward", dict(C=16, stage=True, reverse=False)),
    "nt128": ("128 threads per read", dict(nt=128)),
    "nt256": ("256 threads per read", dict(nt=256)),
    "nt1024": ("1024 threads per read", dict(nt=1024)),
    "none": ("no store (row 0 only)", dict(store="none")),
}
ALL_VARIANTS = tuple(VARIANTS)


def variant_kwargs(name: str) -> dict:
    return {**_BASE, **VARIANTS[name][1]}


class ProbeInputs(NamedTuple):
    """What K13 and the variants read: ntc_kernels.bwd's arguments."""

    plan: object
    dims: object
    prm: object
    sig: object
    trans_log: dict
    N_r: object
    T_r: object


def min_ms(fn, device, runs: int = 3):
    """(fn()'s last result, the least of `runs` times in ms after one
    warm-up call): CUDA events on the card, the host clock on the CPU."""
    import torch

    out = fn()
    best = float("inf")
    for _ in range(runs):
        del out
        if device.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn()
            ev[1].record()
            ev[1].synchronize()
            ms = ev[0].elapsed_time(ev[1])
        else:
            t0 = time.perf_counter()
            out = fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return out, best


def run_variants(inp: ProbeInputs, names, device, check=None, log=print) -> dict:
    """Times each named variant on `inp`; one line each with ms, us per
    column step and us per chunk. A staged C that does not fit the card's
    shared memory is reported with its bytes and not run.
    check(name, inp, out), when given, sees each variant's output. Returns
    {name: ms} of the variants that ran."""
    from dynamont_tpu_torch.ops import ntc_probe_kernels as pk

    T_pad = inp.sig.shape[1] + 1
    times = {}
    for name in names:
        desc, kw = VARIANTS[name][0], variant_kwargs(name)
        need = pk.smem_bytes(inp.dims, kw["C"], kw["stage"])
        try:
            out, ms = min_ms(lambda: pk.bwd_variant(*inp, **kw), device)
        except pk.DoesNotFit as e:
            log(f"{name:7s} {desc:38s}: not run: {e}")
            continue
        if check is not None:
            check(name, inp, out)
        del out
        times[name] = ms
        log(f"{name:7s} {desc:38s}: {ms:10.3f} ms {ms * 1e3 / T_pad:9.3f} us/column "
            f"step {ms * 1e3 * kw['C'] / T_pad:10.3f} us/chunk ({need} B shared)")
    return times

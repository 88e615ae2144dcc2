"""End-to-end single-read banded NT pipeline, segment mode (counterpart
of dynamont_tpu/models/nt_banded.py; ref: src/cpp/NT_banded_main.cpp).
It is the exact fp64 rung that batched reads failing the fp32 Z gate
escalate to."""

from __future__ import annotations

import math

import torch

from dynamont_tpu.constants import NT_TRANSITIONS, resolve_transitions
from dynamont_tpu.ops.geometry import effective_bandwidth
from dynamont_tpu.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.models.nt import NTResult, ZConsistencyError, _validate
from dynamont_tpu_torch.ops import nt_banded
from dynamont_tpu_torch.ops.nt_banded_device import summaries_to_segments
from dynamont_tpu_torch.ops.nt_full import check_z

DEFAULT_BAND = 400


def run_nt_banded(signal, read: str, model, pore: str,
                  transition_overrides: dict | None = None,
                  mode: str = "segment", band: int = DEFAULT_BAND, *,
                  device, dtype=torch.float64,
                  validate: bool = True) -> NTResult:
    if mode != "segment":
        raise NotImplementedError(f"banded mode {mode!r} is not ported yet")
    trans = resolve_transitions(NT_TRANSITIONS[pore], transition_overrides)
    if validate:
        _validate(len(signal), len(read), model.kmer_size)
    kmer_ids = seq_to_kmer_ids(read, model.kmer_size, model.alphabet_size)
    T = len(signal) + 1
    N = len(kmer_ids) + 1
    Zf, Zb, starts, medians = nt_banded.banded_segment_read(
        signal, kmer_ids, model, band,
        math.log(trans["m1"]), math.log(trans["e2"]), device=device,
        dtype=dtype)
    # the reference's gate counts T*(2*bw+3) band cells — the unpadded
    # band, not the batch gate's padded B
    if not check_z(Zf, Zb, T * (2 * effective_bandwidth(band, N) + 3)):
        raise ZConsistencyError(
            f"Z values between matrices do not match! Zf: {Zf}, Zb: {Zb}")
    segments = summaries_to_segments(starts, medians, N, model.kmer_size)
    return NTResult(segments=segments, Z=Zb)

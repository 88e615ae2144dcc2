"""End-to-end single-read banded NT pipeline (counterpart of
dynamont_tpu/models/nt_banded.py; ref: src/cpp/NT_banded_main.cpp), run
by dynamont-NT-banded (cli/nt_banded_main.py). It is the exact fp64 rung
that batched reads failing the fp32 Z gate escalate to, in segment mode
for segmentation and in train/calcZ mode for training. Segments come
from the fused kernels (K1-K3); want_prob also runs the read through the
matrix route (K5, K1, K4) for the per-t border log-probabilities."""

from __future__ import annotations

import math

import torch

from dynamont_tpu_torch.constants import NT_TRANSITIONS, resolve_transitions
from dynamont_tpu_torch.ops.geometry import effective_bandwidth
from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.models.nt import (
    NTResult, ZConsistencyError, _emissions_to_dict, _validate,
)
from dynamont_tpu_torch.ops import nt_banded
from dynamont_tpu_torch.ops.nt_banded_device import summaries_to_segments
from dynamont_tpu_torch.ops.nt_full import check_z

DEFAULT_BAND = 400
MODES = ("segment", "train", "calcZ")


def run_nt_banded(signal, read: str, model, pore: str,
                  transition_overrides: dict | None = None,
                  mode: str = "segment", want_prob: bool = False,
                  band: int = DEFAULT_BAND, *,
                  device, dtype=torch.float64,
                  validate: bool = True) -> NTResult:
    if mode not in MODES:
        raise ValueError(f"banded mode {mode!r} is not one of {MODES}")
    trans = resolve_transitions(NT_TRANSITIONS[pore], transition_overrides)
    if validate:
        _validate(len(signal), len(read), model.kmer_size)
    kmer_ids = seq_to_kmer_ids(read, model.kmer_size, model.alphabet_size)
    T = len(signal) + 1
    N = len(kmer_ids) + 1
    log_m1, log_e2 = math.log(trans["m1"]), math.log(trans["e2"])
    if mode == "segment":
        Zf, Zb, starts, medians = nt_banded.banded_segment_read(
            signal, kmer_ids, model, band, log_m1, log_e2, device=device,
            dtype=dtype)
    else:
        Zf, Zb, m1, e2, means, stdevs = nt_banded.banded_train_read(
            signal, kmer_ids, model, band, log_m1, log_e2, device=device,
            dtype=dtype)
    # the reference's gate counts T*(2*bw+3) band cells — the unpadded
    # band, not the batch gate's padded B
    if not check_z(Zf, Zb, T * (2 * effective_bandwidth(band, N) + 3)):
        raise ZConsistencyError(
            f"Z values between matrices do not match! Zf: {Zf}, Zb: {Zb}")
    if mode == "calcZ":
        return NTResult(Z=Zb)
    if mode == "train":
        return NTResult(Z=Zb, trained_transitions={"m1": m1, "e1": 1.0, "e2": e2},
                        trained_emissions=_emissions_to_dict(means, stdevs, model))
    segments = summaries_to_segments(starts, medians, N, model.kmer_size)
    result = NTResult(segments=segments, Z=Zb)
    if want_prob:
        result.per_t_logprob = nt_banded.banded_per_t_logprob(
            signal, kmer_ids, model, band, log_m1, log_e2, device=device,
            dtype=dtype)
    return result

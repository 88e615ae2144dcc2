"""End-to-end single-read NTC (resquiggle / error-correction) pipeline
(counterpart of dynamont_tpu/models/ntc.py; ref: src/cpp/NTC_main.cpp).

The exact fp64 rung: the per-read `dynamont-NTC` protocol, and the path
every read of the batched engine falls back to. Same ladder, same gates,
same results as the JAX package. The two pre-pass lattices do not depend
on the candidate caps, so they are computed once and only the selection
runs again at each rung of CAP_LADDER.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from dynamont_tpu_torch.constants import (
    EPSILON, NT_TRANSITIONS, NTK_TRANSITIONS, resolve_transitions,
)
from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.models.nt import _validate
from dynamont_tpu_torch.ops import nt_full, ntc_dp, ntc_pre

MODES = ("segment", "calcZ", "train")


class NTCPreprocessError(RuntimeError):
    """Z mismatch in a 2D pre-pass (reference exits 1/2)."""

    def __init__(self, which, msg):
        super().__init__(msg)
        self.exit_code = 1 if which == "TN" else 2


class NTCZError(RuntimeError):
    """Z mismatch in the 3D DP (reference exit 3)."""

    exit_code = 3


@dataclass
class NTCResult:
    Z: float = math.nan
    segments: list | None = None   # [(state, basepos, start_t, prob, polish_kmer)]
    trained_transitions: dict | None = None
    trained_emissions: dict | None = None
    caps: tuple | None = None      # the CAP_LADDER rung the read ran at
    prepass: tuple | None = None   # (TN, TK) PrePassResults at that rung


# candidate-cap escalation ladder: static shapes per rung, re-run on overflow
CAP_LADDER = [(8, 16), (16, 32), (32, 64), (64, 128)]


def run_ntc(signal, read: str, model, pore: str,
            transition_overrides: dict | None = None, mode: str = "segment",
            *, device, dtype=torch.float64, validate: bool = True) -> NTCResult:
    if mode not in MODES:
        raise ValueError(f"NTC mode {mode!r} is not one of {MODES}")
    if validate:
        _validate(len(signal), len(read), model.kmer_size)
    ntk = resolve_transitions(NTK_TRANSITIONS[pore], transition_overrides)
    trans_log = {k: math.log(v) for k, v in ntk.items()}
    nt = NT_TRANSITIONS[pore]
    log_ppm, log_ppe = math.log(nt["m1"]), math.log(nt["e2"])

    kmer_seq = np.asarray(
        seq_to_kmer_ids(read, model.kmer_size, model.alphabet_size), np.int32
    )
    T = len(signal) + 1
    N = len(kmer_seq) + 1
    K = model.num_kmers
    put = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)
    sig = put(signal)
    means, c1, c2 = (put(a) for a in model.score_params())

    # --- 2D pre-passes with cap escalation --------------------------------
    scores_tn = nt_full.emission_scores(signal, kmer_seq, model.means,
                                        model.stdevs, device=device,
                                        dtype=dtype)
    tn = ntc_pre.tn_posteriors(scores_tn, log_ppm, log_ppe)
    del scores_tn
    tk = ntc_pre.tk_posteriors(sig, means, c1, c2, log_ppm, log_ppe,
                               model.alphabet_size)
    pn = pk = None
    for cap_n, cap_k in CAP_LADDER:
        pn = ntc_pre.select_tn(*tn, cap_n)
        pk = ntc_pre.select_tk(*tk, cap_k)
        if not bool(pn.overflow) and not bool(pk.overflow):
            break
    del tn, tk
    _check_pre("TN", pn, T * N)
    _check_pre("TK", pk, T * K)

    # --- 3D sparse DP ------------------------------------------------------
    plan = ntc_dp.build_plan(
        pn.cand, pn.count, pk.cand, pk.count,
        torch.as_tensor(kmer_seq, device=device), means, c1, c2,
        model.alphabet_size, model.kmer_size, dtype,
    )
    fwd = ntc_dp.ntc_forward(plan, sig, trans_log, N, model.alphabet_size,
                             model.kmer_size)
    bwd = ntc_dp.ntc_backward(plan, sig, trans_log, N, model.alphabet_size,
                              model.kmer_size)
    Zf, Zb = (float(z) for z in ntc_dp.ntc_z(plan, fwd, bwd, N))
    cells = float(T) * N * K
    if abs(Zf - Zb) / cells >= EPSILON or math.isinf(Zf) or math.isinf(Zb):
        raise NTCZError(
            f"Z values between matrices do not match! forZ: {Zf}, backZ: {Zb}"
        )

    result = NTCResult(Z=Zf, caps=(cap_n, cap_k), prepass=(pn, pk))
    if mode == "calcZ":
        return result

    logp = fwd + bwd - Zf
    if mode == "train":
        from dynamont_tpu_torch.ops import ntc_train

        result.trained_transitions = ntc_train.train_transitions(
            plan, sig, fwd, bwd, logp, trans_log, Zf, N,
            model.alphabet_size, model.kmer_size,
        )
        del fwd, bwd
        result.trained_emissions = ntc_train.train_emissions(
            plan, sig, logp, model,
        )
        return result

    from dynamont_tpu_torch.ops import ntc_viterbi

    del fwd, bwd
    apsei = ntc_viterbi.ntc_max_dp(plan, logp, N)
    result.segments = ntc_viterbi.ntc_traceback(plan, apsei, logp, T, N, K,
                                                model)
    return result


def _check_pre(which, p, cells):
    Zf, Zb = float(p.Zf), float(p.Zb)
    if abs(Zf - Zb) / cells > EPSILON or math.isinf(Zf) or math.isinf(Zb):
        raise NTCPreprocessError(
            which,
            f"Z values of preProc{which} matrices do not match! Zf: {Zf}, Zb: {Zb}",
        )

"""The end-to-end single-read full-lattice NT pipeline (counterpart of
dynamont_tpu/models/nt.py; ref: src/cpp/NT_main.cpp): emission scores,
forward and backward, the Z invariant, posteriors, Viterbi and traceback,
Baum-Welch updates; and the per-read result type, input contract, Z error
and trained-emission report that the banded pipelines share.

Every step is a torch op or a loop of them (ops/nt_full.py) on the device
given; the JAX package's full NT has no Pallas kernel either.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

import numpy as np
import torch

from dynamont_tpu_torch.constants import NT_TRANSITIONS, resolve_transitions
from dynamont_tpu_torch.ops import nt_full
from dynamont_tpu_torch.utils.kmer import int2kmer, seq_to_kmer_ids
from dynamont_tpu_torch.utils.logmath import logsumexp


class ZConsistencyError(RuntimeError):
    """Forward and backward partition functions disagree (reference exit 3)."""

    exit_code = 3


@dataclass
class NTResult:
    segments: list | None = None
    Z: float = math.nan
    per_t_logprob: np.ndarray | None = None
    trained_transitions: dict | None = None
    trained_emissions: dict | None = None


def _validate(signal_len: int, read_len: int, kmer_size: int) -> None:
    """Input contract with reference exit codes (ref: utils.cpp:530-552)."""

    def die(code, msg):
        print(msg, file=sys.stderr)
        raise SystemExit(code)

    if signal_len < 1:
        die(8, f"Signal: {signal_len} smaller than 1")
    if read_len < 1:
        die(9, f"Read: {read_len} smaller than 1")
    if signal_len + 1 < 2 * read_len:
        die(10, f"Signal: {signal_len + 1} smaller than read: {read_len}")
    if read_len < kmer_size:
        die(11, f"Read: {read_len} smaller than kmerSize of the pore type: {kmer_size}")


def run_nt(signal, read: str, model, pore: str,
           transition_overrides: dict | None = None, mode: str = "segment",
           want_prob: bool = False, *, device, dtype=torch.float64,
           validate: bool = True) -> NTResult:
    """Full-lattice NT run for one read on `device`.

    mode: 'segment' (MAP borders), 'calcZ', or 'train' (one Baum-Welch
    step). The signal must already be normalized/filtered and the read in
    processing orientation (RNA: 3'->5' with polyA prefix)."""
    trans = resolve_transitions(NT_TRANSITIONS[pore], transition_overrides)
    if validate:
        _validate(len(signal), len(read), model.kmer_size)
    kmer_ids = seq_to_kmer_ids(read, model.kmer_size, model.alphabet_size)
    T = len(signal) + 1
    N = len(kmer_ids) + 1
    scores = nt_full.emission_scores(signal, kmer_ids, model.means,
                                     model.stdevs, device=device, dtype=dtype)
    mats = nt_full.nt_forward_backward(scores, trans["m1"], trans["e2"])
    if not nt_full.check_z(mats.Zf, mats.Zb, T * N):
        raise ZConsistencyError(
            f"Z values between matrices do not match! Zf: {float(mats.Zf)}, "
            f"Zb: {float(mats.Zb)}")
    result = NTResult(Z=float(mats.Zb))
    if mode == "calcZ":
        return result
    if mode == "train":
        result.trained_transitions = train_transitions(scores, mats, trans)
        means, stdevs = train_emissions(signal, kmer_ids, mats,
                                        model.num_kmers)
        result.trained_emissions = _emissions_to_dict(means, stdevs, model)
        return result
    LPM, LPE = nt_full.posterior_matrices(mats)
    choices = nt_full.nt_viterbi_choices(LPM, LPE)
    result.segments = nt_full.nt_traceback(
        choices.cpu().numpy(), LPM.cpu().numpy(), LPE.cpu().numpy(),
        model.kmer_size)
    if want_prob:
        result.per_t_logprob = nt_full.per_t_border_logprob(LPM).cpu().numpy()
    return result


def train_transitions(scores, mats: nt_full.NTMatrices, trans: dict) -> dict:
    """Baum-Welch transition update (ref: NT.cpp:193-229):

        newM1 = logsum_{t,n} forE[t,n] + log m1 + sc[t,n]   + backM[t+1,n+1]
        newE2 = logsum_{t,n} forE[t,n] + log e2 + sc[t,n-1] + backE[t+1,n]

    normalized so m1 + e2 = 1; e1 stays 1."""
    log_m1, log_e2 = math.log(trans["m1"]), math.log(trans["e2"])
    forE = mats.forE[:-1]  # (T-1, N): terms over t in [0, T-2]
    m1_terms = forE[:, :-1] + log_m1 + scores + mats.backM[1:, 1:]
    e2_terms = forE[:, 1:] + log_e2 + scores + mats.backE[1:, 1:]
    newM1 = logsumexp(m1_terms)
    newE2 = logsumexp(e2_terms)
    Ae = torch.logaddexp(newE2, newM1)
    if torch.isfinite(Ae):
        newM1, newE2 = newM1 - Ae, newE2 - Ae
    return {"m1": float(torch.exp(newM1)), "e1": 1.0,
            "e2": float(torch.exp(newE2))}


def train_emissions(signal, kmer_ids, mats: nt_full.NTMatrices,
                    num_kmers: int):
    """Baum-Welch emission update (ref: NT.cpp:245-332): gamma[t, n] is the
    softmax over n of logaddexp(forM + backM, forE + backE); each k-mer's
    mean averages its positions' posterior-weighted signal means, its
    stdev the weighted squared deviations about that mean. Returns (means,
    stdevs), each (K,) numpy."""
    G = torch.logaddexp(mats.forM + mats.backM, mats.forE + mats.backE)
    s = logsumexp(G, dim=1, keepdim=True)
    G = torch.where(torch.isfinite(s), G - s, G)
    W = torch.exp(G)  # (T, N)
    sig = torch.as_tensor(np.asarray(signal), device=W.device).to(W.dtype)
    # kmers[n] = sum_t W[t,n]*sig[t-1] / sum_t W[t,n], t from 1
    num = W[1:].T @ sig  # (N,)
    den = W[1:].sum(dim=0)
    pos_mean = torch.where(den != 0, num / den, 0.0)
    kid = torch.as_tensor(np.asarray(kmer_ids, np.int64), device=W.device)
    zeros = lambda: torch.zeros(num_kmers, dtype=W.dtype, device=W.device)
    counts = zeros().index_add_(0, kid, torch.ones_like(kid, dtype=W.dtype))
    safe_counts = torch.where(counts > 0, counts, 1.0)
    means = zeros().index_add_(0, kid, pos_mean[1:] / safe_counts[kid])
    # second pass: the variance about the k-mer mean
    diff = sig[None, :] - means[kid][:, None]  # (N-1, T-1)
    var_num = (W[1:].T[1:] * diff * diff).sum(dim=1)  # (N-1,)
    pos_var = torch.where(den[1:] > 0, var_num / den[1:], 0.0)
    stdevs = torch.sqrt(zeros().index_add_(0, kid, pos_var / safe_counts[kid]))
    return means.cpu().numpy(), stdevs.cpu().numpy()


def _emissions_to_dict(means, stdevs, model) -> dict:
    """Only k-mers with nonzero trained stdev are reported (ref:
    NT.cpp:355-361)."""
    out = {}
    for k in range(model.num_kmers):
        if stdevs[k] != 0.0:
            kmer = int2kmer(k, model.alphabet_size, model.kmer_size, model.rna)
            out[kmer] = (float(means[k]), float(stdevs[k]))
    return out

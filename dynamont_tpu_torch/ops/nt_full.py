"""Full-lattice 2-state NT pair-HMM (counterpart of
dynamont_tpu/ops/nt_full.py): emission scores, the dense T x N forward and
backward lattices, the forward/backward consistency check, the posterior
matrices, the Viterbi choices, the host traceback and the -p output of
dynamont-NT.

The NTC per-read TN pre-pass (ops/ntc_pre.pre_tn) runs the lattices with
the ppTN transitions. The t-loop is a Python loop of torch ops over rows of
N (the JAX package's lax.scan; JAX's full NT has no Pallas kernel), each row
written in place into the (T, N) result; every expression rounds as the JAX
step writes it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dynamont_tpu_torch.constants import EPSILON
from dynamont_tpu_torch.utils.logmath import log_normal_pdf, logsumexp

NEG_INF = -math.inf


class NTMatrices(NamedTuple):
    forM: torch.Tensor  # (T, N)
    forE: torch.Tensor
    backM: torch.Tensor
    backE: torch.Tensor
    Zf: torch.Tensor    # scalar
    Zb: torch.Tensor


def emission_scores(sig, kmer_ids, means, stdevs, *, device,
                    dtype=torch.float64):
    """SC[t, n] = log N(sig[t]; model[kmer_ids[n]]), shape (T-1, N-1)."""
    put = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)
    idx = torch.as_tensor(np.asarray(kmer_ids, np.int64), device=device)
    sig = put(sig)
    mu = put(means)[idx]
    sd = put(stdevs)[idx]
    return log_normal_pdf(sig[:, None], mu[None, :], sd[None, :])


def make_nt_forward(log_m1, log_e2):
    def forward(scores):
        """(M, E), each (T, N), from scores (T-1, N-1)."""
        Tm1, Nm1 = scores.shape
        M = torch.full((Tm1 + 1, Nm1 + 1), NEG_INF, dtype=scores.dtype,
                       device=scores.device)
        E = M.clone()
        E[0, 0] = 0.0
        for t in range(Tm1):
            sc = scores[t]
            # M[t, 1:] = E[t-1, 0:N-1] + sc + m1
            M[t + 1, 1:] = E[t, :-1] + sc + log_m1
            E[t + 1, 1:] = torch.logaddexp(M[t, 1:] + sc,
                                           E[t, 1:] + sc + log_e2)
        return M, E

    return forward


def make_nt_backward(log_m1, log_e2):
    def backward(scores):
        """(M, E), each (T, N), from scores (T-1, N-1)."""
        Tm1, Nm1 = scores.shape
        N = Nm1 + 1
        M = torch.full((Tm1 + 1, N), NEG_INF, dtype=scores.dtype,
                       device=scores.device)
        E = M.clone()
        E[Tm1, N - 1] = 0.0
        for t in range(Tm1 - 1, -1, -1):
            sc = scores[t]
            # ext[n] = M[t+1, n+1] + sc[t, n] + m1 for n < N-1; the n >= 1
            # terms use sc[t, n-1]
            ext = torch.full((N,), NEG_INF, dtype=scores.dtype,
                             device=scores.device)
            ext[:-1] = M[t + 1, 1:] + sc + log_m1
            M[t, 1:] = E[t + 1, 1:] + sc
            ext[1:] = torch.logaddexp(ext[1:], E[t + 1, 1:] + sc + log_e2)
            E[t] = ext
        return M, E

    return backward


def check_z(Zf, Zb, n_cells) -> bool:
    """Forward/backward consistency invariant (ref: NT_main.cpp:146)."""
    Zf = float(Zf)
    Zb = float(Zb)
    if math.isinf(Zf) or math.isinf(Zb):
        return False
    return abs(Zf - Zb) / n_cells <= EPSILON


def nt_forward_backward(scores, m1: float, e2: float) -> NTMatrices:
    """Both passes; m1/e2 are probabilities (logs taken here)."""
    log_m1, log_e2 = math.log(m1), math.log(e2)
    forM, forE = make_nt_forward(log_m1, log_e2)(scores)
    backM, backE = make_nt_backward(log_m1, log_e2)(scores)
    return NTMatrices(forM, forE, backM, backE, forE[-1, -1], backE[0, 0])


def posterior_matrices(mats: NTMatrices):
    """LPM/LPE = for + back - Zb (ref: utils.cpp:506-513): the reference
    passes the backward Z into logP."""
    Z = mats.Zb
    return mats.forM + mats.backM - Z, mats.forE + mats.backE - Z


def nt_viterbi_choices(LPM, LPE):
    """(T, N) bool traceback predicate of the max-recurrence over the
    posteriors (ref: NT.cpp:100-131): choice[t, n] = (E[t, n] ==
    M[t-1, n] + LPE[t, n]), add-then-max; True selects the M predecessor,
    ties included (ref: NT.cpp:173)."""
    T, N = LPM.shape
    choices = torch.zeros((T, N), dtype=torch.bool, device=LPM.device)
    M = torch.full((N,), NEG_INF, dtype=LPM.dtype, device=LPM.device)
    E = M.clone()
    E[0] = 0.0
    for t in range(1, T):
        M_new = torch.full_like(M, NEG_INF)
        M_new[1:] = E[:-1] + LPM[t, 1:]
        m_arm = M[1:] + LPE[t, 1:]
        e_arm = E[1:] + LPE[t, 1:]
        E_new = torch.full_like(E, NEG_INF)
        E_new[1:] = torch.maximum(m_arm, e_arm)
        choices[t, 1:] = E_new[1:] == m_arm
        M, E = M_new, E_new
    return choices


def nt_traceback(choices: np.ndarray, LPM: np.ndarray, LPE: np.ndarray,
                 kmer_size: int):
    """Host MAP walk (ref: NT.cpp:146-177) over the log posteriors, as the
    JAX package walks them: each visited cell's probability math.exp(lp) in
    float64, the segment's median by np.median. Returns segments
    (state, basepos, start_t, median_prob) in read order; the state is
    always 'M' in the NT model."""
    T, N = choices.shape
    t, n = T - 1, N - 1
    is_m = False
    seg_probs: list[float] = []
    segments: list[tuple[str, int, int, float]] = []
    while t and n:
        if is_m:
            seg_probs.append(math.exp(LPM[t, n]))
            segments.append(("M", n - 1 + kmer_size // 2, t - 1,
                             float(np.median(seg_probs))))
            seg_probs.clear()
            t -= 1
            n -= 1
            is_m = False
        else:
            seg_probs.append(math.exp(LPE[t, n]))
            is_m = bool(choices[t, n])
            t -= 1
    segments.reverse()
    return segments


def per_t_border_logprob(LPM):
    """-p output: the logsumexp of each LPM row (ref: NT_main.cpp:227-238)."""
    return logsumexp(LPM, dim=1)

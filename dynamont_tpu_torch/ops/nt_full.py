"""Full-lattice 2-state NT pair-HMM (counterpart of
dynamont_tpu/ops/nt_full.py): emission scores, the dense T x N forward and
backward lattices, and the forward/backward consistency check.

The NTC per-read TN pre-pass (ops/ntc_pre.pre_tn) runs these with the
ppTN transitions. The t-loop is a Python loop of torch ops over rows of N
(the JAX package's lax.scan), each row written in place into the (T, N)
result; every expression rounds as the JAX step writes it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dynamont_tpu_torch.constants import EPSILON
from dynamont_tpu_torch.utils.logmath import log_normal_pdf

NEG_INF = -math.inf


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

"""NTC MAP segmentation (counterpart of dynamont_tpu/ops/ntc_viterbi.py):
the max-DP over posteriors and the 5-state traceback with polish (MAP
k-mer) output (ref: src/cpp/NTC.cpp:595-904).

The max-DP shares the candidate layout and slot maps of the forward pass
(torch, a loop over t). The walk runs on the host over numpy copies and
replicates the reference's equality checks in their exact order; it calls
the native walker (the port's copy, dynamont_tpu_torch/native.py) and falls back to
the Python walk when the library is missing or reports an inconsistency,
as the JAX package does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dynamont_tpu_torch.utils.kmer import int2kmer
from dynamont_tpu_torch.ops.ntc_dp import (
    A, E, I, NEG_INF, P, S, NTCPlan, _Chains, _column0, _Gather,
    _gather_cols, _gather_rows,
)


def ntc_max_dp(plan: NTCPlan, logp, N: int):
    """Viterbi-style max recurrence over posterior log-probs
    (ref: NTC.cpp:595-653). logp: (T, 5, CN, CK). Returns APSEI same shape."""
    T = plan.cand_n.shape[0]
    dtype = logp.dtype
    g_same, g_prev = _Gather(plan.row_same), _Gather(plan.row_prev)
    c_same, c_prec = _Gather(plan.col_same), _Gather(plan.col_prec)
    mask = plan.allowed & (plan.cand_n >= 1)[:, :, None]
    chains = _Chains(plan, N)
    mx = torch.maximum

    def fold_max(terms):
        acc = terms[..., 0]
        for ai in range(1, terms.shape[-1]):
            acc = mx(acc, terms[..., ai])
        return acc

    out = torch.empty_like(logp)
    out[0] = _column0(plan, 0, 0, dtype)
    for t in range(1, T):
        prev = out[t - 1]
        lp = logp[t]
        ge_same = _gather_rows(prev, g_same, t)
        ge_prev = _gather_rows(prev, g_prev, t)
        gp = _gather_cols(ge_prev, c_prec, t)
        gs = _gather_cols(ge_same, c_prec, t)
        a_new = fold_max(mx(gp[E], gp[I])) + lp[A]
        p_new = fold_max(mx(gs[S], mx(gs[E], gs[I]))) + lp[P]
        gpk = _gather_cols(ge_prev, c_same, t)
        s_new = mx(gpk[P], mx(gpk[E], gpk[I])) + lp[S]
        gsk = _gather_cols(ge_same, c_same, t)
        e_new = mx(mx(gsk[A], gsk[P]), mx(gsk[S], gsk[E])) + lp[E]
        col = out[t]
        m = mask[t]
        col[A] = torch.where(m, a_new, NEG_INF)
        col[P] = torch.where(m, p_new, NEG_INF)
        col[S] = torch.where(m, s_new, NEG_INF)
        col[E] = torch.where(m, e_new, NEG_INF)
        # I chain as in ntc_dp.ntc_forward; max(E[i-1], -inf) == E[i-1]
        col[I] = NEG_INF
        i_prev = None
        for i in range(1, int(chains.cnt[t])):
            if not chains.fwd[t, i]:
                i_prev = None
                continue
            term = col[E, i - 1] if i_prev is None else mx(col[E, i - 1], i_prev)
            i_prev = torch.where(plan.allowed[t, i], term + lp[I, i], NEG_INF)
            col[I, i] = i_prev
    return out


class _SparseView:
    """Host-side (t, n, k) -> (state values) lookup over the slot layout;
    missing cells read as -inf, mirroring unordered_map defaults."""

    def __init__(self, cand_n, ks, allowed, dense: np.ndarray):
        self.cand_n, self.ks, self.allowed = cand_n, ks, allowed
        self.dense = dense  # (T, 5, CN, CK)
        self._maps = {}

    def _tmap(self, t):
        m = self._maps.get(t)
        if m is None:
            m = {}
            cn, ks, al = self.cand_n[t], self.ks[t], self.allowed[t]
            for i, n in enumerate(cn):
                for j, k in enumerate(ks):
                    if al[i, j]:
                        m[(int(n), int(k))] = (i, j)
            self._maps[t] = m
        return m

    def get(self, t, n, k, state):
        if t < 0 or t >= self.dense.shape[0]:
            return -math.inf
        ij = self._tmap(t).get((n, k))
        if ij is None:
            return -math.inf
        return float(self.dense[t, state, ij[0], ij[1]])


def _prec_kmers(k, alphabet_size, K):
    step = K // alphabet_size
    return [k // alphabet_size + j * step for j in range(alphabet_size)]


def ntc_traceback(plan: NTCPlan, apsei, logp, T: int, N: int, K: int, model):
    """5-state walk (ref: NTC.cpp:691-904). apsei/logp: (T, 5, CN, CK)
    tensors or arrays. Returns segments in read order:
    [(state 'M'|'P', basepos, start_t, median_prob, polish_kmer_str)]."""
    apsei = torch.as_tensor(apsei).cpu().numpy()
    logp = torch.as_tensor(logp).cpu().numpy()
    cand_n = plan.cand_n.cpu().numpy()
    ks = plan.ks.cpu().numpy()
    allowed = plan.allowed.cpu().numpy()
    live = plan.live.cpu().numpy()
    alphabet_size = model.alphabet_size
    half = model.kmer_size // 2

    # final k: max over allowed k of APSEI[T-1, N-1, k][E], ties -> last
    # (ref '>=' update, NTC.cpp:656-664 iterates k ascending)
    best_v, best_k = -math.inf, None
    for i, n in enumerate(cand_n[T - 1]):
        if n != N - 1:
            continue
        for j, k in enumerate(ks[T - 1]):
            if allowed[T - 1, i, j] and live[T - 1, j]:
                v = float(apsei[T - 1, E, i, j])
                if v >= best_v:
                    best_v, best_k = v, int(k)
    if best_k is None:
        return []

    from dynamont_tpu_torch import native as _native

    nat = _native.ntc_traceback_native(
        apsei, logp, cand_n, ks, allowed, T, N, K, alphabet_size,
        model.kmer_size, best_k,
    )
    if nat is not None:
        return [
            ("M" if st == 0 else "P", basepos, start, med,
             int2kmer(pk, alphabet_size, model.kmer_size, model.rna))
            for st, basepos, start, med, pk in nat
        ]
    return _walk(_SparseView(cand_n, ks, allowed, apsei),
                 _SparseView(cand_n, ks, allowed, logp), T, N, K, best_k,
                 model, half)


def _walk(ap: _SparseView, lp: _SparseView, T, N, K, best_k, model, half):
    """The Python walk (the native walker's fallback)."""
    alphabet_size = model.alphabet_size
    t, n, k = T - 1, N - 1, best_k
    state = E
    seg_probs: list[float] = []
    segments: list[tuple] = []

    def kmer_str(kk):
        return int2kmer(kk, alphabet_size, model.kmer_size, model.rna)

    def emit(front_state, basepos, start):
        probs = sorted(seg_probs)
        m = len(probs)
        med = probs[m // 2] if m % 2 == 1 else 0.5 * (probs[m // 2 - 1] + probs[m // 2])
        segments.append((front_state, basepos, start, med, kmer_str(k)))
        seg_probs.clear()

    guard = 0
    while t:
        guard += 1
        if guard > 2 * (T + N) + 10:
            raise RuntimeError("NTC traceback did not terminate")
        if state == E:
            if t == 1:
                emit("M", half, 0)
                break
            sc = ap.get(t, n, k, E)
            ls = lp.get(t, n, k, E)
            seg_probs.append(math.exp(ls))
            if sc == ap.get(t - 1, n, k, E) + ls:
                state = E
            elif sc == ap.get(t - 1, n, k, A) + ls:
                state = A
            elif sc == ap.get(t - 1, n, k, S) + ls:
                state = S
            elif sc == ap.get(t - 1, n, k, P) + ls:
                state = P
            else:
                raise RuntimeError(f"backtrace error in E at t={t} n={n} k={k}")
            t -= 1
        elif state == A:
            if t == 1 and n == 1:
                emit("M", half, 0)
                break
            sc = ap.get(t, n, k, A)
            ls = lp.get(t, n, k, A)
            seg_probs.append(math.exp(ls))
            matched = False
            for pre in _prec_kmers(k, alphabet_size, K):
                if sc == ap.get(t - 1, n - 1, pre, E) + ls:
                    emit("M", n - 1 + half, t - 1)
                    state = E
                elif sc == ap.get(t - 1, n - 1, pre, I) + ls:
                    emit("M", n - 1 + half, t - 1)
                    state = I
                else:
                    continue
                t -= 1
                n -= 1
                k = pre
                matched = True
                break
            if not matched:
                raise RuntimeError(f"backtrace error in A at t={t} n={n} k={k}")
        elif state == P:
            if t == 1:
                emit("P", half, 0)
                break
            sc = ap.get(t, n, k, P)
            ls = lp.get(t, n, k, P)
            seg_probs.append(math.exp(ls))
            matched = False
            for pre in _prec_kmers(k, alphabet_size, K):
                if sc == ap.get(t - 1, n, pre, E) + ls:
                    emit("P", n - 1 + half, t - 1)
                    state = E
                elif sc == ap.get(t - 1, n, pre, S) + ls:
                    emit("P", n - 1 + half, t - 1)
                    state = S
                elif sc == ap.get(t - 1, n, pre, I) + ls:
                    emit("P", n - 1 + half, t - 1)
                    state = I
                else:
                    continue
                t -= 1
                k = pre
                matched = True
                break
            if not matched:
                raise RuntimeError(f"backtrace error in P at t={t} n={n} k={k}")
        elif state == S:
            if t == 1 and n == 1:
                break
            sc = ap.get(t, n, k, S)
            ls = lp.get(t, n, k, S)
            seg_probs.append(math.exp(ls))
            if sc == ap.get(t - 1, n - 1, k, E) + ls:
                state = E
            elif sc == ap.get(t - 1, n - 1, k, P) + ls:
                state = P
            elif sc == ap.get(t - 1, n - 1, k, I) + ls:
                state = I
            t -= 1
            n -= 1
        elif state == I:
            if n == 1:
                break
            sc = ap.get(t, n, k, I)
            ls = lp.get(t, n, k, I)
            seg_probs.append(math.exp(ls))
            # two plain ifs in the reference: an E match overrides I
            if sc == ap.get(t, n - 1, k, I) + ls:
                state = I
            if sc == ap.get(t, n - 1, k, E) + ls:
                state = E
            n -= 1
    segments.reverse()
    return segments

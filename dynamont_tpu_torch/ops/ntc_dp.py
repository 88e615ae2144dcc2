"""NTC 5-state sparse 3D DP (counterpart of dynamont_tpu/ops/ntc_dp.py;
ref: src/cpp/NTC.cpp:417-578) on the static candidate-slot layout.

Per t: CN n-slots (the sorted TN candidates, sentinel-padded) and CK
k-slots (the sorted merge of the TK candidates and the baselines
{kmerSeq[n-1] : n in tnMap[t]}; duplicates keep their slot but are masked
dead). Cell (t, i, j) is allowed iff k_j is a TK candidate or
k_j == kmerSeq[n_i - 1]. States per cell: A(lign) P(olish) S(equence)
E(xtend) I(nsert) (ref: NTC.cpp:699-703). Cross-column predecessors are
resolved through precomputed slot maps (-1 if absent); the I-state's
in-column chain runs as a loop over the CN n-slots.

The JAX package runs these recurrences as XLA scans, outside Pallas; here
they are Python loops over t of torch ops on (5, CN, CK) columns. Whatever
does not depend on the carried column (scores, Hamming terms, clipped slot
indices and masks) is computed for all t at once before the loop: the same
elementwise operations, so the same values. The logsumexp over the A
predecessors folds in the JAX order, ai = 0..A-1, starting from the first
term (logaddexp(-inf, x) == x exactly in both frameworks).

Deviation from the reference (as in the JAX package): the n=0 baseline
that reads kmerSeq[-1] is skipped.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dynamont_tpu_torch.utils.logmath import log_normal_pdf_c, logsumexp

NEG_INF = -math.inf

# state indices (ref: NTC.cpp:699-703)
A, P, S, E, I = 0, 1, 2, 3, 4


class NTCPlan(NamedTuple):
    """Static-shaped sparse lattice description for one read."""

    cand_n: torch.Tensor   # (T, CN) sorted n-candidates, sentinel N
    cnt_n: torch.Tensor    # (T,)
    ks: torch.Tensor       # (T, CK) sorted merged k-slots, sentinel K
    live: torch.Tensor     # (T, CK) bool: first occurrence and not sentinel
    from_tk: torch.Tensor  # (T, CK) bool: value is in tkMap[t]
    allowed: torch.Tensor  # (T, CN, CK) bool cell mask
    mu_k: torch.Tensor     # (T, CK) model mean of k_j
    c1_k: torch.Tensor
    c2_k: torch.Tensor
    kN: torch.Tensor       # (T, CN) kmerSeq[n_i - 1] (0 where invalid)
    mu_n: torch.Tensor
    c1_n: torch.Tensor
    c2_n: torch.Tensor
    kN2: torch.Tensor      # (T, CN) kmerSeq[n_i] (0 where invalid)
    mu_n2: torch.Tensor
    c1_n2: torch.Tensor
    c2_n2: torch.Tensor
    row_same: torch.Tensor  # (T, CN) slot of n_i in cand_n[t-1]
    row_prev: torch.Tensor  # (T, CN) slot of n_i - 1 in cand_n[t-1]
    col_same: torch.Tensor  # (T, CK) slot of k_j in ks[t-1]
    col_prec: torch.Tensor  # (T, CK, A) slot of prec_a(k_j) in ks[t-1]
    brow_same: torch.Tensor  # (T, CN) slot of n_i in cand_n[t+1]
    brow_next: torch.Tensor  # (T, CN) slot of n_i + 1 in cand_n[t+1]
    bcol_same: torch.Tensor  # (T, CK) slot of k_j in ks[t+1]
    bcol_suc: torch.Tensor   # (T, CK, A) slot of suc_a(k_j) in ks[t+1]
    suc_vals: torch.Tensor   # (T, CK, A) successor k-mer values
    mu_suc: torch.Tensor     # (T, CK, A)
    c1_suc: torch.Tensor
    c2_suc: torch.Tensor


def hamming2(a, b, alphabet_size: int, kmer_size: int):
    """-2 * HammingDistance over base digits (ref: NTC.hpp:51-76), as
    float32 like the JAX function (exact small integers)."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape),
                      dtype=torch.int32, device=a.device)
    x, y = a, b
    for _ in range(kmer_size):
        acc = acc + ((x % alphabet_size) != (y % alphabet_size)).to(torch.int32)
        x = x // alphabet_size
        y = y // alphabet_size
    return (-2 * acc).to(torch.float32)


def _slots(values, table):
    """Slot of each value in its row of `table` (rows sorted ascending):
    the first matching position, -1 where absent (the JAX eq-broadcast
    argmax, by binary search). values (T, ...), table (T, W)."""
    T, W = table.shape
    v = values.reshape(T, -1).contiguous()
    pos = torch.searchsorted(table.contiguous(), v)
    hit = torch.gather(table, 1, pos.clamp(max=W - 1)) == v
    found = (pos < W) & hit
    return torch.where(found, pos, -1).reshape(values.shape)


def build_plan(cand_n, cnt_n, cand_k0, cnt_k, kmer_seq, means, c1, c2,
               alphabet_size: int, kmer_size: int,
               dtype=torch.float64) -> NTCPlan:
    """Merge pre-pass candidates into the static lattice description.

    cand_n (T, CN) sorted asc with sentinel N; cand_k0 (T, CK0) sorted asc
    with sentinel K; kmer_seq (N-1,) integer tensor; means/c1/c2 (K,).
    """
    dev = cand_n.device
    cand_n = cand_n.long()
    cand_k0 = cand_k0.long()
    kmer_seq = kmer_seq.long()
    T, CN = cand_n.shape
    CK0 = cand_k0.shape[1]
    K = means.shape[0]
    N = kmer_seq.shape[0] + 1
    step = K // alphabet_size
    ar = lambda n: torch.arange(n, device=dev)

    n_valid = ar(CN)[None, :] < cnt_n[:, None]
    n_safe = cand_n.clamp(0, N - 1)
    n_pos = n_valid & (cand_n >= 1)
    kN = torch.where(n_pos, kmer_seq[(n_safe - 1).clamp(0, N - 2)], 0)
    base_k = torch.where(n_pos, kN, K)  # sentinel K when absent

    ks = torch.sort(torch.cat([cand_k0, base_k], dim=1), dim=1).values
    first = torch.cat([torch.ones((T, 1), dtype=torch.bool, device=dev),
                       ks[:, 1:] != ks[:, :-1]], dim=1)
    live = first & (ks < K)
    ck0 = torch.where(ar(CK0)[None, :] < cnt_k[:, None], cand_k0, K)
    from_tk = (ks[:, :, None] == ck0[:, None, :]).any(-1)

    allowed = (
        live[:, None, :]
        & n_valid[:, :, None]
        & (from_tk[:, None, :]
           | ((ks[:, None, :] == kN[:, :, None]) & (cand_n >= 1)[:, :, None]))
    )

    ks_safe = ks.clamp(0, K - 1)
    means = means.to(dtype)
    c1 = c1.to(dtype)
    c2 = c2.to(dtype)
    kN2 = torch.where(n_valid & (cand_n < N - 1),
                      kmer_seq[n_safe.clamp(0, N - 2)], 0)

    suc_vals = ((ks_safe % step) * alphabet_size)[:, :, None] \
        + ar(alphabet_size)[None, None, :]
    prec_vals = (ks_safe // alphabet_size)[:, :, None] \
        + ar(alphabet_size)[None, None, :] * step

    CK = ks.shape[1]
    prev_n = torch.cat([torch.full((1, CN), N, device=dev), cand_n[:-1]], 0)
    prev_ks = torch.cat([torch.full((1, CK), K, device=dev), ks[:-1]], 0)
    next_n = torch.cat([cand_n[1:], torch.full((1, CN), N, device=dev)], 0)
    next_ks = torch.cat([ks[1:], torch.full((1, CK), K, device=dev)], 0)

    return NTCPlan(
        cand_n=cand_n, cnt_n=cnt_n.long(), ks=ks, live=live, from_tk=from_tk,
        allowed=allowed,
        mu_k=means[ks_safe], c1_k=c1[ks_safe], c2_k=c2[ks_safe],
        kN=kN, mu_n=means[kN], c1_n=c1[kN], c2_n=c2[kN],
        kN2=kN2, mu_n2=means[kN2], c1_n2=c1[kN2], c2_n2=c2[kN2],
        row_same=_slots(cand_n, prev_n), row_prev=_slots(cand_n - 1, prev_n),
        col_same=_slots(ks, prev_ks), col_prec=_slots(prec_vals, prev_ks),
        brow_same=_slots(cand_n, next_n), brow_next=_slots(cand_n + 1, next_n),
        bcol_same=_slots(ks, next_ks), bcol_suc=_slots(suc_vals, next_ks),
        suc_vals=suc_vals,
        mu_suc=means[suc_vals], c1_suc=c1[suc_vals], c2_suc=c2[suc_vals],
    )


class _Gather:
    """Clipped slot indices and their validity masks for all t, so each
    step gathers with two tensor ops: the JAX _gather_rows/_gather_cols
    (-inf where the slot is -1)."""

    def __init__(self, idx):
        self.idx = idx.clamp(min=0)
        self.ok = idx >= 0


def _gather_rows(x, g: _Gather, t: int):
    """x (5, CN, CK) -> rows g[t] (CN,) of x, -inf where absent."""
    return torch.where(g.ok[t][None, :, None], x[:, g.idx[t], :], NEG_INF)


def _gather_cols(x, g: _Gather, t: int):
    """x (..., CK) -> columns g[t] (CK,) or (CK, A) of x, -inf where
    absent; (..., CK) or (..., CK, A)."""
    idx, ok = g.idx[t], g.ok[t]
    return torch.where(ok, x[..., idx], NEG_INF)


def _column0(plan: NTCPlan, t: int, n_value: int, dtype):
    """The boundary column: E = 0 at allowed cells of the row holding
    n_value (n = 0 at t = 0, N-1 at t = T-1), -inf elsewhere."""
    CN, CK = plan.allowed.shape[1:]
    col = torch.full((5, CN, CK), NEG_INF, dtype=dtype,
                     device=plan.allowed.device)
    row = (plan.cand_n[t] == n_value)[:, None] & plan.allowed[t]
    col[E] = torch.where(row, 0.0, NEG_INF)
    return col


def _fold(terms):
    """logsumexp over the last dim (the A predecessors or successors),
    folded in ascending order."""
    acc = terms[..., 0]
    for ai in range(1, terms.shape[-1]):
        acc = torch.logaddexp(acc, terms[..., ai])
    return acc


def _forward_scores(plan: NTCPlan, sig, alphabet_size, kmer_size):
    """sc[t] for t = 1..T-1 (row t uses sig[t-1]): (T-1, CN, CK)."""
    x = sig[:, None]
    sc_n = log_normal_pdf_c(x, plan.mu_n[1:], plan.c1_n[1:], plan.c2_n[1:])
    sc_k = log_normal_pdf_c(x, plan.mu_k[1:], plan.c1_k[1:], plan.c2_k[1:])
    hd = hamming2(plan.kN[1:, :, None], plan.ks[1:, None, :], alphabet_size,
                  kmer_size).to(sig.dtype)
    return sc_n[:, :, None] + sc_k[:, None, :] + hd


class _Chains:
    """Host copies of the in-column I-chain flags, so that the I-state
    loops visit only the n-slots a chain reaches. A slot the chain does not
    reach gets exactly what the masked tensor expression gives it: -inf in
    the forward and max-DP (slot 0, slots past the count), or its own
    non-chain value in the backward (logaddexp(x, -inf) == x)."""

    def __init__(self, plan: NTCPlan, N: int):
        cn = plan.cand_n.cpu().numpy()
        self.cnt = plan.cnt_n.cpu().numpy()
        # forward: slot i continues slot i-1 (cand_n[t][i-1] == n_i - 1)
        self.fwd = np.zeros(cn.shape, bool)
        self.fwd[:, 1:] = (cn[:, :-1] == cn[:, 1:] - 1) & (cn[:, 1:] >= 1)
        # backward: slot i takes slot i+1 (n_i + 1), t > 0, n_i < N-1
        self.bwd = np.zeros(cn.shape, bool)
        self.bwd[:, :-1] = (cn[:, 1:] == cn[:, :-1] + 1) & (cn[:, :-1] < N - 1)
        self.bwd[0] = False


def ntc_forward(plan: NTCPlan, sig, trans_log: dict, N: int,
                alphabet_size: int, kmer_size: int):
    """logF (ref: NTC.cpp:417-480). Returns (T, 5, CN, CK) forward values."""
    T, CN = plan.cand_n.shape
    CK = plan.ks.shape[1]
    dtype = sig.dtype
    tl = trans_log
    sc_all = _forward_scores(plan, sig, alphabet_size, kmer_size)
    g_same, g_prev = _Gather(plan.row_same), _Gather(plan.row_prev)
    c_same, c_prec = _Gather(plan.col_same), _Gather(plan.col_prec)
    mask = plan.allowed & (plan.cand_n >= 1)[:, :, None]
    chains = _Chains(plan, N)

    out = torch.empty((T, 5, CN, CK), dtype=dtype, device=sig.device)
    out[0] = _column0(plan, 0, 0, dtype)
    for t in range(1, T):
        prev = out[t - 1]
        sc = sc_all[t - 1]
        ge_same = _gather_rows(prev, g_same, t)     # rows at n_i
        ge_prev = _gather_rows(prev, g_prev, t)     # rows at n_i - 1
        # A: sum over prec kmers of (t-1, n-1, k') states E, I
        # P: sum over prec kmers of (t-1, n,   k') states S, E, I
        gp = _gather_cols(ge_prev, c_prec, t)       # (5, CN, CK, A)
        gs = _gather_cols(ge_same, c_prec, t)
        a_new = _fold(torch.logaddexp(gp[E] + tl["a1"], gp[I] + tl["a2"])) + sc
        p_new = _fold(torch.logaddexp(
            gs[S] + tl["p1"],
            torch.logaddexp(gs[E] + tl["p2"], gs[I] + tl["p3"]))) + sc
        gpk = _gather_cols(ge_prev, c_same, t)
        s_new = torch.logaddexp(
            gpk[P] + tl["s1"],
            torch.logaddexp(gpk[E] + tl["s2"], gpk[I] + tl["s3"])) + sc
        gsk = _gather_cols(ge_same, c_same, t)
        e_new = torch.logaddexp(
            torch.logaddexp(gsk[A], gsk[P] + tl["e2"]),
            torch.logaddexp(gsk[S] + tl["e3"], gsk[E] + tl["e4"])) + sc
        col = out[t]
        m = mask[t]
        col[A] = torch.where(m, a_new, NEG_INF)
        col[P] = torch.where(m, p_new, NEG_INF)
        col[S] = torch.where(m, s_new, NEG_INF)
        col[E] = torch.where(m, e_new, NEG_INF)
        # I: in-column chain over n-slots (ref I terms: NTC.cpp:474-477):
        # logaddexp(E[i-1] + i1, I[i-1] + i2) + sc where slot i continues
        # slot i-1, -inf elsewhere; an unchained I[i-1] is -inf, so the
        # logaddexp leaves E[i-1] + i1 exactly
        col[I] = NEG_INF
        i_prev = None
        for i in range(1, int(chains.cnt[t])):
            if not chains.fwd[t, i]:
                i_prev = None
                continue
            term = col[E, i - 1] + tl["i1"]
            if i_prev is not None:
                term = torch.logaddexp(term, i_prev + tl["i2"])
            i_prev = torch.where(plan.allowed[t, i], term + sc[i], NEG_INF)
            col[I, i] = i_prev
    return out


def ntc_backward(plan: NTCPlan, sig, trans_log: dict, N: int,
                 alphabet_size: int, kmer_size: int):
    """logB (ref: NTC.cpp:495-578). Returns (T, 5, CN, CK)."""
    T, CN = plan.cand_n.shape
    CK = plan.ks.shape[1]
    dtype = sig.dtype
    tl = trans_log
    hd = lambda a, b: hamming2(a, b, alphabet_size, kmer_size).to(dtype)
    x = sig[:, None]
    pl = lambda f: f[:-1]  # rows t = 0..T-2 use sig[t]
    scn = log_normal_pdf_c(x, pl(plan.mu_n), pl(plan.c1_n), pl(plan.c2_n))
    scn2 = log_normal_pdf_c(x, pl(plan.mu_n2), pl(plan.c1_n2), pl(plan.c2_n2))
    sck = log_normal_pdf_c(x, pl(plan.mu_k), pl(plan.c1_k), pl(plan.c2_k))
    kN, kN2, ks = pl(plan.kN), pl(plan.kN2), pl(plan.ks)
    sc1 = scn[:, :, None] + sck[:, None, :] + hd(kN[:, :, None], ks[:, None, :])
    sc2 = scn2[:, :, None] + sck[:, None, :] + hd(kN2[:, :, None],
                                                  ks[:, None, :])
    # successor scores (T-1, CN, CK, A)
    scs = log_normal_pdf_c(x[:, :, None], pl(plan.mu_suc), pl(plan.c1_suc),
                           pl(plan.c2_suc))
    suc = pl(plan.suc_vals)
    sc1s = scn[:, :, None, None] + scs[:, None] \
        + hd(kN[:, :, None, None], suc[:, None])
    sc2s = scn2[:, :, None, None] + scs[:, None] \
        + hd(kN2[:, :, None, None], suc[:, None])
    # same-t I chain (ref: NTC.cpp:565-572): score(sig[t-1], kN2, k); row
    # t = 0 never uses it
    sig_prev = torch.cat([sig[:1] * 0, sig[:-1]])[:, None]
    scn2_m1 = log_normal_pdf_c(sig_prev, pl(plan.mu_n2), pl(plan.c1_n2),
                               pl(plan.c2_n2))
    sck_m1 = log_normal_pdf_c(sig_prev, pl(plan.mu_k), pl(plan.c1_k),
                              pl(plan.c2_k))
    sc_i = scn2_m1[:, :, None] + sck_m1[:, None, :] \
        + hd(kN2[:, :, None], ks[:, None, :])

    cn = plan.cand_n
    n_pos = (cn >= 1)[:, :, None]
    n_lt = (cn < N - 1)[:, :, None]
    chains = _Chains(plan, N)
    b_same, b_next = _Gather(plan.brow_same), _Gather(plan.brow_next)
    c_same, c_suc = _Gather(plan.bcol_same), _Gather(plan.bcol_suc)

    out = torch.empty((T, 5, CN, CK), dtype=dtype, device=sig.device)
    out[T - 1] = _column0(plan, T - 1, N - 1, dtype)
    where = lambda c, v: torch.where(c, v, NEG_INF)
    for t in range(T - 2, -1, -1):
        nxt = out[t + 1]
        gn_same = _gather_rows(nxt, b_same, t)      # (t+1, n, .)
        gn_next = _gather_rows(nxt, b_next, t)      # (t+1, n+1, .)
        gsk = _gather_cols(gn_same, c_same, t)      # (t+1, n, k)
        gnk = _gather_cols(gn_next, c_same, t)      # (t+1, n+1, k)
        gsp = _gather_cols(gn_same, c_suc, t)       # (5, CN, CK, A)
        gna = _gather_cols(gn_next, c_suc, t)
        s1, s2, s1s, s2s = sc1[t], sc2[t], sc1s[t], sc2s[t]
        np_, nl = n_pos[t], n_lt[t]
        npa, nla = np_[..., None], nl[..., None]

        a_new = where(np_, gsk[E] + s1)
        p_new = torch.logaddexp(where(np_, gsk[E] + tl["e2"] + s1),
                                where(nl, gnk[S] + tl["s1"] + s2))
        # the successor sums fold in the JAX order: the non-successor term
        # first, then per ai the P-terms and, for E/I, the A-term
        p1 = where(npa, gsp[P] + tl["p1"] + s1s)
        p2 = where(npa, gsp[P] + tl["p2"] + s1s)
        p3 = where(npa, gsp[P] + tl["p3"] + s1s)
        a1 = where(nla, gna[A] + tl["a1"] + s2s)
        a2 = where(nla, gna[A] + tl["a2"] + s2s)
        s_acc = where(np_, gsk[E] + tl["e3"] + s1)
        e_acc = where(np_, gsk[E] + tl["e4"] + s1)
        i_acc = torch.full((CN, CK), NEG_INF, dtype=dtype, device=sig.device)
        for ai in range(alphabet_size):
            s_acc = torch.logaddexp(s_acc, p1[..., ai])
            e_acc = torch.logaddexp(e_acc, p2[..., ai])
            i_acc = torch.logaddexp(i_acc, p3[..., ai])
            e_acc = torch.logaddexp(e_acc, a1[..., ai])
            i_acc = torch.logaddexp(i_acc, a2[..., ai])
        e_new = torch.logaddexp(e_acc, where(nl, gnk[S] + tl["s2"] + s2))
        i_new = torch.logaddexp(i_acc, where(nl, gnk[S] + tl["s3"] + s2))

        # same-t I chain, from the last n-slot down (ref: NTC.cpp:565-572):
        # slot i adds I[i+1] + i2 (+ i1 for E) + sc(sig[t-1], kN2, k) where
        # it takes slot i+1 (the last counted slot never does: its partner
        # would be a sentinel)
        sci = sc_i[t]
        for i in range(int(chains.cnt[t]) - 2, -1, -1):
            if chains.bwd[t, i]:
                below = i_new[i + 1]
                i_new[i] = torch.logaddexp(i_new[i], below + tl["i2"] + sci[i])
                e_new[i] = torch.logaddexp(e_new[i], below + tl["i1"] + sci[i])
        al = plan.allowed[t]
        col = out[t]
        col[A] = where(al, a_new)
        col[P] = where(al, p_new)
        col[S] = where(al, s_acc)
        col[E] = where(al, e_new)
        col[I] = where(al, i_new)
    return out


def ntc_z(plan: NTCPlan, forward, backward, N: int):
    """Zf over E at (T-1, N-1, k), Zb over E at (0, 0, k)
    (ref: NTC_main.cpp:152-158). Dead/duplicate slots excluded."""
    rowN = (plan.cand_n[-1][:, None] == N - 1) & plan.allowed[-1] \
        & plan.live[-1][None, :]
    Zf = logsumexp(torch.where(rowN, forward[-1, E], NEG_INF))
    row0 = (plan.cand_n[0][:, None] == 0) & plan.allowed[0] \
        & plan.live[0][None, :]
    Zb = logsumexp(torch.where(row0, backward[0, E], NEG_INF))
    return Zf, Zb

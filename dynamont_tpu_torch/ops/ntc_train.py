"""NTC Baum-Welch updates (counterpart of dynamont_tpu/ops/ntc_train.py):
the 14 transition parameters and the k-mer emissions (ref:
src/cpp/NTC.cpp:923-1130).

All reductions run over the whole (T, CN, CK) candidate lattice at once
(the JAX package vmaps a per-t function over t): masked logsumexps per t,
then over t, with successor lookups through the plan's backward slot maps.
"""

from __future__ import annotations

import math

import torch

from dynamont_tpu_torch.utils.kmer import int2kmer
from dynamont_tpu_torch.ops.ntc_dp import A, E, I, NEG_INF, P, S, NTCPlan, hamming2
from dynamont_tpu_torch.utils.logmath import log_normal_pdf_c, logsumexp

TRAIN_THRESHOLD = 1e-7  # ref: NTC.cpp:1101


def _lse_t(x):
    """Per-t logsumexp over every non-t axis: (T, ...) -> (T,)."""
    return logsumexp(x.reshape(x.shape[0], -1), dim=1)


def train_transitions(plan: NTCPlan, sig, fwd, bwd, logp, trans_log, Zf, N,
                      alphabet_size: int, kmer_size: int) -> dict:
    """trainTransition (ref: NTC.cpp:923-1045). Returns probabilities."""
    T, CN = plan.cand_n.shape
    CK = plan.ks.shape[1]
    dtype = sig.dtype
    tl = trans_log
    hd = lambda a, b: hamming2(a, b, alphabet_size, kmer_size).to(dtype)
    pl = lambda f: f[:-1]
    x = sig[:, None]
    scn = log_normal_pdf_c(x, pl(plan.mu_n), pl(plan.c1_n), pl(plan.c2_n))
    scn2 = log_normal_pdf_c(x, pl(plan.mu_n2), pl(plan.c1_n2), pl(plan.c2_n2))
    sck = log_normal_pdf_c(x, pl(plan.mu_k), pl(plan.c1_k), pl(plan.c2_k))
    kN, kN2, ks = pl(plan.kN), pl(plan.kN2), pl(plan.ks)
    sc1 = scn[:, :, None] + sck[:, None, :] + hd(kN[:, :, None], ks[:, None, :])
    sc2 = scn2[:, :, None] + sck[:, None, :] + hd(kN2[:, :, None],
                                                  ks[:, None, :])

    b_next = bwd[1:]                                   # (T-1, 5, CN, CK)
    tt = torch.arange(T - 1, device=sig.device)

    def rows(idx):
        """b_next rows at slot idx (T-1, CN): (T-1, 5, CN, CK), -inf absent."""
        g = b_next[tt[:, None], :, idx.clamp(min=0)]   # (T-1, CN, 5, CK)
        return torch.where((idx >= 0)[:, :, None, None], g,
                           NEG_INF).permute(0, 2, 1, 3)

    def cols(x5, idx):
        """x5 (T-1, 5, CN, CK) at column slots idx (T-1, CK[, A])."""
        flat = idx.clamp(min=0).reshape(T - 1, -1)
        g = torch.gather(x5, 3, flat[:, None, None, :].expand(
            -1, 5, CN, -1)).reshape(*x5.shape[:3], *idx.shape[1:])
        ok = (idx >= 0)[:, None, None]
        return torch.where(ok, g, NEG_INF)

    gn_same = rows(pl(plan.brow_same))
    gn_next = rows(pl(plan.brow_next))
    gsk = cols(gn_same, pl(plan.bcol_same))
    gnk = cols(gn_next, pl(plan.bcol_same))
    f_t = fwd[:-1]
    allowed = pl(plan.allowed)
    n_pos = (pl(plan.cand_n) >= 1)[:, :, None] & allowed
    n_lt = (pl(plan.cand_n) < N - 1)[:, :, None] & allowed
    where = lambda c, v: torch.where(c, v, NEG_INF)

    terms = {
        "e2": where(n_pos, f_t[:, P] + tl["e2"] + sc1 + gsk[:, E]),
        "e3": where(n_pos, f_t[:, S] + tl["e3"] + sc1 + gsk[:, E]),
        "e4": where(n_pos, f_t[:, E] + tl["e4"] + sc1 + gsk[:, E]),
        "s1": where(n_lt, f_t[:, P] + tl["s1"] + sc2 + gnk[:, S]),
        "s2": where(n_lt, f_t[:, E] + tl["s2"] + sc2 + gnk[:, S]),
        "s3": where(n_lt, f_t[:, I] + tl["s3"] + sc2 + gnk[:, S]),
    }
    scs = log_normal_pdf_c(x[:, :, None], pl(plan.mu_suc), pl(plan.c1_suc),
                           pl(plan.c2_suc))            # (T-1, CK, A)
    suc = pl(plan.suc_vals)
    sc1s = scn[:, :, None, None] + scs[:, None] \
        + hd(kN[:, :, None, None], suc[:, None])
    sc2s = scn2[:, :, None, None] + scs[:, None] \
        + hd(kN2[:, :, None, None], suc[:, None])
    gsp = cols(gn_same, pl(plan.bcol_suc))             # (T-1, 5, CN, CK, A)
    gna = cols(gn_next, pl(plan.bcol_suc))
    npa, nla = n_pos[..., None], n_lt[..., None]
    fa = f_t[..., None]
    suc_terms = {
        "p1": where(npa, fa[:, S] + tl["p1"] + sc1s + gsp[:, P]),
        "p2": where(npa, fa[:, E] + tl["p2"] + sc1s + gsp[:, P]),
        "p3": where(npa, fa[:, I] + tl["p3"] + sc1s + gsp[:, P]),
        "a1": where(nla, fa[:, E] + tl["a1"] + sc2s + gna[:, A]),
        "a2": where(nla, fa[:, I] + tl["a2"] + sc2s + gna[:, A]),
    }
    for name, v in suc_terms.items():
        # the JAX per-t function folds the A successors with logaddexp in
        # ascending order from -inf before its logsumexp over the cells
        acc = torch.full(v.shape[:-1], NEG_INF, dtype=dtype, device=sig.device)
        for ai in range(alphabet_size):
            acc = torch.logaddexp(acc, v[..., ai])
        terms[name] = acc
    # keys in sorted order, as the JAX vmap returns its dict (a pytree), so
    # that the train output lists the parameters in the same order
    acc = {k: float(logsumexp(_lse_t(terms[k]))) for k in sorted(terms)}

    # i1/i2: within-column terms over t in [1, T-1] (ref: NTC.cpp:990-999)
    # pv = backAPSEI[t, n+1, k][I]; contiguity means slot i+1 holds n+1
    cn = plan.cand_n[1:]
    chain = torch.cat([cn[:, 1:] == cn[:, :-1] + 1,
                       torch.zeros((T - 1, 1), dtype=torch.bool,
                                   device=sig.device)], dim=1)
    sck_i = log_normal_pdf_c(x, plan.mu_k[1:], plan.c1_k[1:], plan.c2_k[1:])
    scn2_i = log_normal_pdf_c(x, plan.mu_n2[1:], plan.c1_n2[1:], plan.c2_n2[1:])
    sc_i = scn2_i[:, :, None] + sck_i[:, None, :] \
        + hd(plan.kN2[1:, :, None], plan.ks[1:, None, :])
    bI = bwd[1:, I]
    bI_up = torch.cat([bI[:, 1:, :],
                       torch.full((T - 1, 1, CK), NEG_INF, dtype=dtype,
                                  device=sig.device)], dim=1)
    ok = chain[:, :, None] & plan.allowed[1:] & (cn < N - 1)[:, :, None]
    f_slice = fwd[1:]
    acc["i1"] = float(logsumexp(where(ok, f_slice[:, E] + tl["i1"] + sc_i + bI_up)))
    acc["i2"] = float(logsumexp(where(ok, f_slice[:, I] + tl["i2"] + sc_i + bI_up)))

    # normalization groups (ref: NTC.cpp:1003-1030)
    def lsum(vals):
        fin = [v for v in vals if not math.isinf(v)]
        if not fin:
            return -math.inf
        m = max(fin)
        return m + math.log(sum(math.exp(v - m) for v in vals if not math.isinf(v)))

    out = dict(acc)
    for group in (("a1", "s2", "e4", "i1", "p2"), ("e3", "p1"), ("e2", "s1"),
                  ("a2", "i2", "p3", "s3")):
        norm = lsum([acc[k] for k in group])
        if not math.isinf(norm):
            for k in group:
                out[k] = acc[k] - norm
    result = {k: math.exp(v) for k, v in out.items()}
    result["e1"] = 1.0
    return result


def train_emissions(plan: NTCPlan, sig, logp, model) -> dict:
    """trainEmission (ref: NTC.cpp:1059-1130)."""
    T = logp.shape[0]
    K = model.num_kmers
    dtype = sig.dtype
    # w over the 5 states, allowed cells with t >= 1
    lw = logp[:, A]
    for st in (P, S, E, I):
        lw = torch.logaddexp(lw, logp[:, st])
    t_ok = (torch.arange(T, device=sig.device) >= 1)[:, None, None]
    w = torch.where(plan.allowed & t_ok, torch.exp(lw), 0.0)
    w = torch.nan_to_num(w, nan=0.0, posinf=0.0)
    sig_pad = torch.cat([torch.zeros((1,), dtype=dtype, device=sig.device),
                         sig])[:, None, None]         # sig[t-1] at row t
    ks_c = plan.ks.clamp(0, K - 1)
    flat_k = ks_c[:, None, :].expand(plan.allowed.shape).reshape(-1).cpu()

    def kmer_sum(v):
        """Per-k-mer sums in cell order: index_add_ on the host runs one
        add after another, where on a card it would use atomics and two
        runs could differ in the last bit."""
        out = torch.zeros(K, dtype=dtype).index_add_(0, flat_k,
                                                     v.reshape(-1).cpu())
        return out.to(sig.device)

    means_num = kmer_sum(w * sig_pad)
    norm = kmer_sum(w)
    nz = norm != 0
    means = torch.where(nz, means_num / torch.where(nz, norm, 1.0), 0.0)

    keep = norm >= TRAIN_THRESHOLD
    diff = sig_pad - means[ks_c][:, None, :]
    w2 = torch.where(keep[ks_c][:, None, :], w, 0.0)
    var_num = kmer_sum(w2 * diff * diff)
    stdevs = torch.where(nz, torch.sqrt(var_num / torch.where(nz, norm, 1.0)),
                         0.0)

    means = means.cpu().numpy()
    stdevs = stdevs.cpu().numpy()
    out = {}
    for k in range(K):
        if stdevs[k] != 0.0:
            kmer = int2kmer(k, model.alphabet_size, model.kmer_size, model.rna)
            out[kmer] = (float(means[k]), float(stdevs[k]))
    return out

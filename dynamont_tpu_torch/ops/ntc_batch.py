"""Batched NTC pre-pass (counterpart of the pre-pass part of
dynamont_tpu/ops/ntc_batch.py, lines 44-441): the TN and TK 2-state passes
over a padded bucket of reads, and the per-column candidate selection.

One function serves fp32 and fp64. The recurrences run in the kernels of
ops/ntc_pre_kernels (K7-K10) on CUDA tensors and in their plain versions
on CPU tensors; what the JAX package leaves to XLA around its kernels runs
here as torch ops: the 95%-mass crossing, the stable co-sort of the TN
candidates with their k-mer values, and the TK top-cap.

The selection tests each column against its own mass (ref:
NTC.cpp:260-270, 328-341 test against the global Z; equal by the
forward-backward identity, but the global Z drifts from the per-column
sums in fp32 over ~16k steps). The per-read rung (ops/ntc_pre) keeps the
reference's global Z; the two round differently.

Not ported here: the native 9-mer (K = 4^9) branches — the two-stage
top-cap of select_topk and pre_tk_batch_ckpt — which belong to the native
9-mer slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dynamont_tpu_torch.ops import ntc_pre_kernels as kn
from dynamont_tpu_torch.ops.ntc_pre import SPARSE_THRESHOLD
from dynamont_tpu_torch.ops.ntc_pre_kernels import _topk_maxmask
from dynamont_tpu_torch.utils.logmath import logsumexp

NEG_INF = -math.inf


def select_topk(U, cap: int, ge_break: bool, col_live, sentinel: int):
    """Reference column selection on unnormalized posteriors.

    U: (rows, W) combined log-probs f+b. Returns (cand (rows, cap)
    selection-ordered (descending value) with the valid entries as a
    prefix and `sentinel` elsewhere, count, overflow). The top-cap is
    lax.top_k's: descending, ties to the lower index — by iterated
    max-extraction up to cap 16 (as the JAX function), else by a stable
    descending sort (torch.topk does not order ties).
    """
    if cap <= 16:
        vals, idx = _topk_maxmask(U, cap)
    else:
        s = torch.sort(U, dim=-1, descending=True, stable=True)
        vals, idx = s.values[:, :cap], s.indices[:, :cap]
        del s
    m = vals[:, :1]
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    tot = torch.sum(torch.exp(U - m_safe), dim=1, keepdim=True)
    return crossing_from_topk(vals, idx, tot, ge_break, col_live, sentinel)


def crossing_from_topk(vals, idx, tot, ge_break: bool, col_live, sentinel):
    """select_topk's 95%-mass crossing given a descending top-cap (vals,
    idx) and the column's exp-mass `tot` relative to vals[:, :1]."""
    m = vals[:, :1]
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    run = torch.cumsum(torch.exp(vals - m_safe), dim=1)
    thresh = math.exp(SPARSE_THRESHOLD) * tot
    dead = ~torch.isfinite(m)
    crossed = (run >= thresh if ge_break else run > thresh) & ~dead
    prev = torch.cat([torch.zeros_like(crossed[:, :1]), crossed[:, :-1]],
                     dim=1)
    included = (~prev) & col_live[:, None]
    count = included.sum(dim=1).to(torch.int32)
    overflow = col_live & (~crossed[:, -1])
    cand = torch.where(included, idx, sentinel)
    return cand.to(torch.int32), count, overflow


class PreBatchResult(NamedTuple):
    cand: torch.Tensor      # (T, R, C) int32 (TN ascending, TK selection order)
    cnt: torch.Tensor       # (T, R) int32
    Zf: torch.Tensor        # (R,)
    Zb: torch.Tensor        # (R,)
    overflow: torch.Tensor  # (R,) bool
    # TN only: kmer_seq values at cand-1 / cand (same order as cand)
    kn1: torch.Tensor | None = None   # (T, R, C) int32
    kn2: torch.Tensor | None = None


def _col_live(T_pad: int, T_r):
    t = torch.arange(T_pad, device=T_r.device)[:, None]
    return (t <= (T_r - 1)[None, :]).reshape(-1)


def tn_tables(kmer_ids, means, stdevs, dtype):
    """(3, R, N2-1): mu, 1/sd and 2 log sd of each k-mer position."""
    sd = stdevs.to(dtype)
    idx = kmer_ids.long()
    return torch.stack([means.to(dtype)[idx], (1.0 / sd)[idx],
                        (2.0 * torch.log(sd))[idx]]).contiguous()


def tk_tables(means, c1, c2, dtype):
    """(3, K): mu, c1, c2 of each k-mer."""
    return torch.stack([means, c1, c2]).to(dtype).contiguous()


def pre_tn_batch(sig, kmer_ids, N_r, T_r, means, stdevs, log_m1, log_e2,
                 cap: int, dtype) -> PreBatchResult:
    """Batched TN pre-pass. sig (R, T_pad-1); kmer_ids (R, N2-1) 0-padded;
    N_r, T_r (R,) int32; means/stdevs (K,). Returns the n-candidates per
    (t, read) column, ascending, with their k-mer values (K7 -> K8 ->
    crossing -> co-sort)."""
    R = sig.shape[0]
    N2 = kmer_ids.shape[1] + 1
    sig = sig.to(dtype).contiguous()
    kid = kmer_ids.to(torch.int32).contiguous()
    tab = tn_tables(kid, means, stdevs, dtype)
    N_r = N_r.to(torch.int32)
    T_r = T_r.to(torch.int32)
    fwd = kn.tn_fwd(sig, tab, N_r, log_m1, log_e2)
    r = torch.arange(R, device=sig.device)
    Zf = fwd[T_r.long() - 1, 1, r, N_r.long() - 1]
    pack, E0 = kn.tn_bwd_sel(sig, tab, kid, N_r, T_r, fwd, cap, log_m1,
                             log_e2)
    del fwd
    return PreBatchResult(Zf=Zf, Zb=E0[:, 0], **tn_select(pack, T_r, cap, N2))


def tn_select(pack, T_r, cap: int, N2: int):
    """(cand, cnt, overflow, kn1, kn2) from K8's pack (T_pad, R, 4cap+2):
    the 95%-mass crossing, then the candidates ascending (the I-state
    chain walks n-slots in increasing n, ref: NTC.cpp:474-477) with their
    k-mer values co-sorted stably."""
    T_pad, R = pack.shape[:2]
    sel = pack.reshape(T_pad * R, -1)
    cand, cnt, ovf = crossing_from_topk(
        sel[:, :cap], sel[:, cap:2 * cap].long(),
        sel[:, 4 * cap + 1:4 * cap + 2], False, _col_live(T_pad, T_r), N2)
    cand, order = torch.sort(cand.reshape(T_pad, R, cap), dim=2, stable=True)
    kn1, kn2 = (torch.gather(sel[:, a:a + cap].reshape(T_pad, R, cap), 2,
                             order).to(torch.int32)
                for a in (2 * cap, 3 * cap))
    return dict(cand=cand, cnt=cnt.reshape(T_pad, R),
                overflow=ovf.reshape(T_pad, R).any(dim=0), kn1=kn1, kn2=kn2)


def pre_tk_batch(sig, T_r, means, c1, c2, log_m1, log_e2,
                 alphabet_size: int, cap: int, dtype) -> PreBatchResult:
    """Batched TK pre-pass (K9 -> K10 -> top-cap -> crossing); the
    k-candidates stay in selection order (normalization by Zb as in the
    reference, ref: NTC.cpp:322)."""
    sig = sig.to(dtype).contiguous()
    tabk = tk_tables(means, c1, c2, dtype)
    T_r = T_r.to(torch.int32)
    bwd = kn.tk_bwd(sig, tabk, T_r, alphabet_size, log_m1, log_e2)
    Zb = logsumexp(bwd[0, 1], dim=1)
    U, finalE = kn.tk_fwd_u(sig, tabk, T_r, bwd, alphabet_size, log_m1,
                            log_e2)
    del bwd
    return PreBatchResult(Zf=logsumexp(finalE, dim=1), Zb=Zb,
                          **tk_select(U, T_r, cap))


def tk_select(U, T_r, cap: int):
    """(cand, cnt, overflow) from K10's U (T_pad, R, K)."""
    T_pad, R, K = U.shape
    cand, cnt, ovf = select_topk(U.reshape(T_pad * R, K), cap, True,
                                 _col_live(T_pad, T_r), K)
    return dict(cand=cand.reshape(T_pad, R, cap), cnt=cnt.reshape(T_pad, R),
                overflow=ovf.reshape(T_pad, R).any(dim=0))

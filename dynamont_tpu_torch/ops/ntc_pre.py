"""NTC per-read pre-passes (counterpart of dynamont_tpu/ops/ntc_pre.py):
the two 2D passes that sparsify the 3D T x N x K lattice (ref:
src/cpp/NTC.cpp:80-398).

* TN pass: the dense T x N 2-state DP of ops/nt_full with the ppTN
  transitions.
* TK pass: 2-state DP over signal x ALL k-mers, where the M state sums over
  the 4 predecessor k-mers. In the dense k-mer coding predecessor access
  k' = k//A + j*A^(S-1) is an (A, K/A) reshape and successor access
  k' = (k%A^(S-1))*A + j a (K/A, A) reshape.
* Per-column candidate selection: sort descending (stable, ties by index —
  ref: utils.cpp:163-177 columnArgsort), accumulate log-probability mass,
  keep until it exceeds log(0.95) (TN breaks on '>', TK on '>=' — ref:
  NTC.cpp:266-270, 337-341).

This is the exact fp64 rung, and it does not use the batched pre-pass
kernels (ops/ntc_batch): it normalizes by the global Z and folds the mass
with the associative scan, as the JAX per-read path does, so the two
round differently.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dynamont_tpu_torch.ops import nt_full
from dynamont_tpu_torch.utils.logmath import log_normal_pdf_c, logsumexp

NEG_INF = -math.inf
SPARSE_THRESHOLD = math.log(0.95)  # ref: NTC.hpp:29


class PrePassResult(NamedTuple):
    cand: torch.Tensor   # (T, C) int32 selected indices, ascending, sentinel-padded
    count: torch.Tensor  # (T,) int32 number of valid candidates per column
    Zf: torch.Tensor
    Zb: torch.Tensor
    overflow: torch.Tensor  # bool: some column needed more than C candidates


def _running_logaddexp(x):
    """Inclusive running logaddexp along dim 1, combined in
    jax.lax.associative_scan's order (pairs, recursion on the pair sums,
    then the even positions), so that every partial sum rounds as in the
    JAX per-read path: a sequential fold rounds differently and can move
    the 95% crossing of a column whose mass sits at the threshold."""
    n = x.shape[1]
    if n < 2:
        return x
    odd = _running_logaddexp(torch.logaddexp(x[:, 0:-1:2], x[:, 1::2]))
    if n % 2 == 0:
        even = torch.logaddexp(odd[:, :-1], x[:, 2::2])
    else:
        even = torch.logaddexp(odd, x[:, 2::2])
    out = torch.empty_like(x)
    out[:, 0] = x[:, 0]
    out[:, 2::2] = even
    out[:, 1::2] = odd
    return out


def _select_columns(LP, cap: int, ge_break: bool, sentinel: int):
    """Reference column selection, vectorized over columns.

    LP: (T, C) combined posterior log-probs. Returns (cand (T,cap) ascending,
    count (T,), overflow bool). Selection: stable-descending order, include
    until the running logsumexp crosses the threshold (break AFTER adding the
    crossing element; '>' or '>=' per ge_break).
    """
    T, C = LP.shape
    # stable descending argsort = stable ascending argsort of -LP
    order = torch.sort(-LP, dim=1, stable=True).indices
    run = _running_logaddexp(torch.gather(LP, 1, order))
    crossed = run >= SPARSE_THRESHOLD if ge_break else run > SPARSE_THRESHOLD
    # include element i iff no element before it crossed
    prev_crossed = torch.cat(
        [torch.zeros((T, 1), dtype=torch.bool, device=LP.device),
         crossed[:, :-1]], dim=1)
    count = (~prev_crossed).sum(dim=1)
    overflow = torch.any(count > cap)
    # the first `cap` included indices are the first positions of the
    # sorted order; then sort ascending with sentinel padding
    take = torch.full((T, cap), sentinel, dtype=order.dtype, device=LP.device)
    eff = min(cap, C)
    take[:, :eff] = order[:, :eff]
    in_cap = torch.arange(cap, device=LP.device)[None, :] < count[:, None]
    cand = torch.sort(torch.where(in_cap, take, sentinel), dim=1).values
    return (cand.to(torch.int32), torch.clamp(count, max=cap).to(torch.int32),
            overflow)


def tn_posteriors(scores, ppTNm: float, ppTNe: float):
    """The TN lattices reduced to what the selection needs: (LP (T, N),
    Zf, Zb), LP = logPlus of the M and E posteriors normalized by Zf
    (ref: NTC.cpp:229-251)."""
    forM, forE = nt_full.make_nt_forward(ppTNm, ppTNe)(scores)
    backM, backE = nt_full.make_nt_backward(ppTNm, ppTNe)(scores)
    Zf = forE[-1, -1]
    Zb = backE[0, 0]
    LP = torch.logaddexp(forM + backM - Zf, forE + backE - Zf)
    return LP, Zf, Zb


def select_tn(LP, Zf, Zb, cap: int) -> PrePassResult:
    cand, count, overflow = _select_columns(LP, cap, ge_break=False,
                                            sentinel=LP.shape[1])
    return PrePassResult(cand, count, Zf, Zb, overflow)


def pre_tn(scores, ppTNm: float, ppTNe: float, cap: int) -> PrePassResult:
    """TN pre-pass (ref: NTC.cpp:229-280). scores: (T-1, N-1) emission matrix
    from nt_full.emission_scores. Returns PrePassResult with n-candidates."""
    return select_tn(*tn_posteriors(scores, ppTNm, ppTNe), cap)


def _group_lse(g, dim: int):
    """logsumexp over `dim` (the A k-mers of a group): max, exp, the sum in
    ascending order as the JAX reductions add, log; -inf where the group is
    all -inf. The batched kernels (csrc/ntc_pre.cu) round the same way."""
    m = torch.amax(g, dim=dim, keepdim=True)
    fin = torch.isfinite(m)
    safe = torch.where(fin, m, 0.0)
    e = torch.exp(g - safe)
    s = e.select(dim, 0)
    for j in range(1, g.shape[dim]):
        s = s + e.select(dim, j)
    return torch.where(fin.squeeze(dim), torch.log(s) + safe.squeeze(dim),
                       NEG_INF)


def _prec_sum(E_prev, alphabet_size: int):
    """X[..., k] = logsumexp_j E_prev[..., prec_j(k)];
    prec_j(k) = k//A + j*(K//A)."""
    *lead, K = E_prev.shape
    x = _group_lse(E_prev.reshape(*lead, alphabet_size, K // alphabet_size), -2)
    return torch.repeat_interleave(x, alphabet_size, dim=-1)


def _suc_sum(vals, alphabet_size: int):
    """Y[..., k] = logsumexp_j vals[..., suc_j(k)];
    suc_j(k) = (k % (K//A))*A + j. vals already includes any per-successor
    additive terms."""
    *lead, K = vals.shape
    y = _group_lse(vals.reshape(*lead, K // alphabet_size, alphabet_size), -1)
    return y.repeat(*([1] * len(lead)), alphabet_size)


def tk_forward(sig, means, c1, c2, ppTKm: float, ppTKe: float,
               alphabet_size: int):
    """ppForTK (ref: NTC.cpp:145-169). Returns (M, E) of shape (T, K)."""
    SC = log_normal_pdf_c(sig[:, None], means, c1, c2)  # (T-1, K)
    T, K = SC.shape[0] + 1, SC.shape[1]
    M = torch.empty((T, K), dtype=SC.dtype, device=SC.device)
    E = torch.empty_like(M)
    M[0] = NEG_INF
    E[0] = 0.0
    for t in range(T - 1):
        sc = SC[t]
        M[t + 1] = _prec_sum(E[t], alphabet_size) + sc + ppTKm
        E[t + 1] = torch.logaddexp(M[t] + sc, E[t] + sc + ppTKe)
    return M, E


def tk_backward(sig, means, c1, c2, ppTKm: float, ppTKe: float,
                alphabet_size: int):
    """ppBackTK (ref: NTC.cpp:189-217). Returns (M, E) of shape (T, K)."""
    SC = log_normal_pdf_c(sig[:, None], means, c1, c2)  # (T-1, K)
    T, K = SC.shape[0] + 1, SC.shape[1]
    M = torch.empty((T, K), dtype=SC.dtype, device=SC.device)
    E = torch.empty_like(M)
    M[T - 1] = NEG_INF
    E[T - 1] = 0.0
    for t in range(T - 2, -1, -1):
        sc = SC[t]
        M[t] = E[t + 1] + sc
        ext = _suc_sum(M[t + 1] + sc + ppTKm, alphabet_size)
        E[t] = torch.logaddexp(ext, E[t + 1] + sc + ppTKe)
    return M, E


def tk_posteriors(sig, means, c1, c2, ppTKm: float, ppTKe: float,
                  alphabet_size: int):
    """The TK lattices reduced to (LP (T, K), Zf, Zb); normalization uses
    Zb (ref: NTC.cpp:322)."""
    forM, forE = tk_forward(sig, means, c1, c2, ppTKm, ppTKe, alphabet_size)
    backM, backE = tk_backward(sig, means, c1, c2, ppTKm, ppTKe,
                               alphabet_size)
    Zf = logsumexp(forE[-1])
    Zb = logsumexp(backE[0])
    LP = torch.logaddexp(forM + backM - Zb, forE + backE - Zb)
    return LP, Zf, Zb


def select_tk(LP, Zf, Zb, cap: int) -> PrePassResult:
    cand, count, overflow = _select_columns(LP, cap, ge_break=True,
                                            sentinel=LP.shape[1])
    return PrePassResult(cand, count, Zf, Zb, overflow)


def pre_tk(sig, means, c1, c2, ppTKm: float, ppTKe: float,
           alphabet_size: int, cap: int) -> PrePassResult:
    """TK pre-pass (ref: NTC.cpp:291-349). Returns PrePassResult with
    k-candidates."""
    return select_tk(*tk_posteriors(sig, means, c1, c2, ppTKm, ppTKe,
                                    alphabet_size), cap)

"""Banded Baum-Welch training on a padded batch (counterpart of
dynamont_tpu/ops/nt_banded_train.py and of the scan oracle
dynamont_tpu/ops/nt_banded_batch.banded_batch_train).

One function serves fp32 and fp64, with the dtype taken from the batch:
K5 (`banded_fwd`) stores the forward rows, K6 (`banded_bwd_train`) runs
the backward recurrence fused with the m1/e2 numerators, and the emission
statistics follow in plain torch (ref: NT_banded.cpp:374-451), in the
scan oracle's two-pass form: per-position weighted sums, per-k-mer means,
the weighted squared deviation about the new means, stdevs.

The sums over sequence positions n = bstart[t] + j - 1 must not depend on
the run: `index_add_`/`scatter_add_` on CUDA use atomics in an order that
changes between runs, and two runs would write different checkpoints.
They go through the monotone runs of bstart instead. Band starts step by
0 or 1 per row, so the rows 1..T-1 of a read fall into runs of equal
bstart, run k having bstart[1] + k. A host-built table lists each run's
rows; the rows are gathered one run slot at a time and summed in slot
order, and the (run, column) sums collapse onto positions along the anti-
diagonals with the pad/reshape shear of the JAX package
(`emission_position_sums`). K-mer sums use the same gather over a
host-built table of each k-mer's positions. Every step is a gather, an
elementwise op or a reduction over one dimension, so a run repeats bit
for bit; and no one-hot matrix product is needed, so TF32 never enters.
The JAX fast path's moment form centred on the read mean exists for the
TPU's matrix unit and is not copied.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops import nt_banded_kernels as kk


class StatsPlan(NamedTuple):
    """Host-built gather tables of a batch, on the batch's device."""

    run_rows: torch.Tensor   # (R, V, L) int64 rows of run k, slot l
    run_live: torch.Tensor   # (R, V, L) bool
    bs1: torch.Tensor        # (R,) int64 bstart[1]: run k has bstart bs1 + k
    grp_pos: torch.Tensor    # (R, S, C) int64 positions p (n = p+1) of group s
    grp_live: torch.Tensor   # (R, S, C) bool
    pos_group: torch.Tensor  # (R, N_stat-1) int64 group of position p
    pos_count: torch.Tensor  # (R, N_stat-1) occurrences of its k-mer (1 if none)
    counts: torch.Tensor     # (R, K) occurrences of each k-mer
    flat_r: torch.Tensor     # (G,) read of each live group
    flat_s: torch.Tensor     # (G,) its group index
    flat_k: torch.Tensor     # (G,) its k-mer id


def stats_plan(bstart: np.ndarray, T: np.ndarray, N: np.ndarray,
               kid_pad: np.ndarray, num_kmers: int, device,
               dtype) -> StatsPlan:
    """The gather tables of a batch, from its host-side band starts, true
    T and N, and (R, N_stat-1) zero-padded k-mer ids."""
    R = len(T)
    runs, groups = [], []
    for r in range(R):
        b = bstart[r, 1 : T[r]]  # rows 1..T-1
        k = b - b[0] if len(b) else b
        runs.append((k, np.bincount(k) if len(b) else np.zeros(0, np.int64)))
        kmers, inv, cnt = np.unique(kid_pad[r, : N[r] - 1], return_inverse=True,
                                    return_counts=True)
        groups.append((kmers, inv, cnt))
    V = max(1, max(len(c) for _, c in runs))
    L = max(1, max((int(c.max()) for _, c in runs if len(c)), default=1))
    S = max(1, max(len(g[0]) for g in groups))
    C = max(1, max((int(g[2].max()) for g in groups if len(g[2])), default=1))
    n_pos = kid_pad.shape[1]
    run_rows = np.zeros((R, V, L), np.int64)
    run_live = np.zeros((R, V, L), bool)
    bs1 = np.zeros(R, np.int64)
    grp_pos = np.zeros((R, S, C), np.int64)
    grp_live = np.zeros((R, S, C), bool)
    pos_group = np.zeros((R, n_pos), np.int64)
    pos_count = np.ones((R, n_pos), np.int64)
    counts = np.zeros((R, num_kmers), np.int64)
    flat = []
    for r, ((k, cnt), (kmers, inv, gcnt)) in enumerate(zip(runs, groups)):
        if len(k):
            bs1[r] = bstart[r, 1]
            slot = np.arange(len(k)) - (np.cumsum(cnt) - cnt)[k]
            run_rows[r, k, slot] = np.arange(1, T[r])
            run_live[r, k, slot] = True
        p = np.argsort(inv, kind="stable")  # positions grouped, in order
        rank = np.arange(len(p)) - (np.cumsum(gcnt) - gcnt)[inv[p]]
        grp_pos[r, inv[p], rank] = p
        grp_live[r, inv[p], rank] = True
        pos_group[r, : len(inv)] = inv
        pos_count[r, : len(inv)] = gcnt[inv]
        counts[r, kmers] = gcnt
        flat += [(r, s, km) for s, km in enumerate(kmers)]
    fr, fs, fk = (np.array(c, np.int64) for c in zip(*flat)) if flat else \
        (np.zeros(0, np.int64),) * 3
    put = lambda a: torch.from_numpy(a).to(device)
    cast = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)
    return StatsPlan(put(run_rows), put(run_live), put(bs1), put(grp_pos),
                      put(grp_live), put(pos_group), cast(pos_count),
                      cast(counts), put(fr), put(fs), put(fk))


def _shear(U, bs1, N_stat: int):
    """(R, C, V, B) run-domain sums -> (R, C, N_stat) position sums:
    cell (k, j) is position n = bs1 + k + j - 1. The anti-diagonal sums
    q[p] = sum_j U[p-j, j] come from padding each column row by B and
    reading the flat buffer with rows one shorter (a pure reshape)."""
    R, C, V, B = U.shape
    Mp = F.pad(U.transpose(2, 3), (0, B))                     # (R, C, B, V+B)
    W = V + B - 1
    q = Mp.reshape(R, C, B * (V + B))[..., : B * W].reshape(R, C, B, W).sum(2)
    p = torch.arange(N_stat, device=U.device)[None, :] - bs1[:, None] + 1
    ok = (p >= 0) & (p < W)
    out = q.gather(2, p.clamp(0, W - 1)[:, None, :].expand(R, C, N_stat))
    return torch.where(ok[:, None, :], out, 0.0)


def _group_sum(vals, plan: StatsPlan):
    """(R, N_stat-1) per-position values -> (R, S) sums per k-mer group,
    in position order."""
    acc = torch.zeros(plan.grp_pos.shape[:2], dtype=vals.dtype,
                      device=vals.device)
    for c in range(plan.grp_pos.shape[2]):
        acc = acc + torch.where(plan.grp_live[:, :, c],
                                vals.gather(1, plan.grp_pos[:, :, c]), 0.0)
    return acc


def _dense(g, plan: StatsPlan):
    """(R, S) group values -> (R, K), 0 for k-mers a read does not have."""
    out = torch.zeros(plan.counts.shape, dtype=g.dtype, device=g.device)
    out[plan.flat_r, plan.flat_k] = g[plan.flat_r, plan.flat_s]
    return out


def emission_stats(batch: bb.BandedBatch, fM, fE, bM, bE, Zb,
                   plan: StatsPlan, N_stat: int, guard: bool = True):
    """(means, stdevs), each (R, K), from the band rows (ref:
    NT_banded.cpp:374-451). Posterior weights w = exp(fM + bM - Zb) +
    exp(fE + bE - Zb) on rows 1..T-1 and cells with 0 <= n < N, NaN and
    +inf set to 0. guard divides by a position's weight only where it is
    > 0, as the batched JAX paths do; without it the division is
    unconditional, as in the per-read JAX path (ops/nt_banded.py:321)."""
    R, T_pad, B = fM.shape
    zb = Zb[:, None, None]
    w = torch.exp(fM + bM - zb) + torch.exp(fE + bE - zb)
    n = batch.bstart[:, :, None] + torch.arange(-1, B - 1, device=w.device,
                                                 dtype=torch.int32)
    w = torch.where((n >= 0) & (n < batch.N[:, None, None]), w, 0.0)
    w = torch.nan_to_num(w, nan=0.0, posinf=0.0)
    sig_rows = F.pad(batch.sig, (1, 0))  # row t holds sig[t-1]
    r_ix = torch.arange(R, device=w.device)[:, None]

    def run_slots():
        """(w, sig) of each run slot, for every run: (R, V, B), (R, V, 1)."""
        for slot in range(plan.run_rows.shape[2]):
            rows = plan.run_rows[:, :, slot]
            live = plan.run_live[:, :, slot, None]
            yield torch.where(live, w[r_ix, rows], 0.0), sig_rows[r_ix, rows][..., None]

    def divide(num, den):
        if not guard:
            return num / den
        has = den > 0
        return torch.where(has, num / torch.where(has, den, 1.0), 0.0)

    # pass 1: weight and weighted signal per position -> k-mer means
    acc_w = acc_ws = 0.0
    for wl, sl in run_slots():
        acc_w = acc_w + wl
        acc_ws = acc_ws + wl * sl
    norm, wsig = _shear(torch.stack([acc_w, acc_ws], 1), plan.bs1, N_stat).unbind(1)
    g_means = _group_sum(divide(wsig, norm)[:, 1:] / plan.pos_count, plan)
    mean_by_pos = F.pad(g_means.gather(1, plan.pos_group), (1, 0))  # n = 0: 0
    # pass 2: weighted squared deviation about the new means
    V = plan.run_rows.shape[1]
    n_kj = (plan.bs1[:, None, None] + torch.arange(V, device=w.device)[:, None]
            + torch.arange(B, device=w.device) - 1).clamp(0, N_stat - 1)
    m_kj = mean_by_pos.gather(1, n_kj.reshape(R, -1)).reshape(R, V, B)
    acc_v = 0.0
    for wl, sl in run_slots():
        d = sl - m_kj
        acc_v = acc_v + wl * d * d
    var = _shear(acc_v[:, None], plan.bs1, N_stat)[:, 0]
    g_std = torch.sqrt(_group_sum(divide(var, norm)[:, 1:] / plan.pos_count, plan))
    return _dense(g_means, plan), _dense(g_std, plan)


def banded_batch_train(batch: bb.BandedBatch, log_m1: float, log_e2: float,
                       kmer_ids_pad, num_kmers: int, *,
                       guard: bool = True) -> bb.BandedTrainResult:
    """Per-read Baum-Welch estimates for every read of a padded batch.

    kmer_ids_pad: (R, N_stat-1) per-position k-mer ids, zero padded
    (numpy or a tensor). The transitions come out normalized as in
    nt_banded_train.py:437-448: rawM1/rawE2 already hold log_m1/log_e2."""
    kid = (kmer_ids_pad.cpu().numpy() if isinstance(kmer_ids_pad, torch.Tensor)
           else np.asarray(kmer_ids_pad))
    T, N = batch.T.cpu().numpy(), batch.N.cpu().numpy()
    plan = stats_plan(batch.bstart.cpu().numpy(), T, N, kid, num_kmers,
                      batch.sig.device, batch.sig.dtype)
    fM, fE = kk.forward(batch, log_m1, log_e2)
    bM, bE, rawM1, rawE2 = kk.backward_train(batch, fE, log_m1, log_e2)
    r = torch.arange(fM.shape[0], device=fM.device)
    ctr = batch.bw.long() + 1
    Zf = fE[r, batch.T.long() - 1, ctr]
    Zb = bE[r, 0, ctr]
    Ae = torch.logaddexp(rawE2, rawM1)
    fin = torch.isfinite(Ae)
    newM1 = torch.where(fin, rawM1 - Ae, rawM1)
    newE2 = torch.where(fin, rawE2 - Ae, rawE2)
    means, stdevs = emission_stats(batch, fM, fE, bM, bE, Zb, plan,
                                   kid.shape[1] + 1, guard)
    mask = (plan.counts > 0) & (stdevs > 0)
    return bb.BandedTrainResult(Zf, Zb, torch.exp(newM1), torch.exp(newE2),
                                means, stdevs, mask)

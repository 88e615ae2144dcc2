"""Batched banded NT DP in plain PyTorch — the CPU path and the plain
versions of the six banded CUDA kernels (counterpart of
dynamont_tpu/ops/nt_banded_batch.py), and the matrix route
(`banded_batch_run`: stored forward and backward rows, then the log
posteriors and Viterbi choices over them, walked on the host).

Reads are padded to a common (T_pad, B) bucket. Every recurrence is a
Python loop over signal time t whose body is elementwise work on (R, B)
rows: R reads, B band columns. Band column j of row t is sequence
position n = bstart[t] + j - 1 (ops/geometry.py); when the band start
advances between rows, predecessor lookups shift by one column
(ref: src/cpp/NT_banded.cpp forward/backward/Viterbi).

Emission scores of a whole bucket are gathered before the loop, straight
from the padded per-position parameter arrays (mu_pad[bstart[t] + j - 2 +
pad]), so no sliding window rides in the loop.

Every product-then-sum is written as the JAX code writes it, op by op
(`c1 - c2 * d * d`, `E_m + sc_b + log_m1`), and the CUDA kernels compute
the same operations in the same order: the Viterbi choice bit is an exact
float equality.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from dynamont_tpu_torch.constants import EPSILON
from dynamont_tpu_torch.ops.geometry import band_geometry, effective_bandwidth
from dynamont_tpu_torch.utils.logmath import log_normal_pdf_c

NEG_INF = float("-inf")
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def z_epsilon(dtype) -> float:
    """Per-cell forward/backward agreement tolerance: the reference's 1e-8
    in fp64 (ref: utils.cpp:7), relaxed to 1e-6 for fp32 round-off (see
    dynamont_tpu/ops/nt_banded_batch.z_epsilon)."""
    return EPSILON if dtype == torch.float64 else 1e-6


def check_z_batch(Zf: np.ndarray, Zb: np.ndarray, T: np.ndarray, B,
                  dtype) -> np.ndarray:
    """Per-read pass/fail of the forward/backward invariant over T*B cells.
    B is the padded band width: the bucket's (an int, as in the JAX
    package, so changing it changes which reads escalate to the fp64 rung)
    or each read's own (an array, as the device route gates)."""
    eps = z_epsilon(dtype)
    cells = T.astype(np.float64) * B
    ok = np.isfinite(Zf) & np.isfinite(Zb)
    return ok & (np.abs(Zf - Zb) / cells <= eps)


class BandedBatch(NamedTuple):
    """Device-ready padded batch. R reads, T_pad rows, B band columns."""

    sig: torch.Tensor      # (R, T_pad-1) normalized signal, zero padded
    mu_pad: torch.Tensor   # (R, N_pad) per-position emission mean, index n-1+pad
    c1_pad: torch.Tensor   # (R, N_pad) -0.5*log(2pi) - log(sd)
    c2_pad: torch.Tensor   # (R, N_pad) 0.5 / sd^2
    bstart: torch.Tensor   # (R, T_pad) int32 band start per row
    T: torch.Tensor        # (R,) int32 true T = len(sig)+1
    N: torch.Tensor        # (R,) int32 true N = n_kmers+1
    bw: torch.Tensor       # (R,) int32 per-read effective bandwidth
    pad: int               # left padding of the parameter arrays
    B: int                 # band array width (>= 2*max_bw+3)


class BandedBatchResult(NamedTuple):
    """The matrix route's result of a padded batch."""

    Zf: torch.Tensor       # (R,)
    Zb: torch.Tensor       # (R,)
    PM: torch.Tensor       # (R, T_pad, B) posterior probability of M
    PE: torch.Tensor       # (R, T_pad, B) posterior probability of E
    choices: torch.Tensor  # (R, T_pad, B) bool Viterbi traceback bit


class BandedTrainResult(NamedTuple):
    """Per-read Baum-Welch estimates of a padded batch."""

    Zf: torch.Tensor         # (R,)
    Zb: torch.Tensor         # (R,)
    m1: torch.Tensor         # (R,) updated transition probabilities
    e2: torch.Tensor         # (R,)
    means: torch.Tensor      # (R, K) k-mer level means (0 where unseen)
    stdevs: torch.Tensor     # (R, K) k-mer level stdevs (0 where unseen)
    kmer_mask: torch.Tensor  # (R, K) bool: the read contributes this k-mer


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def prepare_batch(signals, kmer_ids_list, model, band: int = 400, *,
                  device, dtype=torch.float32,
                  t_pad_to: int = 256) -> BandedBatch:
    """Pad a list of reads into one batch on `device`, with emission
    parameters from the pore model's score_params(). Geometry is computed
    on the host with the reference's float64 midpoint truncation (ref:
    NT_banded.cpp:269-287). B = round_up(2*max_bw+3, 128) as in the JAX
    package; columns past 2*bw+2 are -inf guards."""
    R = len(signals)
    T_arr = np.array([len(s) + 1 for s in signals], dtype=np.int32)
    N_arr = np.array([len(k) + 1 for k in kmer_ids_list], dtype=np.int32)
    bw_arr = np.array([effective_bandwidth(band, int(n)) for n in N_arr],
                      dtype=np.int32)
    max_bw = int(bw_arr.max())
    B = round_up(2 * max_bw + 3, 128)
    pad = max_bw + 3
    T_pad = round_up(int(T_arr.max()), t_pad_to)
    # +B tail: every band window of the parameter arrays stays in range
    N_pad = int(N_arr.max()) - 1 + 2 * pad + B

    means, c1, c2 = model.score_params()
    np_dtype = _NP_DTYPE[dtype]
    sig = np.zeros((R, T_pad - 1), dtype=np_dtype)
    mu_pad = np.zeros((R, N_pad), dtype=np_dtype)
    c1_pad = np.zeros((R, N_pad), dtype=np_dtype)
    c2_pad = np.zeros((R, N_pad), dtype=np_dtype)
    bstart = np.zeros((R, T_pad), dtype=np.int32)
    for i, (s, kid) in enumerate(zip(signals, kmer_ids_list)):
        T, N, bw = int(T_arr[i]), int(N_arr[i]), int(bw_arr[i])
        sig[i, : T - 1] = s
        mu_pad[i, pad : pad + N - 1] = means[kid]
        c1_pad[i, pad : pad + N - 1] = c1[kid]
        c2_pad[i, pad : pad + N - 1] = c2[kid]
        geom = band_geometry(T, N, bw)
        bstart[i, :T] = geom.bstart
        bstart[i, T:] = geom.bstart[T - 1]  # frozen past the true end: shift 0
    put = lambda a: torch.from_numpy(a).to(device)
    return BandedBatch(put(sig), put(mu_pad), put(c1_pad), put(c2_pad),
                       put(bstart), put(T_arr), put(N_arr), put(bw_arr),
                       pad=pad, B=B)


# ---------------------------------------------------------------------------
# row helpers
# ---------------------------------------------------------------------------

def _shift_left(row):
    """row[:, j+1], -inf past the right edge."""
    return F.pad(row[:, 1:], (0, 1), value=NEG_INF)


def _shift_right(row):
    """row[:, j-1], -inf before the left edge."""
    return F.pad(row[:, :-1], (1, 0), value=NEG_INF)


def _band_scores(batch: BandedBatch, rows: slice, sig, offset: int):
    """(R, len(rows), B) emission scores: row t scores sig against the
    parameters of k-mer position bstart[t] + j + offset."""
    R = batch.sig.shape[0]
    j = torch.arange(batch.B, device=sig.device, dtype=torch.int64)
    idx = batch.bstart[:, rows].long()[:, :, None] + j + (offset + batch.pad)
    flat = idx.reshape(R, -1)
    take = lambda a: a.gather(1, flat).reshape(idx.shape)
    return log_normal_pdf_c(sig[:, :, None], take(batch.mu_pad),
                            take(batch.c1_pad), take(batch.c2_pad))


def _valid(batch: BandedBatch, rows: slice, lower_from_one: bool):
    """(R, len(rows), B) band cells with n in [max(lower, bstart),
    min(bstart + 2bw + 1, N)); lower is 1 for forward/Viterbi rows."""
    j = torch.arange(batch.B, device=batch.bstart.device)
    bs = batch.bstart[:, rows][:, :, None]
    ns = bs.clamp(min=1 if lower_from_one else 0)
    ne = torch.minimum(bs + 2 * batch.bw[:, None, None] + 1,
                       batch.N[:, None, None])
    return (j >= ns - bs + 1) & (j < ne - bs + 1)


def _start_row(batch: BandedBatch, dtype):
    """(R, B) row with 0 at band column bw+1, -inf elsewhere."""
    j = torch.arange(batch.B, device=batch.bstart.device)
    hit = j[None, :] == (batch.bw[:, None] + 1)
    zero = torch.zeros((), dtype=dtype, device=hit.device)
    return torch.where(hit, zero, NEG_INF)


def _forward_row(M_prev, E_prev, s1, sc_b, valid, log_m1, log_e2):
    """Forward step t (ref: NT_banded.cpp:23-62); s1 (R, 1) is the band
    shift between rows t-1 and t."""
    E_m = torch.where(s1, E_prev, _shift_right(E_prev))
    M_e = torch.where(s1, _shift_left(M_prev), M_prev)
    E_e = torch.where(s1, _shift_left(E_prev), E_prev)
    M_new = torch.where(valid, E_m + sc_b + log_m1, NEG_INF)
    # torch.logaddexp is -inf for (-inf, -inf), like jnp.logaddexp, where
    # the naive m + log1p(exp(-|a-b|)) is NaN, and the band is mostly -inf;
    # otherwise it computes that formula, which the CUDA kernels copy
    # (csrc/nt_banded.cu, `logaddexp`)
    E_new = torch.where(valid,
                        torch.logaddexp(M_e + sc_b, E_e + sc_b + log_e2),
                        NEG_INF)
    return M_new, E_new


def _viterbi_row(vM, vE, s1, lpm, lpe, valid):
    """Viterbi max-step over log posteriors (ref: NT_banded.cpp:139-189):
    max-then-add, and choice = (E_new == M_e + lpe) after masking."""
    E_m = torch.where(s1, vE, _shift_right(vE))
    M_e = torch.where(s1, _shift_left(vM), vM)
    E_e = torch.where(s1, _shift_left(vE), vE)
    M_new = torch.where(valid, E_m + lpm, NEG_INF)
    E_new = torch.where(valid, torch.maximum(M_e, E_e) + lpe, NEG_INF)
    return M_new, E_new, E_new == (M_e + lpe)


def _row_shifts(batch: BandedBatch):
    """(R, T_pad-1) bool: index t-1 holds bstart[t] != bstart[t-1]."""
    return batch.bstart[:, 1:] != batch.bstart[:, :-1]


# ---------------------------------------------------------------------------
# the recurrences
# ---------------------------------------------------------------------------

def forward(batch: BandedBatch, log_m1: float, log_e2: float):
    """(fM, fE), each (R, T_pad, B); plain version of the banded_fwd
    kernel (ref: NT_banded.cpp:23-62). Row 0 is M = -inf and E = 0 at band
    column bw+1; rows t >= T are -inf."""
    R, T_pad = batch.bstart.shape
    dtype = batch.sig.dtype
    sc_b = _band_scores(batch, slice(1, None), batch.sig, -2)
    valid = _valid(batch, slice(1, None), True)
    s1 = _row_shifts(batch)
    M = torch.full((R, batch.B), NEG_INF, dtype=dtype, device=sc_b.device)
    E = _start_row(batch, dtype)
    fM = torch.empty((R, T_pad, batch.B), dtype=dtype, device=sc_b.device)
    fE = torch.empty_like(fM)
    fM[:, 0], fE[:, 0] = M, E
    for t in range(1, T_pad):
        M, E = _forward_row(M, E, s1[:, t - 1 : t], sc_b[:, t - 1],
                            valid[:, t - 1], log_m1, log_e2)
        fM[:, t], fE[:, t] = M, E
    dead = (torch.arange(T_pad, device=fM.device) >= batch.T[:, None])[:, :, None]
    fM.masked_fill_(dead, NEG_INF)
    fE.masked_fill_(dead, NEG_INF)
    return fM, fE


def _online_add(m, s, x):
    """Fold x into the running log-sum (m, s), value m + log(s), as the
    banded_bwd_train kernel folds it (`online_add`)."""
    m_new = torch.maximum(m, x)
    live = m_new > NEG_INF
    safe = torch.where(live, m_new, 0.0)
    s = torch.where(live, s * torch.exp(m - safe) + torch.exp(x - safe), s)
    return m_new, s


def band_lse(m, s):
    """(R,) log-sum over the band of per-column online sums (m, s), each
    (R, B), reduced as the banded_bwd_train kernel reduces (`band_lse`):
    the max, then a pairwise tree sum of exp(acc - max) over the band
    zero-padded to a power of two, then log + max. -inf for a read with
    no finite term."""
    acc = torch.where(s > 0, m + torch.log(torch.where(s > 0, s, 1.0)),
                      NEG_INF)
    mx = acc.amax(dim=1)
    live = mx > NEG_INF
    safe = torch.where(live, mx, 0.0)
    B = acc.shape[1]
    x = F.pad(torch.exp(acc - safe[:, None]), (0, (1 << (B - 1).bit_length()) - B))
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return torch.where(live, torch.log(x[:, 0]) + safe, mx)


def backward(batch: BandedBatch, log_m1: float, log_e2: float):
    """(M, E), each (R, T_pad, B); plain version of the banded_bwd kernel.

    The terminal row is each read's own t = T-1 (E = 0 at band column
    bw+1); rows above it are -inf and leave the carry untouched, so reads
    of different T share one bucket (ref: NT_banded.cpp:64-123)."""
    M, E, _ = _backward(batch, log_m1, log_e2, None)
    return M, E


def backward_train(batch: BandedBatch, fE, log_m1: float, log_e2: float):
    """(bM, bE, rawM1, rawE2); plain version of the banded_bwd_train
    kernel: the backward recurrence of `backward`, unchanged, fused with
    the Baum-Welch transition numerators over the forward E rows fE
    (ref: NT_banded.cpp:303-371).

    At row t < T-1, m1_t = fE + log_m1 + sc_a + bMq where n + 1 < N and
    e2_t = fE + log_e2 + sc_b + bEq where n > 0, with bMq/bEq backward row
    t+1 under the reference's quirked next shift (at t = T-2 it compares
    bstart[T-2] with bstart[0], NT_banded.cpp:309); the recurrence keeps
    the true shift. Terms fold per band column online over t, then one
    band_lse per read gives rawM1/rawE2 (R,): log numerators that already
    hold log_m1/log_e2."""
    M, E, (m1, e2) = _backward(batch, log_m1, log_e2, fE)
    return M, E, band_lse(*m1), band_lse(*e2)


def _quirked_shifts(batch: BandedBatch):
    """(R, T_pad-1) bool: index t holds bstart[t+1] != bstart[t], except
    at t = T-2, where it holds bstart[T-2] != bstart[0]."""
    sb = _row_shifts(batch)
    T = batch.T.long()[:, None]
    s_last = batch.bstart.gather(1, (T - 2).clamp(min=0)) != batch.bstart[:, :1]
    t = torch.arange(sb.shape[1], device=sb.device)
    return torch.where(t == T - 2, s_last, sb)


def _backward(batch: BandedBatch, log_m1: float, log_e2: float, fE):
    """The backward recurrence; with forward rows fE also the per-column
    online (max, sum) pairs of the m1 and e2 numerators."""
    R, T_pad = batch.bstart.shape
    B = batch.B
    dtype = batch.sig.dtype
    rows = slice(0, T_pad - 1)
    sc_b = _band_scores(batch, rows, batch.sig, -2)  # k-mer position n-1
    sc_a = _band_scores(batch, rows, batch.sig, -1)  # k-mer position n
    valid = _valid(batch, rows, False)
    j = torch.arange(B, device=sc_b.device)
    n = batch.bstart[:, :-1, None] + j - 1
    has_next = n + 1 < batch.N[:, None, None]
    has_prev = n > 0
    sb = _row_shifts(batch)  # index t: shift between rows t and t+1
    T = batch.T[:, None]
    term_row = _start_row(batch, dtype)
    M = torch.empty((R, T_pad, B), dtype=dtype, device=sc_b.device)
    E = torch.empty_like(M)
    M[:, T_pad - 1] = NEG_INF
    E[:, T_pad - 1] = torch.where(T == T_pad, term_row, NEG_INF)
    M_next, E_next = M[:, T_pad - 1], E[:, T_pad - 1]
    if fE is not None:
        snq = _quirked_shifts(batch)
        zero = torch.zeros((R, B), dtype=dtype, device=sc_b.device)
        m1 = e2 = (torch.full_like(zero, NEG_INF), zero)
    for t in range(T_pad - 2, -1, -1):
        if fE is not None:  # numerators over row t+1, before it moves on
            q = snq[:, t : t + 1]
            bMq = torch.where(q, M_next, _shift_left(M_next))
            bEq = torch.where(q, _shift_right(E_next), E_next)
            live = t < T - 1
            fe = fE[:, t]
            m1 = _online_add(*m1, torch.where(
                live & has_next[:, t], fe + log_m1 + sc_a[:, t] + bMq, NEG_INF))
            e2 = _online_add(*e2, torch.where(
                live & has_prev[:, t], fe + log_e2 + sc_b[:, t] + bEq, NEG_INF))
        s = sb[:, t : t + 1]
        E_n = torch.where(s, _shift_right(E_next), E_next)
        M_n = torch.where(s, M_next, _shift_left(M_next))
        ext = torch.where(has_next[:, t], M_n + sc_a[:, t] + log_m1, NEG_INF)
        hp = has_prev[:, t]
        M_new = torch.where(hp, E_n + sc_b[:, t], NEG_INF)
        ext = torch.where(hp, torch.logaddexp(ext, E_n + sc_b[:, t] + log_e2),
                          ext)
        M_new = torch.where(valid[:, t], M_new, NEG_INF)
        E_new = torch.where(valid[:, t], ext, NEG_INF)
        live, term = t < T - 1, t == T - 1
        M_next = torch.where(live, M_new, torch.where(term, NEG_INF, M_next))
        E_next = torch.where(live, E_new, torch.where(term, term_row, E_next))
        M[:, t] = torch.where(live, M_new, NEG_INF)
        E[:, t] = torch.where(live, E_new, torch.where(term, term_row, NEG_INF))
    return M, E, ((m1, e2) if fE is not None else None)


def fwd_vit(batch: BandedBatch, bM, bE, Zb, log_m1: float, log_e2: float):
    """Plain version of the banded_fwd_vit kernel: the forward recurrence
    fused with the log posteriors LPM/LPE = fwd + bwd - Zb and the Viterbi
    recurrence; forward rows are never stored. Returns (ch, LPM, LPE, Zf):
    ch uint8 (R, T_pad, B), Zf captured at each read's t = T-1, band column
    bw+1. Rows t >= T hold LPM = LPE = -inf and ch = 0."""
    R, T_pad, B = bM.shape
    dtype = bM.dtype
    sc_b = _band_scores(batch, slice(1, None), batch.sig, -2)
    valid = _valid(batch, slice(1, None), True)
    s1 = _row_shifts(batch)
    T = batch.T[:, None]
    zb = Zb[:, None]
    zcol = (batch.bw.long() + 1)[:, None]
    ch = torch.zeros((R, T_pad, B), dtype=torch.uint8, device=bM.device)
    LPM = torch.empty_like(bM)
    LPE = torch.empty_like(bM)
    M = torch.full((R, B), NEG_INF, dtype=dtype, device=bM.device)
    E = _start_row(batch, dtype)
    vM, vE = M, E
    LPM[:, 0] = M + bM[:, 0] - zb
    LPE[:, 0] = E + bE[:, 0] - zb
    Zf = torch.full((R, 1), NEG_INF, dtype=dtype, device=bM.device)
    for t in range(1, T_pad):
        s = s1[:, t - 1 : t]
        v = valid[:, t - 1]
        M, E = _forward_row(M, E, s, sc_b[:, t - 1], v, log_m1, log_e2)
        Zf = torch.where(t == T - 1, E.gather(1, zcol), Zf)
        lpm = M + bM[:, t] - zb
        lpe = E + bE[:, t] - zb
        LPM[:, t], LPE[:, t] = lpm, lpe
        vM, vE, c = _viterbi_row(vM, vE, s, lpm, lpe, v)
        ch[:, t] = c
    dead = (torch.arange(T_pad, device=bM.device) >= T)[:, :, None]
    LPM.masked_fill_(dead, NEG_INF)
    LPE.masked_fill_(dead, NEG_INF)
    ch.masked_fill_(dead, 0)
    return ch, LPM, LPE, Zf[:, 0]


def viterbi_post(batch: BandedBatch, fM, fE, bM, bE, Zb):
    """Plain version of the banded_vit kernel: the log posteriors
    LPM/LPE = fwd + bwd - Zb over stored forward and backward rows and the
    Viterbi recurrence over them, with fwd_vit's Viterbi step. Returns
    (ch uint8, LPM, LPE), each (R, T_pad, B); rows t >= T hold
    LPM = LPE = -inf and ch = 0, as fwd_vit leaves them."""
    R, T_pad, B = fM.shape
    zb = Zb[:, None, None]
    LPM = fM + bM - zb
    LPE = fE + bE - zb
    valid = _valid(batch, slice(1, None), True)
    s1 = _row_shifts(batch)
    ch = torch.zeros((R, T_pad, B), dtype=torch.uint8, device=fM.device)
    vM = torch.full((R, B), NEG_INF, dtype=fM.dtype, device=fM.device)
    vE = _start_row(batch, fM.dtype)
    for t in range(1, T_pad):
        vM, vE, c = _viterbi_row(vM, vE, s1[:, t - 1 : t], LPM[:, t],
                                 LPE[:, t], valid[:, t - 1])
        ch[:, t] = c
    dead = (torch.arange(T_pad, device=fM.device) >= batch.T[:, None])[:, :, None]
    LPM.masked_fill_(dead, NEG_INF)
    LPE.masked_fill_(dead, NEG_INF)
    ch.masked_fill_(dead, 0)
    return ch, LPM, LPE


def walk(LPM, LPE, ch, batch: BandedBatch, N_max: int):
    """Plain version of the banded_walk kernel: the reverse MAP traceback
    over (n, j, is_m) (ref: NT_banded.cpp:204-250), all reads at once.

    Returns (path_n int32, prob, close bool), each (R, T_pad-1) at index
    t-1 for row t. A read is active while 1 <= t <= T-1 and n >= 1; an
    active row records its base n and prob = exp(min(lp, 0)) (NaN -> 0);
    an inactive row records N_max and 0. A band column outside [0, B)
    reads lp = 0 and choice 0."""
    R, T_pad, B = LPM.shape
    dev = LPM.device
    r = torch.arange(R, device=dev)
    s_all = _row_shifts(batch).long()
    T = batch.T.long()
    n = batch.N.long() - 1
    j = batch.bw.long() + 1
    is_m = torch.zeros(R, dtype=torch.bool, device=dev)
    path_n = torch.full((R, T_pad - 1), N_max, dtype=torch.int32, device=dev)
    prob = torch.zeros((R, T_pad - 1), dtype=LPM.dtype, device=dev)
    close = torch.zeros((R, T_pad - 1), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=LPM.dtype, device=dev)
    for t in range(T_pad - 1, 0, -1):
        active = (t <= T - 1) & (n >= 1)
        inb = (j >= 0) & (j < B)
        jc = j.clamp(0, B - 1)
        lp = torch.where(is_m, LPM[r, t, jc], LPE[r, t, jc])
        lp = torch.where(inb, lp, zero)
        c = inb & (ch[r, t, jc] != 0)
        p = torch.minimum(lp, zero).exp()
        p = torch.where(torch.isnan(p), zero, p)
        cl = active & is_m
        path_n[:, t - 1] = torch.where(active, n, N_max).int()
        prob[:, t - 1] = torch.where(active, p, zero)
        close[:, t - 1] = cl
        s = s_all[:, t - 1]
        n = torch.where(cl, n - 1, n)
        j = torch.where(cl, j - 1 + s, torch.where(active, j + s, j))
        is_m = torch.where(cl, False, torch.where(active, c, is_m))
    return path_n, prob, close


def path_summaries(path_n, prob, close, N_max: int):
    """Per-base segment starts and median posteriors from a walked path
    (ref: utils.cpp:443-467 calculateMedian): (R, N_max) int32 starts
    (-1 = none) and (R, N_max) medians.

    The walk visits bases in monotone order, so one lexicographic sort of
    (base, prob) — a stable sort by prob, then a stable sort by base, the
    torch form of lax.sort(num_keys=2) — groups each base's probabilities
    in order; the median is the mean of the group's two middle elements.
    Unvisited path rows carry key N_max and prob +inf."""
    R, L = path_n.shape
    dev = path_n.device
    keys = path_n.long()
    starts = torch.full((R, N_max + 1), -1, dtype=torch.int32, device=dev)
    idx = torch.where(close, keys, N_max)
    t_minus_1 = torch.arange(L, dtype=torch.int32, device=dev).expand(R, L)
    starts.scatter_(1, idx, t_minus_1)
    probs = torch.where(keys < N_max, prob, float("inf"))
    sp, order = torch.sort(probs, dim=1, stable=True)
    _, order2 = torch.sort(keys.gather(1, order), dim=1, stable=True)
    sp = sp.gather(1, order2)
    counts = torch.zeros((R, N_max + 1), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, keys, torch.ones_like(keys))
    counts = counts[:, :N_max]
    offsets = counts.cumsum(1) - counts
    lo = (offsets + (counts - 1) // 2).clamp(0, L - 1)
    hi = (offsets + counts // 2).clamp(0, L - 1)
    med = 0.5 * (sp.gather(1, lo) + sp.gather(1, hi))
    med = torch.where(counts > 0, med, 0.0)
    return starts[:, :N_max], med


# ---------------------------------------------------------------------------
# the matrix route (JAX's BandedBatchEngine(device_pipeline=False))
# ---------------------------------------------------------------------------

def log_posteriors(batch: BandedBatch, log_m1: float, log_e2: float):
    """(Zf, Zb, ch, LPM, LPE) of a batch through the three kernels of the
    matrix route: banded_fwd and banded_bwd store every row, banded_vit
    forms the log posteriors and the Viterbi choices over them. The
    wrappers run the plain versions for a batch on the CPU."""
    from dynamont_tpu_torch.ops import nt_banded_kernels as kk

    fM, fE = kk.forward(batch, log_m1, log_e2)
    bM, bE = kk.backward(batch, log_m1, log_e2)
    r = torch.arange(fM.shape[0], device=fM.device)
    zcol = batch.bw.long() + 1
    Zf = fE[r, batch.T.long() - 1, zcol]
    Zb = bE[r, 0, zcol]
    ch, LPM, LPE = kk.viterbi_post(batch, fM, fE, bM, bE, Zb)
    return Zf, Zb, ch, LPM, LPE


def _prob(lp):
    """exp(lp) clipped to [0, 1], NaN and +inf to 0: exp(-inf - -inf) can
    surface NaN in dead rows, and fp32 round-off in Z can push a cell just
    above 1 (as dynamont_tpu/ops/nt_banded_batch.banded_batch_run)."""
    return torch.nan_to_num(torch.exp(lp), nan=0.0, posinf=0.0).clamp(0.0, 1.0)


def banded_batch_run(batch: BandedBatch, log_m1: float,
                     log_e2: float) -> BandedBatchResult:
    """The matrix route's segmentation compute for a padded batch: forward,
    backward, posteriors and Viterbi choices (log_posteriors), then the
    posterior probabilities the host walk reads."""
    Zf, Zb, ch, LPM, LPE = log_posteriors(batch, log_m1, log_e2)
    return BandedBatchResult(Zf=Zf, Zb=Zb, PM=_prob(LPM), PE=_prob(LPE),
                             choices=ch.bool())


def make_banded_batch_fn(m1: float, e2: float):
    """BandedBatch -> BandedBatchResult under the transition probabilities
    m1 and e2 (logs taken here)."""
    log_m1, log_e2 = math.log(m1), math.log(e2)
    return lambda batch: banded_batch_run(batch, log_m1, log_e2)


def traceback_batch(result: BandedBatchResult, bstart, T, N, bw,
                    kmer_size: int):
    """The host walk of every read of a batch (the native library's,
    OpenMP across reads, or its Python twin): per read a list of segments
    (state, basepos, start_t, median_prob) in read order. bstart, T, N and
    bw are host arrays; the walk reads the probabilities in float32."""
    from dynamont_tpu_torch import native

    host = lambda x: x.cpu().numpy()
    return native.banded_traceback_batch(
        host(result.choices), host(result.PM), host(result.PE),
        np.asarray(bstart), np.asarray(T), np.asarray(N), np.asarray(bw),
        kmer_size)

"""The batched NTC pipeline's device ops (counterpart of
dynamont_tpu/ops/ntc_batch.py): the TN and TK 2-state pre-passes over a
padded bucket of reads with the per-column candidate selection (lines
44-441 of the JAX module), the plan that merges the candidates into the
sparse 5-state lattice (582-907), and the lattice itself (913-1445).

One function serves fp32 and fp64. The recurrences run in kernels on CUDA
tensors and in their plain versions on CPU tensors: the pre-pass in
ops/ntc_pre_kernels (K7-K10), the lattice in ops/ntc_kernels (K11, K13,
K15; the plain K13 and K15 are ntc_backward_batch and
ntc_posterior_viterbi_batch here). What the JAX package leaves to XLA
around its kernels runs here as torch ops: the 95%-mass crossing, the
co-sort of the TN candidates with their k-mer values, the TK top-cap, the
plan, and the Z reductions.

The selection tests each column against its own mass (ref:
NTC.cpp:260-270, 328-341 test against the global Z; equal by the
forward-backward identity, but the global Z drifts from the per-column
sums in fp32 over ~16k steps). The per-read rung (ops/ntc_pre) keeps the
reference's global Z; the two round differently.

Native 9-mer NTC (K = 4^9) adds select_topk's two-stage top-cap and
pre_tk_batch_ckpt, the checkpoint-recompute TK pre-pass. The plan needs no
big-K branch: it builds no (T, K+1) tables (a sort and a binary search
find the slots), so its fields equal JAX's build_plan_batch(bigk=True)'s
on every live slot.
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
    descending sort (torch.topk does not order ties). At big K (W >= 32768,
    native 9-mer) it is JAX's exact two-stage top-cap: the top `cap` blocks
    of 128 lanes by their maxima, then the top `cap` of their cap*128
    lanes; ties within a block go to the lower lane, across blocks in
    block-max order (the JAX function's, ops/ntc_batch.py:95-115).
    """
    W = U.shape[-1]
    if cap <= 16:
        vals, idx = _topk_maxmask(U, cap)
    elif W >= 32768 and cap * 128 <= W and W % 128 == 0:
        rows = U.shape[0]
        Ub = U.reshape(rows, W // 128, 128)
        bidx = _stable_topk(torch.amax(Ub, dim=2), cap)[1]
        gath = torch.gather(Ub, 1, bidx[:, :, None].expand(-1, -1, 128))
        vals, li = _stable_topk(gath.reshape(rows, cap * 128), cap)
        idx = torch.gather(bidx, 1, li // 128) * 128 + li % 128
        del Ub, gath
    else:
        vals, idx = _stable_topk(U, cap)
    m = vals[:, :1]
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    tot = torch.sum(torch.exp(U - m_safe), dim=1, keepdim=True)
    return crossing_from_topk(vals, idx, tot, ge_break, col_live, sentinel)


def _stable_topk(U, cap: int):
    """(vals, idx) of the top `cap` of each row, descending, ties to the
    lower index (a stable descending sort)."""
    s = torch.sort(U, dim=-1, descending=True, stable=True)
    return s.values[:, :cap], s.indices[:, :cap]


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


def pre_tk_batch_ckpt(sig, T_r, means, c1, c2, log_m1, log_e2,
                      alphabet_size: int, cap: int, dtype, chunk: int = 128,
                      sel_cap: int | None = None) -> PreBatchResult:
    """pre_tk_batch with O(T/chunk * R * K) memory instead of O(T * R * K)
    (JAX ops/ntc_batch.pre_tk_batch_ckpt): the backward pass keeps only the
    (M, E) row entering each chunk of `chunk` rows; the forward pass
    re-derives each chunk's backward rows from it, then selects on the
    chunk's columns. It runs K9's and K10's plain columns as torch ops, so
    it equals pre_tk_batch bit for bit wherever both run; native 9-mer NTC
    (K = 4^9) needs it, as the kernels take at most 4096 columns. The
    emission scores and row masks are computed for blocks of rows at once
    (elementwise: the same values), to launch fewer ops per row.

    sel_cap (<= cap) searches the 95%-mass crossing within the top sel_cap
    values only and pads the slots back to `cap` with sentinels K: equal
    to the full-cap selection on every column whose crossing lies within
    sel_cap; a column whose crossing lies beyond it flags overflow."""
    R, Tm1 = sig.shape
    T_pad = Tm1 + 1
    if T_pad % chunk:
        raise ValueError(f"T_pad {T_pad} is not a multiple of the chunk {chunk}")
    sel_cap = cap if sel_cap is None else sel_cap
    if sel_cap > cap:
        raise ValueError(f"sel_cap {sel_cap} exceeds cap {cap}")
    sig = sig.to(dtype).contiguous()
    tabk = tk_tables(means, c1, c2, dtype)
    T_r = T_r.to(torch.int32)
    K, dev = tabk.shape[1], sig.device
    zero = torch.zeros((R, 1), dtype=dtype, device=dev)
    sig_b = torch.cat([sig, zero], dim=1)  # backward row t reads sig[t]
    sig_f = torch.cat([zero, sig], dim=1)  # forward row t reads sig[t-1]
    is_term, dead = kn.tk_row_masks(torch.arange(T_pad, device=dev)[:, None], T_r)
    cols = dict(alphabet_size=alphabet_size, log_m1=log_m1, log_e2=log_e2)
    sub = min(chunk, 32)  # rows of scores at once: (sub, R, K) temporaries

    def bwd_rows(t_hi, t_lo, M, E):
        """Backward rows t_hi-1 down to t_lo from the row t_hi (M, E);
        yields (t, M, E)."""
        for s_hi in range(t_hi, t_lo, -sub):
            s_lo = max(t_lo, s_hi - sub)
            sc = kn.tk_scores(sig_b[:, s_lo:s_hi].T, tabk)
            for t in range(s_hi - 1, s_lo - 1, -1):
                M, E = kn.tk_bwd_column(sc[t - s_lo], M, E, is_term[t], dead[t], **cols)
                yield t, M, E

    M = torch.full((R, K), NEG_INF, dtype=dtype, device=dev)
    E = M.clone()
    ckpts = [None] * (T_pad // chunk)
    for c in range(T_pad // chunk - 1, -1, -1):
        ckpts[c] = (M, E)
        for _, M, E in bwd_rows((c + 1) * chunk, c * chunk, M, E):
            pass
    Zb = logsumexp(E, dim=1)

    cand = torch.full((T_pad, R, cap), K, dtype=torch.int32, device=dev)
    cnt = torch.empty((T_pad, R), dtype=torch.int32, device=dev)
    ovf = torch.zeros((R,), dtype=torch.bool, device=dev)
    M = torch.full((R, K), NEG_INF, dtype=dtype, device=dev)
    E = torch.zeros_like(M)
    finalE = torch.where(is_term[0], E, M)
    U = torch.empty((chunk, R, K), dtype=dtype, device=dev)
    for c in range(T_pad // chunk):
        t0 = c * chunk
        rows = [None] * chunk
        for t, bM, bE in bwd_rows(t0 + chunk, t0, *ckpts[c]):
            rows[t - t0] = (bM, bE)
        ckpts[c] = None
        for s_lo in range(t0, t0 + chunk, sub):
            sc = kn.tk_scores(sig_f[:, s_lo:s_lo + sub].T, tabk)
            for t in range(s_lo, min(s_lo + sub, t0 + chunk)):
                if t > 0:
                    M, E = kn.tk_fwd_column(sc[t - s_lo], M, E, dead[t], **cols)
                    finalE = torch.where(is_term[t], E, finalE)
                bM, bE = rows[t - t0]
                U[t - t0] = torch.logaddexp(bM + M, bE + E)
                rows[t - t0] = None
        live = ~dead[t0:t0 + chunk].reshape(-1)
        cc, nn, oo = select_topk(U.reshape(chunk * R, K), sel_cap, True, live, K)
        cand[t0:t0 + chunk, :, :sel_cap] = cc.reshape(chunk, R, sel_cap)
        cnt[t0:t0 + chunk] = nn.reshape(chunk, R)
        ovf |= oo.reshape(chunk, R).any(dim=0)
    return PreBatchResult(cand=cand, cnt=cnt, Zf=logsumexp(finalE, dim=1),
                          Zb=Zb, overflow=ovf)


def tk_select(U, T_r, cap: int):
    """(cand, cnt, overflow) from K10's U (T_pad, R, K)."""
    T_pad, R, K = U.shape
    cand, cnt, ovf = select_topk(U.reshape(T_pad * R, K), cap, True,
                                 _col_live(T_pad, T_r), K)
    return dict(cand=cand.reshape(T_pad, R, cap), cnt=cnt.reshape(T_pad, R),
                overflow=ovf.reshape(T_pad, R).any(dim=0))


# ---------------------------------------------------------------------------
# the batched plan (counterpart of ops/ntc_batch.py:582-907)
# ---------------------------------------------------------------------------

# state indices (ref: NTC.cpp:699-703)
A_ST, P_ST, S_ST, E_ST, I_ST = 0, 1, 2, 3, 4
# the 13 log transitions, in the order the kernels take them
TL_KEYS = ("a1", "a2", "p1", "p2", "p3", "s1", "s2", "s3",
           "e2", "e3", "e4", "i1", "i2")
NTAB = 3 + 3 * 4   # K11's table rows: mu, c1, c2, then A successors of each
TG_ROWS = NTAB + 1  # #12's table rows: K11's, then a row of zeros


class NTCPlan(NamedTuple):
    """The sparse lattice of a bucket, every field (T_pad, R, ...).

    Per (t, read): CN n-slots (the TN candidates, ascending, sentinel N2)
    and CK = CK0 + CN k-slots (the TK candidates in selection order, then
    the read's own k-mer of each n-slot, sentinel K). A k-slot is dead if
    its value is K or an earlier slot holds the same value; slot maps find
    a value's FIRST slot in the neighbouring column (-1 if absent).
    """

    cand_n: torch.Tensor     # (T, R, CN) int32
    cnt_n: torch.Tensor      # (T, R) int32
    ks: torch.Tensor         # (T, R, CK) int32
    live: torch.Tensor       # (T, R, CK) bool
    from_tk: torch.Tensor    # (T, R, CK) bool: value among the TK candidates
    allowed: torch.Tensor    # (T, R, CN, CK) bool cell mask
    kN: torch.Tensor         # (T, R, CN) int32 kmer_seq[n-1], 0 if invalid
    kN2: torch.Tensor        # (T, R, CN) int32 kmer_seq[n], 0 if invalid
    hd: torch.Tensor         # (T, R, CN, CK) int16 hd1 | hd2<<4 | hd1s<<8 | hd2s<<12
    d01: torch.Tensor        # (T, R, CN) int8 first digit of kN
    d02: torch.Tensor        # (T, R, CN) int8 first digit of kN2
    row_same: torch.Tensor   # (T, R, CN) int32 slot of n in cand_n[t-1]
    row_prev: torch.Tensor   # (T, R, CN) slot of n-1 in cand_n[t-1]
    brow_same: torch.Tensor  # (T, R, CN) slot of n in cand_n[t+1]
    brow_next: torch.Tensor  # (T, R, CN) slot of n+1 in cand_n[t+1]
    col_same: torch.Tensor   # (T, R, CK) int32 slot of k in ks[t-1]
    col_prec: torch.Tensor   # (T, R, A, CK) slot of prec_a(k) in ks[t-1]
    bcol_same: torch.Tensor  # (T, R, CK) slot of k in ks[t+1]
    bcol_suc: torch.Tensor   # (T, R, A, CK) slot of suc_a(k) in ks[t+1]


class PlanDims(NamedTuple):
    R: int
    CN: int
    CK: int
    A: int


class NTCParams(NamedTuple):
    """Model parameters gathered into the plan's slots (kernel K11):
    dead k-slots (ks = K) read 0."""

    mu_k: torch.Tensor   # (T, R, CK)
    c1_k: torch.Tensor
    c2_k: torch.Tensor
    suc: torch.Tensor    # (T, 3, R, A*CK): mu, c1, c2 of suc_a(k), A-major
    nsl: torch.Tensor    # (T, 3, 2*R*CN): mu, c1, c2 at kN | at kN2

    def n_side(self, dims: PlanDims):
        """(mu_n, c1_n, c2_n, mu_n2, c1_n2, c2_n2), each (T, R, CN)."""
        T = self.nsl.shape[0]
        RC = dims.R * dims.CN
        sh = (T, dims.R, dims.CN)
        return tuple(self.nsl[:, s, o:o + RC].reshape(sh)
                     for o in (0, RC) for s in range(3))

    def suc_of(self, dims: PlanDims):
        """(mu_suc, c1_suc, c2_suc), each (T, R, A, CK)."""
        T = self.suc.shape[0]
        sh = (T, dims.R, dims.A, dims.CK)
        return tuple(self.suc[:, s].reshape(sh) for s in range(3))


def _first_slots(table, values, K: int):
    """First slot of each value in its row of `table` (T, R, W), -1 where
    absent or where the value is the sentinel K: the scatter-min inverse
    table of the JAX plan, by a stable sort and a binary search."""
    W = table.shape[-1]
    srt, order = torch.sort(table, dim=-1, stable=True)
    v = values.reshape(*values.shape[:2], -1).contiguous()
    pos = torch.searchsorted(srt.contiguous(), v)
    posc = pos.clamp(max=W - 1)
    hit = (pos < W) & (torch.gather(srt, -1, posc) == v) & (v < K)
    slot = torch.where(hit, torch.gather(order, -1, posc), -1)
    return slot.to(torch.int32).reshape(values.shape)


def _slot2(values, table):
    """First slot of each value in the (short) per-column table, -1 if
    absent: values (..., CN), table (..., CN)."""
    eq = values[..., :, None] == table[..., None, :]
    found = eq.any(-1)
    return torch.where(found, eq.to(torch.uint8).argmax(-1), -1).to(torch.int32)


def _hamming_lut(bits: int, ndigits: int, device):
    """Number of nonzero `bits`-wide digits of z, for z < 2^(bits*ndigits):
    the Hamming distance of two k-mers with a power-of-two alphabet is
    lut[a ^ b]."""
    z = torch.arange(1 << (bits * ndigits), device=device)
    cnt = torch.zeros_like(z)
    for p in range(ndigits):
        cnt += ((z >> (bits * p)) & ((1 << bits) - 1)) != 0
    return cnt


def build_plan_batch(cand_n, cnt_n, cand_k0, cnt_k, kmer_ids, N_r, K: int,
                     alphabet_size: int, kmer_size: int, kn1, kn2):
    """(NTCPlan, PlanDims) from the pre-pass candidates: cand_n (T, R, CN)
    ascending with sentinel N2, cand_k0 (T, R, CK0) in selection order with
    sentinel K, kmer_ids (R, N2-1), N_r (R,), kn1/kn2 (T, R, CN) the k-mer
    values at cand-1 and cand that the TN pass extracted. The fields equal
    the JAX scan path's plan (its `lite=False` build)."""
    A = alphabet_size
    if A & (A - 1):
        raise ValueError(f"the batched plan needs a power-of-two alphabet, not {A}")
    dev = cand_n.device
    i32 = torch.int32
    cand_n = cand_n.to(i32)
    cand_k0 = cand_k0.to(i32)
    T, R, CN = cand_n.shape
    N2 = kmer_ids.shape[1] + 1
    step = K // A
    Nr = N_r.to(i32)[None, :, None]

    n_valid = (torch.arange(CN, device=dev) < cnt_n[..., None]) & (cand_n < Nr)
    n_pos = n_valid & (cand_n >= 1)
    kN = torch.where(n_pos, kn1, 0).to(i32)
    base_k = torch.where(n_pos, kN, K)

    # the TK block holds distinct values (sentinels K are dead): only the
    # base slots can repeat a value, of the TK block or of an earlier base
    ks = torch.cat([cand_k0, base_k], dim=2)
    dup_tk = (base_k[..., :, None] == cand_k0[..., None, :]).any(-1)
    sl = torch.arange(CN, device=dev)
    dup_b = ((base_k[..., :, None] == base_k[..., None, :])
             & (sl[:, None] < sl[None, :])).any(-2)
    live = torch.cat([cand_k0 < K, (base_k < K) & ~dup_tk & ~dup_b], dim=2)
    from_tk = torch.cat([cand_k0 < K, dup_tk & (base_k < K)], dim=2)
    allowed = (live[:, :, None, :] & n_valid[..., None]
               & (from_tk[:, :, None, :]
                  | ((ks[:, :, None, :] == kN[..., None])
                     & (cand_n >= 1)[..., None])))

    kN2 = torch.where(n_valid & (cand_n < Nr - 1), kn2, 0).to(i32)
    ks_safe = ks.clamp(0, K - 1)
    bits = A.bit_length() - 1
    lut = _hamming_lut(bits, kmer_size, dev)
    low = (1 << (bits * (kmer_size - 1))) - 1
    kc = ks_safe[:, :, None, :]
    hd = (lut[(kN[..., None] ^ kc).long()]
          | (lut[(kN2[..., None] ^ kc).long()] << 4)
          | (lut[((kN[..., None] >> bits) ^ kc).long() & low] << 8)
          | (lut[((kN2[..., None] >> bits) ^ kc).long() & low] << 12)
          ).to(torch.int16)

    a = torch.arange(A, device=dev, dtype=i32)
    suc = (ks_safe % step)[:, :, None, :] * A + a[:, None]
    prec = (ks_safe // A)[:, :, None, :] + (a * step)[:, None]
    prev_n = torch.cat([torch.full_like(cand_n[:1], N2), cand_n[:-1]])
    next_n = torch.cat([cand_n[1:], torch.full_like(cand_n[:1], N2)])
    none_k = torch.full_like(ks[:1], K)
    prev_k = torch.cat([none_k, ks[:-1]])
    next_k = torch.cat([ks[1:], none_k])
    plan = NTCPlan(
        cand_n=cand_n, cnt_n=cnt_n.to(i32), ks=ks, live=live,
        from_tk=from_tk, allowed=allowed, kN=kN, kN2=kN2, hd=hd,
        d01=(kN % A).to(torch.int8), d02=(kN2 % A).to(torch.int8),
        row_same=_slot2(cand_n, prev_n), row_prev=_slot2(cand_n - 1, prev_n),
        brow_same=_slot2(cand_n, next_n), brow_next=_slot2(cand_n + 1, next_n),
        col_same=_first_slots(prev_k, ks, K),
        col_prec=_first_slots(prev_k, prec, K),
        bcol_same=_first_slots(next_k, ks, K),
        bcol_suc=_first_slots(next_k, suc, K),
    )
    return plan, PlanDims(R, CN, ks.shape[2], A)


def combined_tables(means, c1, c2, alphabet_size: int, dtype):
    """(NTAB, K) table K11 gathers from: rows mu, c1, c2 at k, then for
    tab in (mu, c1, c2) and a < A the row tab[(k % (K/A))*A + a] — the
    A-th successor's parameter, so successor gathers index by k itself."""
    K = means.shape[0]
    A = alphabet_size
    idx = (torch.arange(K, device=means.device) % (K // A)) * A
    rows = [means, c1, c2] + [tab[idx + a] for tab in (means, c1, c2)
                              for a in range(A)]
    return torch.stack(rows).to(dtype).contiguous()


def combined_tablesT(means, c1, c2, alphabet_size: int):
    """(TG_ROWS, K) float32 table #12 gathers from: combined_tables' rows,
    then a row of zeros (the TPU kernel's 16 sublanes)."""
    tab = combined_tables(means, c1, c2, alphabet_size, torch.float32)
    return torch.cat([tab, tab.new_zeros((1, tab.shape[1]))]).contiguous()


def gather_index(plan: NTCPlan):
    """(T, R*CK + 2*R*CN) int32 k-mer index rows for K11: the k-slot
    values, then kN, then kN2."""
    T = plan.ks.shape[0]
    return torch.cat([plan.ks.reshape(T, -1), plan.kN.reshape(T, -1),
                      plan.kN2.reshape(T, -1)], dim=1).contiguous()


# ---------------------------------------------------------------------------
# the 5-state lattice, plain versions of K13 and K15 (counterpart of
# ops/ntc_batch.py:913-1445, the scan path)
# ---------------------------------------------------------------------------
#
# The JAX scan gathers by one-hot matmuls (bit-identical to indexing) and
# runs the in-column I chains as associative scans; here the gathers index
# and each chain is a sequential fold over the n-slots, ascending in the
# forward and descending in the backward, which kernels K13 and K15 repeat
# op for op. Every logsumexp of a term list takes the max, then the
# exponentials summed in list order, then log(sum) + max.

def _lse(terms):
    m = terms[0]
    for x in terms[1:]:
        m = torch.maximum(m, x)
    fin = torch.isfinite(m)
    ms = torch.where(fin, m, 0.0)
    s = torch.exp(terms[0] - ms)
    for x in terms[1:]:
        s = s + torch.exp(x - ms)
    return torch.where(fin, torch.log(s) + ms, m)


def _first_match(cands):
    """(max, index of the first candidate attaining it) over an ordered
    list: the reference walk's check order becomes the stored choice."""
    m = cands[0]
    code = torch.zeros(m.shape, dtype=torch.int32, device=m.device)
    for idx, c in enumerate(cands[1:], 1):
        code = torch.where(c > m, idx, code)
        m = torch.maximum(m, c)
    return m, code


def _cell_index(rows, cols):
    """(flat index (R, 1, CN*CK), mask (R, 1, CN, CK)) of the cells at rows
    (R, CN) x cols (R, CK) of a column; the mask is False where either
    index is -1."""
    R, CN = rows.shape
    CK = cols.shape[1]
    flat = rows.clamp(min=0).long()[:, :, None] * CK + cols.clamp(min=0).long()[:, None, :]
    ok = (rows >= 0)[:, :, None] & (cols >= 0)[:, None, :]
    return flat.reshape(R, 1, CN * CK), ok[:, None]


def _take(col, index):
    """col (R, S, CN, CK) gathered at a _cell_index, every state at once:
    (R, S, CN, CK), -inf off the mask."""
    flat, ok = index
    R, S = col.shape[:2]
    g = torch.gather(col.reshape(R, S, -1), 2, flat.expand(R, S, -1))
    return torch.where(ok, g.reshape(col.shape), NEG_INF)


def _cell(x, rows, cols):
    """x (R, CN, CK) gathered at rows (R, CN) x cols (R, CK): (R, CN, CK),
    -inf where either index is -1."""
    flat, ok = _cell_index(rows, cols)
    g = torch.gather(x.reshape(x.shape[0], -1), 1, flat[:, 0])
    return torch.where(ok[:, 0], g.reshape(x.shape), NEG_INF)


def _cell_a(x, rows, cols):
    """x (R, CN, CK) gathered at rows (R, CN) x cols (R, A, CK), one cell
    set per digit: (R, A, CN, CK), -inf where either index is -1."""
    R, CN, CK = x.shape
    A = cols.shape[1]
    flat = (rows.clamp(min=0).long()[:, None, :, None] * CK
            + cols.clamp(min=0).long()[:, :, None, :])
    ok = (rows >= 0)[:, None, :, None] & (cols >= 0)[:, :, None, :]
    g = torch.gather(x.reshape(R, -1), 1, flat.reshape(R, -1))
    return torch.where(ok, g.reshape(R, A, CN, CK), NEG_INF)


def _score(x, mu, c1, c2):
    d = x - mu
    return c1 - c2 * d * d


def _hd_parts(hd, dtype):
    h = hd.to(torch.int32)
    return tuple(((h >> s) & 15).to(dtype) for s in (0, 4, 8, 12))


class _Rows(NamedTuple):
    """What every column of one bucket's lattice reads besides the plan:
    the signal at t and t-1 by row t, and K11's parameters unpacked."""

    x: torch.Tensor      # (R, T_pad) sig[t], 0 at t = T_pad-1
    xm: torch.Tensor     # (R, T_pad) sig[t-1], 0 at t = 0
    n_side: tuple        # NTCParams.n_side
    suc: tuple           # NTCParams.suc_of
    prm: NTCParams


def _rows(dims: PlanDims, prm: NTCParams, sig) -> _Rows:
    zero = torch.zeros((sig.shape[0], 1), dtype=sig.dtype, device=sig.device)
    return _Rows(torch.cat([sig, zero], 1), torch.cat([zero, sig], 1),
                 prm.n_side(dims), prm.suc_of(dims), prm)


def _bwd_column(plan: NTCPlan, dims: PlanDims, rows: _Rows, tl: dict, t: int,
                nxt, Nm1, terms: bool = False):
    """Backward column t (R, 5, CN, CK), masked by `allowed`, from the
    stored column t+1 `nxt` (ref: NTC.cpp:500-578). With terms=True also
    what the training terms pair with the forward of t (ntc_train_batch):
    the masks, scores and gathered successors of column t+1."""
    R, CN, CK, A = dims
    dtype, dev = nxt.dtype, nxt.device
    prm = rows.prm
    mu_n, c1_n, c2_n, mu_n2, c1_n2, c2_n2 = rows.n_side
    mu_s, c1_s, c2_s = rows.suc
    w = lambda c, v: torch.where(c, v, NEG_INF)
    x = rows.x[:, t:t + 1]
    xm = rows.xm[:, t:t + 1]
    cn = plan.cand_n[t].long()
    n_pos = (cn >= 1)[:, :, None]
    n_lt = (cn < Nm1)[:, :, None]
    hd1, hd2, hd1s, hd2s = _hd_parts(plan.hd[t], dtype)
    hd1, hd2 = -2.0 * hd1, -2.0 * hd2
    scn = _score(x, mu_n[t], c1_n[t], c2_n[t])[:, :, None]
    scn2 = _score(x, mu_n2[t], c1_n2[t], c2_n2[t])[:, :, None]
    sck = _score(x, prm.mu_k[t], prm.c1_k[t], prm.c2_k[t])[:, None, :]
    sc1 = scn + sck + hd1
    sc2 = scn2 + sck + hd2
    bs, bn = plan.brow_same[t], plan.brow_next[t]
    cs = plan.bcol_same[t]
    gskE = _cell(nxt[:, E_ST], bs, cs)
    gnkS = _cell(nxt[:, S_ST], bn, cs)
    a_new = w(n_pos, gskE + sc1)
    p_new = torch.logaddexp(w(n_pos, gskE + tl["e2"] + sc1),
                            w(n_lt, gnkS + tl["s1"] + sc2))
    # the A successor digits at once, dim 1: (R, A, CN, CK)
    cu = plan.bcol_suc[t]
    scs = _score(x[:, :, None], mu_s[t], c1_s[t], c2_s[t])[:, :, None, :]
    digit = torch.arange(A, device=dev)[None, :, None, None]
    m1 = (plan.d01[t][:, None, :, None] != digit).to(dtype)
    m2 = (plan.d02[t][:, None, :, None] != digit).to(dtype)
    sc1s = scn[:, None] + scs - 2.0 * (hd1s[:, None] + m1)
    sc2s = scn2[:, None] + scs - 2.0 * (hd2s[:, None] + m2)
    gspP = w(n_pos[:, None], _cell_a(nxt[:, P_ST], bs, cu) + sc1s)
    gnaA = w(n_lt[:, None], _cell_a(nxt[:, A_ST], bn, cu) + sc2s)
    sP1, eP2, iP3 = gspP + tl["p1"], gspP + tl["p2"], gspP + tl["p3"]
    eA1, iA2 = gnaA + tl["a1"], gnaA + tl["a2"]
    s_terms = [w(n_pos, gskE + tl["e3"] + sc1)] + [sP1[:, a] for a in range(A)]
    e_terms = [w(n_pos, gskE + tl["e4"] + sc1)]
    i_terms = []
    for a in range(A):
        e_terms += [eP2[:, a], eA1[:, a]]
        i_terms += [iP3[:, a], iA2[:, a]]
    gnkS2 = gnkS + sc2
    e_terms.append(w(n_lt, gnkS2 + tl["s2"]))
    i_terms.append(w(n_lt, gnkS2 + tl["s3"]))
    s_new = _lse(s_terms)
    e_new = _lse(e_terms)
    i_new = _lse(i_terms)

    # same-t I chain (ref: NTC.cpp:565-572), folded from the last n-slot
    # down: slot i takes slot i+1 where cand_n continues
    scm = _score(xm, mu_n2[t], c1_n2[t], c2_n2[t])[:, :, None] \
        + _score(xm, prm.mu_k[t], prm.c1_k[t], prm.c2_k[t])[:, None, :]
    sc_i = scm + hd2
    ok_i = torch.zeros((R, CN), dtype=torch.bool, device=dev)
    if t > 0:
        ok_i[:, :-1] = (cn[:, 1:] == cn[:, :-1] + 1) & (cn[:, :-1] < Nm1)
    iB = torch.where(ok_i[:, :, None], tl["i2"] + sc_i, NEG_INF)
    for i in range(CN - 2, -1, -1):
        below = i_new[:, i + 1]
        i_new[:, i] = torch.logaddexp(i_new[:, i], below + iB[:, i])
        e_new[:, i] = torch.logaddexp(
            e_new[:, i], w(ok_i[:, i, None], below + tl["i1"] + sc_i[:, i]))

    col = torch.stack([a_new, p_new, s_new, e_new, i_new], dim=1)
    col = torch.where(plan.allowed[t][:, None], col, NEG_INF)
    if not terms:
        return col
    return col, dict(n_pos=n_pos, n_lt=n_lt, sc1=sc1, sc2=sc2, gskE=gskE,
                     gnkS=gnkS, gspP=gspP, gnaA=gnaA, ok_i=ok_i[:, :, None],
                     sc_i=sc_i)


def _bwd_stored(plan: NTCPlan, t: int, col, Nm1, T_r):
    """The column the store keeps at row t: the terminal column at t =
    T_r-1 (E = 0 at allowed cells of n = N_r-1), -inf past it."""
    cn = plan.cand_n[t].long()
    term = torch.full_like(col, NEG_INF)
    term[:, E_ST] = torch.where((cn == Nm1)[:, :, None] & plan.allowed[t], 0.0,
                                NEG_INF)
    is_term = (t == T_r - 1)[:, None, None, None]
    dead = (t > T_r - 1)[:, None, None, None]
    return torch.where(is_term, term, torch.where(dead, NEG_INF, col))


def _bwd_chunk(plan: NTCPlan, dims: PlanDims, rows: _Rows, tl: dict, nxt,
               t0: int, C: int, Nm1, T_r) -> list:
    """The stored backward rows t0 .. t0+C-1 re-derived from `nxt`, the
    stored row t0+C (a checkpoint), from the last row down."""
    out = [None] * C
    for i in range(C - 1, -1, -1):
        col = _bwd_column(plan, dims, rows, tl, t0 + i, nxt, Nm1)
        nxt = _bwd_stored(plan, t0 + i, col, Nm1, T_r)
        out[i] = nxt
    return out


def ntc_backward_batch(plan: NTCPlan, dims: PlanDims, prm: NTCParams, sig,
                       trans_log: dict, N_r, T_r):
    """The backward lattice (T_pad, R, 5, CN, CK), every row (ref:
    NTC.cpp:500-578); row T_r-1 is the terminal column (E = 0 at n = N_r-1),
    rows past it are -inf. sig (R, T_pad-1) in the working dtype."""
    R, CN, CK, _ = dims
    T_pad = plan.cand_n.shape[0]
    dtype, dev = sig.dtype, sig.device
    rows = _rows(dims, prm, sig)
    Nm1 = (N_r.long() - 1)[:, None]
    out = torch.empty((T_pad, R, 5, CN, CK), dtype=dtype, device=dev)
    nxt = torch.full((R, 5, CN, CK), NEG_INF, dtype=dtype, device=dev)
    for t in range(T_pad - 1, -1, -1):
        col = _bwd_column(plan, dims, rows, trans_log, t, nxt, Nm1)
        nxt = _bwd_stored(plan, t, col, Nm1, T_r)
        out[t] = nxt
    return out


# rows per checkpoint chunk of the checkpointed backward (JAX's C_PV on its
# checkpointed geometries, ops/ntc_pallas.py:86-89)
C_CKPT = 8


def ntc_backward_ckpt_batch(plan: NTCPlan, dims: PlanDims, prm: NTCParams,
                            sig, trans_log: dict, N_r, T_r, C: int = C_CKPT):
    """The backward lattice of ntc_backward_batch, keeping only what the
    checkpointed forward needs (ref: ntc_pallas._bwd_ckpt_kernel): ckpt
    (T_pad/C, R, 5, CN, CK), the stored row that enters chunk c, i.e.
    row (c+1)*C, -inf for the last chunk; and row0 (R, 5, CN, CK)."""
    R, CN, CK, _ = dims
    T_pad = plan.cand_n.shape[0]
    if T_pad % C:
        raise ValueError(f"T_pad {T_pad} is not a multiple of the chunk {C}")
    dtype, dev = sig.dtype, sig.device
    rows = _rows(dims, prm, sig)
    Nm1 = (N_r.long() - 1)[:, None]
    ckpt = torch.empty((T_pad // C, R, 5, CN, CK), dtype=dtype, device=dev)
    nxt = torch.full((R, 5, CN, CK), NEG_INF, dtype=dtype, device=dev)
    ckpt[-1] = nxt
    for t in range(T_pad - 1, -1, -1):
        col = _bwd_column(plan, dims, rows, trans_log, t, nxt, Nm1)
        nxt = _bwd_stored(plan, t, col, Nm1, T_r)
        if t % C == 0 and t > 0:
            ckpt[t // C - 1] = nxt
    return ckpt, nxt


def _init_column(plan: NTCPlan, dims: PlanDims, dtype):
    """t = 0: E = 0 at allowed cells of rows with n == 0."""
    R, CN, CK, _ = dims
    col = torch.full((R, 5, CN, CK), NEG_INF, dtype=dtype,
                     device=plan.cand_n.device)
    row0 = (plan.cand_n[0] == 0)[:, :, None] & plan.allowed[0]
    col[:, E_ST] = torch.where(row0, 0.0, NEG_INF)
    return col


def _fwd_maps(plan: NTCPlan, t: int, A: int):
    """(ok, cond, ix) of column t >= 1: the cell mask, the I-chain mask
    (slot i continues slot i-1's n) and the four predecessor cell sets,
    rows same/prev x cols same/preceding (one per digit)."""
    cn = plan.cand_n[t].long()
    ok = plan.allowed[t] & (cn >= 1)[:, :, None]
    chain = torch.zeros(cn.shape, dtype=torch.bool, device=cn.device)
    chain[:, 1:] = cn[:, :-1] == cn[:, 1:] - 1
    rs, rp = plan.row_same[t], plan.row_prev[t]
    cs = plan.col_same[t]
    cp = [plan.col_prec[t][:, a] for a in range(A)]
    ix = (_cell_index(rs, cs), _cell_index(rp, cs),
          [_cell_index(rs, c) for c in cp], [_cell_index(rp, c) for c in cp])
    return ok, chain[:, :, None] & ok, ix


def _fwd_column(plan: NTCPlan, dims: PlanDims, rows: _Rows, tl: dict, t: int,
                f_prev, ok, cond, ix):
    """Forward column t >= 1 (R, 5, CN, CK) from column t-1 (ref:
    NTC.cpp:430-495); the maps are _fwd_maps(plan, t)."""
    A = dims.A
    prm = rows.prm
    mu_n, c1_n, c2_n = rows.n_side[:3]
    w = lambda c, v: torch.where(c, v, NEG_INF)
    ix_rs_cs, ix_rp_cs, ix_rs_cp, ix_rp_cp = ix
    x = rows.xm[:, t:t + 1]
    sc = (_score(x, mu_n[t], c1_n[t], c2_n[t])[:, :, None]
          + _score(x, prm.mu_k[t], prm.c1_k[t], prm.c2_k[t])[:, None, :]
          + -2.0 * _hd_parts(plan.hd[t], f_prev.dtype)[0])
    f_ss, f_ps = _take(f_prev, ix_rs_cs), _take(f_prev, ix_rp_cs)
    a_terms, p_terms = [], []
    for ai in range(A):
        f_pp, f_sp = _take(f_prev, ix_rp_cp[ai]), _take(f_prev, ix_rs_cp[ai])
        a_terms += [f_pp[:, E_ST] + tl["a1"], f_pp[:, I_ST] + tl["a2"]]
        p_terms += [f_sp[:, S_ST] + tl["p1"], f_sp[:, E_ST] + tl["p2"],
                    f_sp[:, I_ST] + tl["p3"]]
    a_new = w(ok, _lse(a_terms) + sc)
    p_new = w(ok, _lse(p_terms) + sc)
    s_new = w(ok, _lse([f_ps[:, P_ST] + tl["s1"], f_ps[:, E_ST] + tl["s2"],
                        f_ps[:, I_ST] + tl["s3"]]) + sc)
    e_new = w(ok, _lse([f_ss[:, A_ST], f_ss[:, P_ST] + tl["e2"],
                        f_ss[:, S_ST] + tl["e3"],
                        f_ss[:, E_ST] + tl["e4"]]) + sc)
    # I: in-column chain over the n-slots (ref: NTC.cpp:474-477)
    i_new = torch.full_like(e_new, NEG_INF)
    for i in range(1, dims.CN):
        iA = w(cond[:, i], e_new[:, i - 1] + tl["i1"] + sc[:, i])
        iB = w(cond[:, i], tl["i2"] + sc[:, i])
        i_new[:, i] = torch.logaddexp(iA, i_new[:, i - 1] + iB)
    return torch.stack([a_new, p_new, s_new, e_new, i_new], dim=1)


def ntc_forward_store_batch(plan: NTCPlan, dims: PlanDims, prm: NTCParams,
                            sig, trans_log: dict):
    """The forward lattice (T_pad, R, 5, CN, CK), every row, in sig's
    dtype: row 0 the initial column, then the recurrence of
    ntc_posterior_viterbi_batch's forward over every row (rows past T_r-1
    included, as the JAX kernel runs them)."""
    R, CN, CK, A = dims
    T_pad = plan.cand_n.shape[0]
    rows = _rows(dims, prm, sig)
    out = torch.empty((T_pad, R, 5, CN, CK), dtype=sig.dtype, device=sig.device)
    f = _init_column(plan, dims, sig.dtype)
    out[0] = f
    for t in range(1, T_pad):
        f = _fwd_column(plan, dims, rows, trans_log, t, f, *_fwd_maps(plan, t, A))
        out[t] = f
    return out


# the 13 transition terms of training, in the order the train kernel
# accumulates them (ref: NTC.cpp:935-999)
TERMS = ("e2", "e3", "e4", "s1", "s2", "s3", "p1", "p2", "p3",
         "a1", "a2", "i1", "i2")
# the forward state each term leaves from
TERM_STATES = (P_ST, S_ST, E_ST, P_ST, E_ST, I_ST, S_ST, E_ST, I_ST,
               E_ST, I_ST, E_ST, I_ST)


def ntc_train_batch(plan: NTCPlan, dims: PlanDims, prm: NTCParams, sig, fwd,
                    Z, trans_log: dict, N_r, T_r, K: int, bwd_out=None):
    """The Baum-Welch sums of a bucket (ref: trainParams, NTC.cpp:923-1130):
    the backward recurrence of ntc_backward_batch over the forward store
    `fwd` (ntc_forward_store_batch), normalized by Z (R,) = Zf. Returns

      tacc (13, R, CN, CK)  per cell, the logaddexp over t of each term in
                            TERMS order, fwd[t] paired with the backward of
                            t+1 (i1/i2: with the stored I of slot i+1 at t);
      em   (R, 3, K)        k-mer moment sums [w, w*d, w*d*d], d = sig[t-1]
                            - mu_k, w = exp(lse over the 5 states of fwd[t]
                            + bwd[t] - Z) at allowed cells of t >= 1;
      b0   (R, 5, CN, CK)   the backward store's row 0.

    Per row, the CN cells of a k-slot are summed in n order and the sum is
    added to the bin of the slot's k-mer; live slots hold distinct k-mers,
    so every bin takes at most one sum per row. `bwd_out`, if given,
    receives the backward store (equal to ntc_backward_batch's)."""
    R, CN, CK, A = dims
    T_pad = fwd.shape[0]
    dtype, dev = sig.dtype, sig.device
    tl = trans_log
    rows = _rows(dims, prm, sig)
    Nm1 = (N_r.long() - 1)[:, None]
    Zc = Z.to(dtype)[:, None, None, None]
    w = lambda c, v: torch.where(c, v, NEG_INF)
    acc = torch.full((len(TERMS), R, CN, CK), NEG_INF, dtype=dtype, device=dev)
    tlv = torch.tensor([tl[k] for k in TERMS], dtype=dtype, device=dev)[:, None, None, None]
    em = torch.zeros((3, R * K), dtype=dtype, device=dev)
    bin0 = (torch.arange(R, device=dev) * K)[:, None]
    none_below = torch.full((R, 1, CK), NEG_INF, dtype=dtype, device=dev)
    nxt = torch.full((R, 5, CN, CK), NEG_INF, dtype=dtype, device=dev)
    for t in range(T_pad - 1, -1, -1):
        col, g = _bwd_column(plan, dims, rows, tl, t, nxt, Nm1, terms=True)
        nxt = _bwd_stored(plan, t, col, Nm1, T_r)
        if bwd_out is not None:
            bwd_out[t] = nxt
        # each term's forward state + its transition, stacked in TERMS order
        base = fwd[t][:, TERM_STATES].transpose(0, 1) + tlv
        term = torch.empty_like(base)
        term[0:3] = w(g["n_pos"], base[0:3] + g["sc1"] + g["gskE"])
        term[3:6] = w(g["n_lt"], base[3:6] + g["sc2"] + g["gnkS"])
        # p1-p3 and a1-a2 sum over the successor digits, in digit order
        for lo, hi, gx in ((6, 9, g["gspP"]), (9, 11, g["gnaA"])):
            x = torch.full_like(base[lo:hi], NEG_INF)
            for a in range(A):
                x = torch.logaddexp(x, base[lo:hi] + gx[:, a])
            term[lo:hi] = x
        # i1/i2 stay within column t: the stored I of slot i+1
        bI_up = torch.cat([nxt[:, I_ST, 1:], none_below], dim=1)
        term[11:13] = w(g["ok_i"], base[11:13] + g["sc_i"] + bI_up)
        acc = torch.logaddexp(acc, term)
        if t == 0:
            continue
        ap = fwd[t] + nxt - Zc
        lw = ap[:, 0]
        for st in range(1, 5):
            lw = torch.logaddexp(lw, ap[:, st])
        wt = torch.where(plan.allowed[t], torch.exp(lw), 0.0)
        d = (rows.xm[:, t:t + 1] - prm.mu_k[t])[:, None, :]
        wd = wt * d
        v = torch.stack([wt, wd, wd * d])
        s = v[:, :, 0]
        for i in range(1, CN):
            s = s + v[:, :, i]
        # distinct bins: a plain add per bin (index_add_ on CUDA is an
        # atomic add, which flushes fp32 subnormals to zero)
        live = plan.live[t]
        idx = (bin0 + plan.ks[t].long())[live]
        em[:, idx] += s[:, live]
    return acc, em.reshape(3, R, K).transpose(0, 1).contiguous(), nxt


def slot_bits(CK: int) -> int:
    """Width of one field of the predecessor-slot word (slots + 1 reach CK)."""
    return CK.bit_length()


def ntc_posterior_viterbi_batch(plan: NTCPlan, dims: PlanDims,
                                prm: NTCParams, sig, bwd, Z_norm,
                                trans_log: dict, T_r, out=None, fwd_out=None,
                                ckpt=None, N_r=None):
    """The forward pass with posteriors and the 5-state Viterbi (ref:
    getBorders, NTC.cpp:595-669). Returns (lp (T_pad, R, 5, CN, CK),
    choices (T_pad, R, CN, CK) int16, slots (T_pad, R, CN, CK) int32,
    apE_final, fwdE_final (R, CN, CK)).

    lp = fwd + bwd normalized by each column's own logsumexp in fp32 (the
    sum of exp(ap - max) taken in ntc_pre_kernels._tree_sum's order over
    the flat (5, CN, CK) column with threads(CN*CK) threads) — equal to Z
    by the forward-backward identity but free of Z's fp32 drift over 16k
    steps — and by Z_norm (Zb) in fp64. The Viterbi runs on fwd + bwd -
    Z_norm in both. Choice word: E 2 bits | A 3 << 2 | P 4 << 5 | S 2 << 9 |
    I 1 << 11 (the walk's check order); slot word: col_same + 1 | A's
    col_prec + 1 << b | P's col_prec + 1 << 2b, b = slot_bits(CK).
    `out`, if given, receives lp (it may be `bwd` itself: row t of bwd is
    read before row t of lp is written); `fwd_out`, if given, the forward
    store (equal to ntc_forward_store_batch's).

    Checkpoint mode (ref: ntc_pallas._pv_kernel, ckpt=True): with bwd None
    and `ckpt` (with N_r) from ntc_backward_ckpt_batch, each chunk's
    backward rows are re-derived from its checkpoint at the chunk's first
    row, by the same column function, so every output equals the full
    store's bit for bit."""
    from dynamont_tpu_torch.ops.ntc_pre_kernels import _tree_sum, threads

    R, CN, CK, A = dims
    T_pad = plan.cand_n.shape[0]
    dtype, dev = sig.dtype, sig.device
    fp32 = dtype == torch.float32
    B = threads(CN * CK)
    rows = _rows(dims, prm, sig)
    Zc = Z_norm.to(dtype)[:, None, None, None]
    if ckpt is not None:
        C = T_pad // ckpt.shape[0]
        Nm1 = (N_r.long() - 1)[:, None]
    lp_out = out if out is not None else torch.empty(
        (T_pad, R, 5, CN, CK), dtype=dtype, device=dev)
    choices = torch.empty((T_pad, R, CN, CK), dtype=torch.int16, device=dev)
    init = _init_column(plan, dims, dtype)
    f_prev, v_prev = init, init
    apEf = torch.full((R, CN, CK), NEG_INF, dtype=dtype, device=dev)
    fwdEf = apEf.clone()
    w = lambda c, v: torch.where(c, v, NEG_INF)
    for t in range(T_pad):
        if t == 0:
            fwd = init
        else:
            ok, cond, ix = _fwd_maps(plan, t, A)
            ix_rs_cs, ix_rp_cs, ix_rs_cp, ix_rp_cp = ix
            fwd = _fwd_column(plan, dims, rows, trans_log, t, f_prev, ok, cond, ix)
        if fwd_out is not None:
            fwd_out[t] = fwd
        if ckpt is None:
            bw = bwd[t]
        else:
            if t % C == 0:
                chunk = _bwd_chunk(plan, dims, rows, trans_log, ckpt[t // C],
                                   t, C, Nm1, T_r)
            bw = chunk[t % C]

        ap = fwd + bw
        lp = ap - Zc
        if fp32:
            m = torch.amax(ap.reshape(R, -1), dim=1)
            fin = torch.isfinite(m)
            ms = torch.where(fin, m, 0.0)
            tot = _tree_sum(torch.exp(ap.reshape(R, -1) - ms[:, None]), B)
            colZ = (ms + torch.log(tot))[:, None, None, None]
            lp_out[t] = torch.where(fin[:, None, None, None], ap - colZ, NEG_INF)
        else:
            lp_out[t] = lp

        if t == 0:
            vit = init
            packed = torch.zeros((R, CN, CK), dtype=torch.int32, device=dev)
        else:
            v_ss, v_ps = _take(v_prev, ix_rs_cs), _take(v_prev, ix_rp_cs)
            a_c, p_c = [], []
            for ai in range(A):
                v_pp, v_sp = _take(v_prev, ix_rp_cp[ai]), _take(v_prev, ix_rs_cp[ai])
                a_c += [v_pp[:, E_ST], v_pp[:, I_ST]]
                p_c += [v_sp[:, E_ST], v_sp[:, S_ST], v_sp[:, I_ST]]
            a_max, ch_a = _first_match(a_c)
            p_max, ch_p = _first_match(p_c)
            s_max, ch_s = _first_match([v_ps[:, E_ST], v_ps[:, P_ST], v_ps[:, I_ST]])
            e_max, ch_e = _first_match([v_ss[:, E_ST], v_ss[:, A_ST], v_ss[:, S_ST],
                                        v_ss[:, P_ST]])
            va = w(ok, a_max + lp[:, A_ST])
            vpp = w(ok, p_max + lp[:, P_ST])
            vs = w(ok, s_max + lp[:, S_ST])
            ve = w(ok, e_max + lp[:, E_ST])
            lpI = lp[:, I_ST]
            vi = torch.full_like(ve, NEG_INF)
            ch_i = torch.zeros_like(ch_e)
            for i in range(1, CN):
                viA = w(cond[:, i], ve[:, i - 1] + lpI[:, i])
                viB = w(cond[:, i], lpI[:, i])
                # E overrides I on ties (ref: NTC.cpp:884-893)
                ch_i[:, i] = torch.where(ve[:, i - 1] >= vi[:, i - 1], 0, 1)
                vi[:, i] = torch.maximum(viA, vi[:, i - 1] + viB)
            vit = torch.stack([va, vpp, vs, ve, vi], dim=1)
            packed = (ch_e | (ch_a << 2) | (ch_p << 5) | (ch_s << 9)
                      | (ch_i << 11))
        choices[t] = packed.to(torch.int16)
        is_term = (t == T_r - 1)[:, None, None]
        apEf = torch.where(is_term, vit[:, E_ST], apEf)
        fwdEf = torch.where(is_term, fwd[:, E_ST], fwdEf)
        f_prev, v_prev = fwd, vit
    return lp_out, choices, pred_slots(plan, choices), apEf, fwdEf


def pred_slots(plan: NTCPlan, choices):
    """The predecessor-slot word of every cell (T_pad, R, CN, CK) int32
    from the choice words: col_same + 1 | col_prec of A's chosen digit + 1
    << b | col_prec of P's chosen digit + 1 << 2b, b = slot_bits(CK)."""
    T, R, A, CK = plan.col_prec.shape
    CN = choices.shape[2]
    SLB = slot_bits(CK)
    out = torch.empty(choices.shape, dtype=torch.int32, device=choices.device)
    for t0 in range(0, T, 1024):  # bounds the int64 temporaries
        rows = slice(t0, t0 + 1024)
        ch = choices[rows].to(torch.int64)
        cpt = plan.col_prec[rows, :, :, None, :].expand(-1, R, A, CN, CK)
        cpa = lambda ai: torch.gather(cpt, 2, ai[:, :, None])[:, :, 0].long()
        out[rows] = ((plan.col_same[rows, :, None, :].long() + 1)
                     | ((cpa((ch >> 3) & 3) + 1) << SLB)
                     | ((cpa(((ch >> 5) & 15) // 3) + 1) << (2 * SLB)))
    return out


def _final_row_masks(plan: NTCPlan, N_r, T_r):
    """(cand_last (R, CN), mask (R, CN, CK)) of the terminal column t = T_r-1:
    cells at n = N_r-1, allowed and live."""
    R = plan.cand_n.shape[1]
    r = torch.arange(R, device=plan.cand_n.device)
    tm1 = T_r.long() - 1
    cand_last = plan.cand_n[tm1, r]
    mask = ((cand_last == (N_r.long() - 1)[:, None])[:, :, None]
            & plan.allowed[tm1, r] & plan.live[tm1, r][:, None, :])
    return cand_last, mask


def ntc_zf_batch(plan: NTCPlan, fwdE_final, N_r, T_r):
    """Zf from the forward terminal E column (ref: NTC_main.cpp:159-165)."""
    _, mask = _final_row_masks(plan, N_r, T_r)
    return logsumexp(torch.where(mask, fwdE_final, NEG_INF).flatten(1), dim=1)


def ntc_zb_batch(plan: NTCPlan, bwd0):
    """Zb over E at (t = 0, n == 0) (ref: NTC_main.cpp:152-158); bwd0 is
    the backward store's row 0, (R, 5, CN, CK)."""
    row0 = ((plan.cand_n[0] == 0)[:, :, None] & plan.allowed[0]
            & plan.live[0][:, None, :])
    return logsumexp(torch.where(row0, bwd0[:, E_ST], NEG_INF).flatten(1), dim=1)

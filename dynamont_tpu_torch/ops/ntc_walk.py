"""The 5-state NTC traceback over the stored Viterbi choices (counterpart of
dynamont_tpu/ops/ntc_walk.py; ref: src/cpp/NTC.cpp:691-904).

The reference walks the sparse APSEI lattice on the host with equality
checks against the stored max-DP values. The batched path stores, per cell,
the choice (the first predecessor in the reference's check order that
attains the max) and the predecessor k-slots it leads to (both from K15),
and replays the walk backwards over t:

* per column, up to N_MICRO micro-steps: in-column I-steps (n-1 -> n within
  the same t, ref: NTC.cpp:884-893) and exactly one t-decrementing step;
* every micro-step writes one record (prob, p_seg, emit, state, basepos,
  start, k, e_seg); finish_records reduces them to per-segment summaries
  and the segment's median probability (ref: NTC.cpp:718-723).

walk_records_plain is the plain version of kernel K16 (ops/ntc_kernels);
finish_records runs as torch ops on the records' device, as it runs as XLA
in the JAX package.

State legend (ref: NTC.cpp:699-703): A(lign) P(olish) S(equence) E(xtend)
I(nsert); A/P close segments ("M"/"P" rows with the polish k-mer).
"""

from __future__ import annotations

import math

import torch

from dynamont_tpu_torch.ops.ntc_batch import (
    A_ST, E_ST, I_ST, P_ST, S_ST, NTCPlan, _final_row_masks, slot_bits,
)

NEG_INF = -math.inf
NREC = 8   # record fields: prob, p_seg, emit, state, basepos, start, k, e_seg


def n_micro(CN: int) -> int:
    """Micro-steps per column: the t-step and up to two in-column I-steps
    (longer insertion chains are vanishingly rare; the walk then flags the
    read stuck and the engine re-runs it)."""
    return min(CN - 1, 2) + 1


def start_slots(plan: NTCPlan, apE_final, N_r, T_r):
    """Initial walk cell: the last (ascending-k) live slot attaining the
    max of APSEI[T-1, N-1, :, E] (ref '>=' update over k ascending,
    NTC.cpp:656-664). Returns (i0, j0, k0, valid), each (R,)."""
    _, mask = _final_row_masks(plan, N_r, T_r)
    R, CN, CK = mask.shape
    v = torch.where(mask, apE_final, NEG_INF).reshape(R, CN * CK)
    best = torch.amax(v, dim=1)
    idx = torch.arange(CN * CK, device=v.device)
    # the last slot holding the max (an all--inf row gives the last slot,
    # as JAX's argmax over the reversed row does)
    flat = torch.where(v == best[:, None], idx, -1).amax(dim=1)
    valid = torch.isfinite(best)
    i0 = (flat // CK).to(torch.int32)
    j0 = (flat % CK).to(torch.int32)
    r = torch.arange(R, device=v.device)
    k0 = plan.ks[T_r.long() - 1, r, j0.long()].to(torch.int32)
    return i0, j0, k0, valid


def walk_records_plain(lp, choices, slots, row_same, row_prev, i0, j0, k0,
                       valid, N_r, T_r, K: int, A: int, kmer_size: int,
                       S_max: int):
    """The walk of every read of a bucket: (records (T_pad, N_MICRO, R,
    NREC) in lp's dtype, fin (R, 2) int32 = [segments emitted, stuck])."""
    T_pad, R, _, CN, CK = lp.shape
    dev, dtype = lp.device, lp.dtype
    NM = n_micro(CN)
    SLB = slot_bits(CK)
    SLM = (1 << SLB) - 1
    Kdiv = K // A
    half = kmer_size // 2
    z = lambda: torch.zeros(R, dtype=torch.int64, device=dev)
    active = torch.zeros(R, dtype=torch.bool, device=dev)
    stuck = torch.zeros_like(active)
    state, i, j, k, n, seg = z(), z(), z(), z(), z(), z()
    r = torch.arange(R, device=dev)
    i0, j0, k0 = i0.long(), j0.long(), k0.long()
    nm1, tm1 = N_r.long() - 1, T_r.long() - 1
    rec = torch.empty((T_pad, NM, R, NREC), dtype=dtype, device=dev)
    for t in range(T_pad - 1, -1, -1):
        act_now = (t == tm1) & valid
        active = active | act_now
        state = torch.where(act_now, E_ST, state)
        i = torch.where(act_now, i0, i)
        j = torch.where(act_now, j0, j)
        k = torch.where(act_now, k0, k)
        n = torch.where(act_now, nm1, n)
        seg = torch.where(act_now, 0, seg)
        did_t = torch.zeros_like(active)
        t_pos = t >= 1
        for m in range(NM):
            ch = choices[t, r, i, j].long()
            lp_state = lp[t, r, state, i, j]
            slv = slots[t, r, i, j].long()
            is_I = active & (state == I_ST) & t_pos
            i_break = is_I & (n == 1)
            i_go = is_I & ~i_break
            tstep = active & (state != I_ST) & ~did_t & t_pos
            is_A, is_P = state == A_ST, state == P_ST
            is_S, is_E = state == S_ST, state == E_ST
            brk = tstep & (t == 1) & (is_E | is_P | ((is_A | is_S) & (n == 1)))
            go = tstep & ~brk
            emit_break = brk & (is_E | is_A | is_P)   # an S break emits nothing
            emit = emit_break | (go & (is_A | is_P))
            moved = i_go | go
            rec[t, m] = torch.stack([
                torch.where(moved, torch.exp(lp_state), 0.0),
                torch.where(moved, seg, S_max).to(dtype),
                emit.to(dtype),
                is_P.to(dtype),
                torch.where(emit_break, half, n - 1 + half).to(dtype),
                torch.where(emit_break, 0, t - 1).to(dtype),
                k.to(dtype),
                torch.where(emit, seg, S_max).to(dtype),
            ], dim=1)

            chE, chA, chP = ch & 3, (ch >> 2) & 7, (ch >> 5) & 15
            chS, chI = (ch >> 9) & 3, (ch >> 11) & 1
            ai = torch.where(is_A, chA >> 1, chP // 3)
            cs = (slv & SLM) - 1
            cpa = torch.where(is_A, (slv >> SLB) & SLM, (slv >> (2 * SLB)) & SLM) - 1
            stE = torch.where(chE == 0, E_ST, torch.where(
                chE == 1, A_ST, torch.where(chE == 2, S_ST, P_ST)))
            stA = torch.where((chA & 1) == 0, E_ST, I_ST)
            m3 = chP - ai * 3
            stP = torch.where(m3 == 0, E_ST, torch.where(m3 == 1, S_ST, I_ST))
            stS = torch.where(chS == 0, E_ST, torch.where(chS == 1, P_ST, I_ST))
            stI = torch.where(chI == 0, E_ST, I_ST)
            st_go = torch.where(is_E, stE, torch.where(
                is_A, stA, torch.where(is_P, stP, stS)))
            i_go_slot = torch.where(is_E | is_P, row_same[t, r, i],
                                    row_prev[t, r, i]).long()
            j_go_slot = torch.where(is_E | is_S, cs, cpa)
            k_go = torch.where(is_A | is_P, k // A + ai * Kdiv, k)
            n_go = torch.where(is_A | is_S, n - 1, n)

            state = torch.where(i_go, stI, torch.where(go, st_go, state))
            i = torch.where(i_go, i - 1, torch.where(go, i_go_slot, i)).clamp(0, CN - 1)
            j = torch.where(go, j_go_slot, j).clamp(0, CK - 1)
            k = torch.where(go, k_go, k)
            n = torch.where(i_go, n - 1, torch.where(go, n_go, n))
            seg = seg + emit.long()
            active = active & ~(i_break | brk)
            did_t = did_t | go | brk
        stuck = stuck | (active & ~did_t & t_pos)
    fin = torch.stack([seg, stuck.long()], dim=1).to(torch.int32)
    return rec, fin


def finish_records(rec, fin, S_max: int):
    """Per-read segment summaries from the walk's records.

    Emission records (one per segment, tagged e_seg; S_max = none) carry
    state, basepos, start and polish k-mer; probability records (tagged
    p_seg) are grouped and reduced to each segment's median by a 2-key sort
    (two stable sorts, value then segment). Returns (seg_cnt (R,), state,
    basepos, start, polish k (R, S_max) int32, median (R, S_max), overflow
    (R,) bool)."""
    T_pad, NM, R, _ = rec.shape
    M = T_pad * NM
    f = rec.permute(2, 0, 1, 3).reshape(R, M, NREC)
    probs = f[..., 0]
    p_seg, e_state, e_bp, e_start, e_k, e_seg = (
        f[..., c].long() for c in (1, 3, 4, 5, 6, 7))
    dev = rec.device

    def scatter(vals, idx):
        out = torch.zeros((R, S_max + 1), dtype=torch.int64, device=dev)
        out.scatter_(1, idx.clamp(max=S_max), vals)
        return out[:, :S_max].to(torch.int32)

    st_a, bp_a, start_a, k_a = (scatter(v, e_seg)
                                for v in (e_state, e_bp, e_start, e_k))
    pv = torch.where(p_seg < S_max, probs, math.inf)
    o1 = torch.sort(pv, dim=1, stable=True).indices
    o2 = torch.sort(torch.gather(p_seg, 1, o1), dim=1, stable=True).indices
    sp = torch.gather(torch.gather(pv, 1, o1), 1, o2)
    counts = torch.zeros((R, S_max + 1), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, p_seg.clamp(max=S_max), torch.ones_like(p_seg))
    counts = counts[:, :S_max]
    offsets = torch.cumsum(counts, dim=1) - counts
    lo = (offsets + (counts - 1) // 2).clamp(0, M - 1)
    hi = (offsets + counts // 2).clamp(0, M - 1)
    med = 0.5 * (torch.gather(sp, 1, lo) + torch.gather(sp, 1, hi))
    med = torch.where(counts > 0, med, 0.0)
    seg_cnt = fin[:, 0]
    return (seg_cnt, st_a, bp_a, start_a, k_a, med,
            (seg_cnt > S_max) | (fin[:, 1] > 0))

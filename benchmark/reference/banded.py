"""Plain reference of `dynamont-resquiggle --mode basic` for the benchmark's
check: a frozen, self-contained copy of the port's plain banded path
(`dynamont_tpu_torch/ops/nt_banded_batch.py`: `_backward`, `fwd_vit`,
`walk`, `path_summaries` and their row helpers; `ops/geometry.py`;
`ops/nt_banded_device.quantize_signal` and `decode`;
`ops/nt_banded_device.summaries_to_segments`; `io/output.format_segments_csv`),
computed in any dtype and importing nothing of the port.

It works out again everything the port derives from the reads: the wire's
int16 quantisation and affine, the k-mer ids, each read's band geometry
(band starts by the reference's float64 midpoint truncation), the emission
parameters from the table file, then the backward, the forward with the
posteriors and the Viterbi choices, the MAP walk and the grouped medians,
and the output rows. Reads run as one padded batch on any torch device,
band columns (R, B) a row; every row loop is plain torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.table import PoreTable

NEG_INF = float("-inf")
T_PAD_TO = 512
# rna002 (ref: dynamont NT_banded_main.cpp transition defaults)
TRANSITIONS = {"rna002": {"m1": 0.019889650396799997, "e2": 0.9801103496029998}}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def quantize(sig: np.ndarray) -> tuple[np.ndarray, float]:
    """The signal as the wire carries it: int16 steps of a float32 scale
    max|sig| / 32000, decoded in float64."""
    m = float(np.max(np.abs(sig))) if len(sig) else 1.0
    a = float(np.float32(max(m, 1e-12) / 32000.0))
    dac = np.clip(np.rint(sig / a), -32768, 32767).astype(np.int16)
    return dac, a


def band_starts(T: int, N: int, bw: int) -> np.ndarray:
    """bstart[t] = floor(t * N / T) - bw through a float64 product, as the
    reference truncates `t * NTRATIO`."""
    t = np.arange(T, dtype=np.float64)
    return (t * (np.float64(N) / np.float64(T))).astype(np.int64) - bw


class Batch:
    """One padded batch of reads: R reads, T_pad rows, B band columns."""

    def __init__(self, signals, kmer_lists, table: PoreTable, band: int,
                 device, dtype, quantized: bool):
        R = len(signals)
        self.T = np.array([len(s) + 1 for s in signals], np.int64)
        self.N = np.array([len(k) + 1 for k in kmer_lists], np.int64)
        self.bw = np.array([min(band // 2, int(n) // 2) for n in self.N], np.int64)
        max_bw = int(self.bw.max())
        self.B = round_up(2 * max_bw + 3, 128)
        self.pad = max_bw + 3
        q = max(T_PAD_TO, 1 << max(0, int(self.T.max()).bit_length() - 4))
        self.T_pad = round_up(int(self.T.max()), q)
        N_pad = int(self.N.max()) - 1 + 2 * self.pad + self.B
        means, c1, c2 = table.score_params()
        sig = np.zeros((R, self.T_pad - 1))
        mu = np.zeros((R, N_pad))
        cc1 = np.zeros((R, N_pad))
        cc2 = np.zeros((R, N_pad))
        bstart = np.zeros((R, self.T_pad), np.int64)
        for i, (s, kid) in enumerate(zip(signals, kmer_lists)):
            T, N, bw = int(self.T[i]), int(self.N[i]), int(self.bw[i])
            if quantized:
                dac, a = quantize(s)
                sig[i, : T - 1] = dac.astype(np.float64) * a
            else:
                sig[i, : T - 1] = s
            p = self.pad
            mu[i, p:p + N - 1] = means[kid]
            cc1[i, p:p + N - 1] = c1[kid]
            cc2[i, p:p + N - 1] = c2[kid]
            bs = band_starts(T, N, bw)
            bstart[i, :T] = bs
            bstart[i, T:] = bs[T - 1]
        put = lambda a: torch.as_tensor(a, device=device)
        self.sig = put(sig).to(dtype)
        self.mu, self.c1, self.c2 = (put(x).to(dtype) for x in (mu, cc1, cc2))
        self.bstart = put(bstart)
        self.Tt, self.Nt, self.bwt = put(self.T), put(self.N), put(self.bw)
        self.dtype, self.device = dtype, torch.device(device)


def _shift_left(row):
    return F.pad(row[:, 1:], (0, 1), value=NEG_INF)


def _shift_right(row):
    return F.pad(row[:, :-1], (1, 0), value=NEG_INF)


def _scores(b: Batch, t0: int, t1: int, offset: int):
    """(mean, c1, c2), each (R, t1 - t0, B): the parameters of the k-mer
    at position bstart[t] + j + offset for rows t0..t1-1."""
    j = torch.arange(b.B, device=b.device)
    idx = b.bstart[:, t0:t1, None] + j + (offset + b.pad)
    flat = idx.reshape(idx.shape[0], -1)
    take = lambda a: a.gather(1, flat).reshape(idx.shape)
    return take(b.mu), take(b.c1), take(b.c2)


def _score_rows(b: Batch, rows: slice, offset: int, block: int = 2048):
    """(R, T_pad - 1, B) emission scores of the signal against the k-mers
    of `rows` (the backward's rows 0..T_pad-2 or the forward's 1..T_pad-1):
    c1 - c2 (x - mean)^2, rounded as the port writes it; `block` rows at a
    time, so that the gathered parameters never fill the device."""
    t0 = rows.start or 0
    t1 = rows.stop if rows.stop is not None else b.T_pad
    out = torch.empty((b.sig.shape[0], t1 - t0, b.B), dtype=b.dtype,
                      device=b.device)
    for a in range(t0, t1, block):
        z = min(a + block, t1)
        mu, c1, c2 = _scores(b, a, z, offset)
        d = b.sig[:, a - t0:z - t0, None] - mu
        out[:, a - t0:z - t0] = c1 - c2 * d * d
    return out


def _valid(b: Batch, rows: slice, lower_from_one: bool):
    j = torch.arange(b.B, device=b.device)
    bs = b.bstart[:, rows][:, :, None]
    ns = bs.clamp(min=1 if lower_from_one else 0)
    ne = torch.minimum(bs + 2 * b.bwt[:, None, None] + 1, b.Nt[:, None, None])
    return (j >= ns - bs + 1) & (j < ne - bs + 1)


def _start_row(b: Batch):
    j = torch.arange(b.B, device=b.device)
    hit = j[None, :] == (b.bwt[:, None] + 1)
    return torch.where(hit, torch.zeros((), dtype=b.dtype, device=b.device),
                       NEG_INF)


def _row_shifts(b: Batch):
    return b.bstart[:, 1:] != b.bstart[:, :-1]


def backward(b: Batch, log_m1: float, log_e2: float):
    """(bM, bE), each (R, T_pad, B) (ref: NT_banded.cpp:64-123): the
    terminal row is each read's t = T - 1, rows past it are -inf."""
    R, T_pad, B = b.sig.shape[0], b.T_pad, b.B
    rows = slice(0, T_pad - 1)
    sc_b = _score_rows(b, rows, -2)
    sc_a = _score_rows(b, rows, -1)
    valid = _valid(b, rows, False)
    j = torch.arange(B, device=b.device)
    n = b.bstart[:, :-1, None] + j - 1
    has_next = n + 1 < b.Nt[:, None, None]
    has_prev = n > 0
    sb = _row_shifts(b)
    T = b.Tt[:, None]
    term_row = _start_row(b)
    M = torch.empty((R, T_pad, B), dtype=b.dtype, device=b.device)
    E = torch.empty_like(M)
    M[:, T_pad - 1] = NEG_INF
    E[:, T_pad - 1] = torch.where(T == T_pad, term_row, NEG_INF)
    M_next, E_next = M[:, T_pad - 1], E[:, T_pad - 1]
    for t in range(T_pad - 2, -1, -1):
        s = sb[:, t:t + 1]
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
    return M, E


def _forward_row(M_prev, E_prev, s1, sc_b, valid, log_m1, log_e2):
    E_m = torch.where(s1, E_prev, _shift_right(E_prev))
    M_e = torch.where(s1, _shift_left(M_prev), M_prev)
    E_e = torch.where(s1, _shift_left(E_prev), E_prev)
    M_new = torch.where(valid, E_m + sc_b + log_m1, NEG_INF)
    E_new = torch.where(valid, torch.logaddexp(M_e + sc_b, E_e + sc_b + log_e2),
                        NEG_INF)
    return M_new, E_new


def _viterbi_row(vM, vE, s1, lpm, lpe, valid):
    E_m = torch.where(s1, vE, _shift_right(vE))
    M_e = torch.where(s1, _shift_left(vM), vM)
    E_e = torch.where(s1, _shift_left(vE), vE)
    M_new = torch.where(valid, E_m + lpm, NEG_INF)
    E_new = torch.where(valid, torch.maximum(M_e, E_e) + lpe, NEG_INF)
    return M_new, E_new, E_new == (M_e + lpe)


def fwd_vit(b: Batch, bM, bE, Zb, log_m1: float, log_e2: float):
    """Forward rows with the log posteriors fwd + bwd - Zb and the Viterbi
    recurrence over them (ref: NT_banded.cpp:23-62, 139-189); returns
    (ch, LPM, LPE, Zf)."""
    R, T_pad, B = bM.shape
    sc_b = _score_rows(b, slice(1, None), -2)
    valid = _valid(b, slice(1, None), True)
    s1 = _row_shifts(b)
    T = b.Tt[:, None]
    zb = Zb[:, None]
    zcol = (b.bwt + 1)[:, None]
    ch = torch.zeros((R, T_pad, B), dtype=torch.uint8, device=b.device)
    LPM = torch.empty_like(bM)
    LPE = torch.empty_like(bM)
    M = torch.full((R, B), NEG_INF, dtype=b.dtype, device=b.device)
    E = _start_row(b)
    vM, vE = M, E
    LPM[:, 0] = M + bM[:, 0] - zb
    LPE[:, 0] = E + bE[:, 0] - zb
    Zf = torch.full((R, 1), NEG_INF, dtype=b.dtype, device=b.device)
    for t in range(1, T_pad):
        s = s1[:, t - 1:t]
        v = valid[:, t - 1]
        M, E = _forward_row(M, E, s, sc_b[:, t - 1], v, log_m1, log_e2)
        Zf = torch.where(t == T - 1, E.gather(1, zcol), Zf)
        lpm = M + bM[:, t] - zb
        lpe = E + bE[:, t] - zb
        LPM[:, t], LPE[:, t] = lpm, lpe
        vM, vE, c = _viterbi_row(vM, vE, s, lpm, lpe, v)
        ch[:, t] = c
    dead = (torch.arange(T_pad, device=b.device) >= T)[:, :, None]
    LPM.masked_fill_(dead, NEG_INF)
    LPE.masked_fill_(dead, NEG_INF)
    ch.masked_fill_(dead, 0)
    return ch, LPM, LPE, Zf[:, 0]


def walk(LPM, LPE, ch, b: Batch, N_max: int):
    """The reverse MAP traceback (ref: NT_banded.cpp:204-250): (path_n,
    prob, close), each (R, T_pad - 1) at index t - 1 for row t."""
    R, T_pad, B = LPM.shape
    dev = LPM.device
    r = torch.arange(R, device=dev)
    s_all = _row_shifts(b).long()
    T = b.Tt
    n = b.Nt - 1
    j = b.bwt + 1
    is_m = torch.zeros(R, dtype=torch.bool, device=dev)
    path_n = torch.full((R, T_pad - 1), N_max, dtype=torch.int64, device=dev)
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
        path_n[:, t - 1] = torch.where(active, n, N_max)
        prob[:, t - 1] = torch.where(active, p, zero)
        close[:, t - 1] = cl
        s = s_all[:, t - 1]
        n = torch.where(cl, n - 1, n)
        j = torch.where(cl, j - 1 + s, torch.where(active, j + s, j))
        is_m = torch.where(cl, False, torch.where(active, c, is_m))
    return path_n, prob, close


def path_summaries(path_n, prob, close, N_max: int):
    """Per-base segment starts and median posteriors (ref: utils.cpp:443-467
    calculateMedian): the mean of the two middle probabilities of the rows
    the walk spent on each base."""
    R, L = path_n.shape
    dev = path_n.device
    keys = path_n
    starts = torch.full((R, N_max + 1), -1, dtype=torch.int64, device=dev)
    idx = torch.where(close, keys, N_max)
    starts.scatter_(1, idx, torch.arange(L, device=dev).expand(R, L))
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


def segment(reads, table: PoreTable, pore: str, *, band: int = 400,
            device="cpu", dtype=torch.float64, quantized: bool = True):
    """[(Zf, Zb, rows)] of each (signal, read) pair: rows as
    `rows_of_segments` gives them. One padded batch; every (R, T_pad, B)
    matrix lives on `device` in `dtype` at once."""
    tr = TRANSITIONS[pore]
    log_m1, log_e2 = math.log(tr["m1"]), math.log(tr["e2"])
    kmer_lists = [table.kmer_ids(read) for _, read in reads]
    b = Batch([s for s, _ in reads], kmer_lists, table, band, device, dtype,
              quantized)
    N_max = round_up(int(b.N.max()), 128)
    with torch.no_grad():
        bM, bE = backward(b, log_m1, log_e2)
        r = torch.arange(len(reads), device=b.device)
        Zb = bE[r, 0, b.bwt + 1]
        ch, LPM, LPE, Zf = fwd_vit(b, bM, bE, Zb, log_m1, log_e2)
        del bM, bE
        starts, med = path_summaries(*walk(LPM, LPE, ch, b, N_max), N_max)
        del LPM, LPE, ch
    starts = starts.cpu().numpy()
    med = med.to(torch.float32).cpu().numpy()
    out = []
    for i, (sig, read) in enumerate(reads):
        N = int(b.N[i])
        half = table.kmer_size // 2
        idx = np.nonzero(starts[i, 1:N] >= 0)[0] + 1
        segs = [("M", int(n - 1 + half), int(starts[i, n]), float(med[i, n]))
                for n in idx]
        out.append((float(Zf[i]), float(Zb[i]),
                    rows_of_segments(segs, len(sig), read, table)))
    return out


def rows_of_segments(segs, last: int, read: str, table: PoreTable) -> list:
    """Output rows (start, end, basepos, base, motif, state, prob, polish)
    of segments (state, basepos, start, prob[, polish]) in read order, as
    dynamont's formatSegmentation lays them out (ref: FileIO.py:402-460):
    ends are the next segment's start, RNA positions and motifs counted
    from the 5' end."""
    half = table.kmer_size // 2
    L = len(read)
    rows = []
    for i, seg in enumerate(segs):
        state, bp, start, prob = seg[:4]
        polish = seg[4] if len(seg) > 4 else "NA"
        end = segs[i + 1][2] if i + 1 < len(segs) else last
        motif = read[max(0, bp - half): bp + half + 1]
        base = read[bp]
        if table.rna:
            motif, bp = motif[::-1], L - bp - 1
        rows.append((start, end, bp, base, motif, state, prob, polish))
    return rows

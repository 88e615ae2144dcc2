"""Plain reference of `dynamont-resquiggle --mode resquiggle` for the
benchmark's check: upstream dynamont's NTC model (src/cpp/NTC.cpp,
NTC_main.cpp) as the port states it, one read at a time in NumPy float64,
the reads spread over worker processes on the host's cores. It imports
nothing of the port and nothing of JAX.

For each read it works out again:
- the TN pre-pass: the dense T x N two-state forward and backward over the
  read's k-mers (ppTN transitions, the pore's NT m1/e2), and per column the
  n-candidates holding 95 % of the posterior mass (a column's cells in
  descending order, ties to the lower index, kept up to and including the
  one whose running mass passes 0.95 of the column's, '>' for TN);
- the TK pre-pass: the dense T x K two-state pass over every k-mer, M
  summing the A predecessor k-mers, and the k-candidates likewise ('>=');
- the cap ladder: the engine's main rung (8, 120) where every column's
  candidates fit it, else its wide rung (16, 240), else the exact per-read
  rung, which takes the first rung of (8, 16) .. (64, 128) that fits and
  cuts the candidates to (64, 128) where none does;
- the sparse lattice: per column the n-candidates by the union of the
  k-candidates and each n-candidate's own k-mer kmer_seq[n-1]; a cell is
  allowed where its k is a k-candidate or n's own k-mer;
- the 5-state A/P/S/E/I forward and backward over the allowed cells, the
  emission score log N(x; n's k-mer) + log N(x; k) - 2 Hamming(n's k-mer,
  k), and the in-column I chains;
- the posteriors fwd + bwd - Zb, the 5-state Viterbi over them, the start
  cell (the last k ascending attaining the best E at (T-1, N-1)), the walk
  by the reference's equality checks in its order, each segment's median
  posterior rescaled by exp(Zb - Zf), and its polish k-mer;
- the output rows, as dynamont's formatSegmentation lays them out.

Departures from upstream, each as the port has it:
- the lattice skips the n = 0 baseline that would read kmer_seq[-1];
- the backward's in-column I chain adds the I value of slot n + 1 before
  that cell is masked, so a cell (n, k) whose neighbour (n + 1, k) is not
  allowed still takes it (the forward masks it); Zb may then exceed Zf a
  little, and the medians are rescaled by exp(Zb - Zf);
- a column's 95 % crossing is tested against that column's own mass, not
  against the global Z (equal by the forward-backward identity);
- the main and wide rungs read the signal rounded to float32, as the
  engine's buckets carry it, and the exact rung the float64 signal; a read
  goes to the exact rung also where the engine's walk would stall (more
  than two in-column I steps at one t) or finds no start cell;
- no Z gate is applied, and the engine's segment cap is not modelled.

Sums of terms are folded by np.logaddexp in another order than the port's
kernels take them, so values agree to rounding, not bit for bit.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

NEG_INF = -np.inf
CROSS = math.exp(math.log(0.95))  # ref: NTC.hpp:29 SPARSETHRESHOLD
A_, P_, S_, E_, I_ = range(5)    # ref: NTC.cpp:699-703
MAIN_CAPS, WIDE_CAPS = (8, 120), (16, 240)
CAP_LADDER = ((8, 16), (16, 32), (32, 64), (64, 128))
TOP_N, TOP_K = 64, 256   # candidates ranked a column: the widest caps + 1
WALK_I_STEPS = 2         # in-column I steps the engine's walk takes at one t
CHUNK = 256              # rows between the pre-passes' checkpoints
# rna002 (ref: utils.cpp:10-84 and the NT tables NTC_main.cpp:55-87 reads)
TRANSITIONS = {"rna002": {
    "pre": {"m1": 0.019889650396799997, "e2": 0.9801103496029998},
    "ntc": {"a1": 0.019326040280789637, "a2": 0.19725479693713352,
            "p1": 0.1979799841413514, "p2": 0.0006135538271005425,
            "p3": 0.7669801909288386, "s1": 0.27034500789657623,
            "s2": 0.00032463686748883153, "s3": 0.02916688206070035,
            "e2": 0.7296549921055607, "e3": 0.8020200158564497,
            "e4": 0.9797333838008437, "i1": 2.3852272324574183e-06,
            "i2": 0.006598130068516047},
}}

la = np.logaddexp


def _w(mask, v):
    return np.where(mask, v, NEG_INF)


# --- the pre-passes ----------------------------------------------------------
#
# Both run in linear space, each row's values divided by the row's largest
# and values under TINY of it set to 0: a column's posterior mass is only
# ever compared within the column, so no row needs its scale.

TINY = 1e-250
FIRST = 16   # candidates ranked a column before a full sort is needed


def _norm(a, b):
    """a and b (fresh arrays) divided by their largest value, in place."""
    s = max(a.max(), b.max())
    for v in (a, b):
        v /= s
        v[v < TINY] = 0.0
    return a, b


def _count(Pm, order, tot, ge: bool):
    """How many of the masses Pm ranked by `order` (rows, W) it takes to pass
    `tot` (rows, 1), the one that passes it included; W + 1 where none
    does."""
    run = np.cumsum(np.take_along_axis(Pm, order, axis=1), axis=1)
    crossed = run >= tot if ge else run > tot
    return np.where(crossed.any(1), crossed.argmax(1) + 1, order.shape[1] + 1)


def _crossing(Pm, top: int, ge: bool):
    """Per row of the posterior masses Pm (rows, W): (order (rows, top) of
    the highest masses, descending, ties to the lower index, -1 past what
    was ranked; count (rows,) of them up to and including the one whose
    running mass passes 0.95 of the row's, or top + 1 where none does).
    The FIRST highest are ranked in every row, all of them only in the rows
    whose crossing lies beyond."""
    rows, W = Pm.shape
    tot = CROSS * Pm.sum(axis=1, keepdims=True)
    k = min(FIRST, W)
    part = np.argpartition(-Pm, k - 1, axis=1)[:, :k]
    vals = np.take_along_axis(Pm, part, axis=1)
    order = np.full((rows, top), -1, np.int64)
    order[:, :k] = np.take_along_axis(part, np.lexsort((part, -vals), axis=1), axis=1)
    count = _count(Pm, order[:, :k], tot, ge)
    late = np.flatnonzero(count > k)
    if len(late):
        full = np.argsort(-Pm[late], axis=1, kind="stable")[:, :top]
        order[late, :full.shape[1]] = full
        count[late] = np.minimum(_count(Pm[late], full, tot[late], ge), top + 1)
    return order, count


def _chunks(T: int):
    return [(c, min(c + CHUNK, T)) for c in range(0, T, CHUNK)]


def tn_pass(x, kid, mu, sd, m1: float, e2: float):
    """The TN pre-pass over samples x (T-1,) and k-mer ids kid (N-1,):
    (order (T, TOP_N), count (T,)) of each column's n-candidates (ref:
    NTC.cpp:80-132, 229-280). The forward is kept at every CHUNK-th row and
    re-derived a chunk at a time."""
    T, N = len(x) + 1, len(kid) + 1
    mu_n, inv, lsd = mu[kid], 1.0 / sd[kid], 2.0 * np.log(sd[kid])
    LOG_2PI = 1.8378770664093453

    def emis(t0, t1):
        """(t1 - t0, N - 1) exp(log N(x[t]; k-mer n) - the row's max)."""
        d = (x[t0:t1, None] - mu_n) * inv
        sc = -0.5 * (LOG_2PI + lsd + d * d)
        return np.exp(sc - sc.max(axis=1, keepdims=True))

    def fwd_rows(M, E, t0, t1):
        """Forward rows t0 .. t1 - 1 from row t0 (M, E)."""
        out = [(M, E)]
        es_all = emis(t0, t1 - 1)
        for es in es_all:
            M2, E2 = np.zeros(N), np.zeros(N)
            M2[1:] = E[:-1] * es * m1
            E2[1:] = (M[1:] + E[1:] * e2) * es
            M, E = _norm(M2, E2)
            out.append((M, E))
        return out

    chunks = _chunks(T)
    ckpt = []
    M, E = np.zeros(N), np.zeros(N)
    E[0] = 1.0
    for t0, t1 in chunks:
        ckpt.append((M, E))
        M, E = fwd_rows(M, E, t0, t1 + (t1 < T))[-1]
    order = np.zeros((T, TOP_N), np.int64)
    count = np.zeros(T, np.int64)
    bM, bE = np.zeros(N), np.zeros(N)
    bE[N - 1] = 1.0
    for (t0, t1), (fM0, fE0) in zip(chunks[::-1], ckpt[::-1]):
        fwd = fwd_rows(fM0, fE0, t0, t1)
        es_all = emis(t0, min(t1, T - 1))
        Pm = np.empty((t1 - t0, N))
        for t in range(t1 - 1, t0 - 1, -1):
            if t < T - 1:
                es = es_all[t - t0]
                ext, nM = np.zeros(N), np.zeros(N)
                ext[:-1] = bM[1:] * es * m1
                nM[1:] = bE[1:] * es
                ext[1:] += bE[1:] * es * e2
                bM, bE = _norm(nM, ext)
            fM, fE = fwd[t - t0]
            Pm[t - t0] = fM * bM + fE * bE
        order[t0:t1], count[t0:t1] = _crossing(Pm, TOP_N, ge=False)
    return order, count


def tk_pass(x, mu, c1, c2, A: int, m1: float, e2: float):
    """The TK pre-pass over samples x (T-1,) and every k-mer: (order (T,
    TOP_K), count (T,)) of each column's k-candidates (ref: NTC.cpp:145-217,
    291-349). The backward is kept at every CHUNK-th row and re-derived a
    chunk at a time."""
    T, K = len(x) + 1, len(mu)

    def emis(t0, t1):
        d = x[t0:t1, None] - mu
        sc = c1 - c2 * d * d
        return np.exp(sc - sc.max(axis=1, keepdims=True))

    def bwd_rows(M, E, t_hi, t_lo):
        """Backward rows t_hi - 1 down to t_lo from row t_hi (M, E)."""
        out = {}
        es_all = emis(t_lo, t_hi)
        for t in range(t_hi - 1, t_lo - 1, -1):
            es = es_all[t - t_lo]
            ext = (M * es).reshape(K // A, A).sum(axis=1) * m1
            M, E = _norm(E * es, np.tile(ext, A) + E * es * e2)
            out[t] = (M, E)
        return out

    chunks = _chunks(T)
    ckpt = [None] * len(chunks)
    M, E = np.zeros(K), np.ones(K)
    for c in range(len(chunks) - 1, -1, -1):
        t0, t1 = chunks[c]
        ckpt[c] = (M, E)
        if t0 < T - 1:
            M, E = bwd_rows(M, E, min(t1, T - 1), t0)[t0]
    order = np.zeros((T, TOP_K), np.int64)
    count = np.zeros(T, np.int64)
    fM, fE = np.zeros(K), np.ones(K)
    for c, (t0, t1) in enumerate(chunks):
        rows = bwd_rows(*ckpt[c], min(t1, T - 1), t0) if t0 < T - 1 else {}
        rows[T - 1] = (np.zeros(K), np.ones(K))
        lo = max(t0 - 1, 0)
        es_all = emis(lo, t1 - 1)
        Pm = np.empty((t1 - t0, K))
        for t in range(t0, t1):
            if t > 0:
                es = es_all[t - 1 - lo]
                pre = np.repeat(fE.reshape(A, K // A).sum(axis=0), A)
                fM, fE = _norm(pre * es * m1, (fM + fE * e2) * es)
            bM, bE = rows[t]
            Pm[t - t0] = fM * bM + fE * bE
        order[t0:t1], count[t0:t1] = _crossing(Pm, TOP_K, ge=True)
    return order, count


def pick_rung(count_n, count_k, exact: bool):
    """(cap_n, cap_k, cut) of the rung the engine runs a read at: the main
    and wide rungs where the candidates fit (cut False), else the exact
    rung's ladder; cut where even its last rung is too small."""
    cn, ck = int(count_n.max()), int(count_k.max())
    rungs = CAP_LADDER if exact else (MAIN_CAPS, WIDE_CAPS)
    for cap_n, cap_k in rungs:
        if cn <= cap_n and ck <= cap_k:
            return cap_n, cap_k, False
    if not exact:
        return None
    return CAP_LADDER[-1] + (True,)


# --- the sparse lattice ------------------------------------------------------

class Lattice:
    """The allowed cells of one read, ragged by column t: n-slots ns (sorted
    n-candidates), k-slots ks (sorted union of the k-candidates and the
    n-slots' own k-mers), a column's cells its (n-slot, k-slot) grid in
    row-major order; the slot maps to the neighbouring columns (-1 where
    absent) and every cell's emission scores."""

    def __init__(self, x, kid, table, cand_n, cand_k, trans: dict):
        T, N = len(x) + 1, len(kid) + 1
        K, A, S = len(table.means), table.alphabet_size, table.kmer_size
        self.T, self.N, self.K, self.A = T, N, K, A
        mu, (_, c1, c2) = table.means, table.score_params()
        step = K // A
        t_of = lambda lens: np.repeat(np.arange(T), lens)
        # n-slots
        self.ns = np.concatenate(cand_n)
        self.n_off = np.concatenate([[0], np.cumsum([len(c) for c in cand_n])])
        nt = t_of(np.diff(self.n_off))
        kN = np.where(self.ns >= 1, kid[np.clip(self.ns - 1, 0, N - 2)], 0)
        kN2 = np.where(self.ns < N - 1, kid[np.clip(self.ns, 0, N - 2)], 0)
        # k-slots: the k-candidates and each n-slot's own k-mer
        tk_t = t_of([len(c) for c in cand_k])
        tk_keys = tk_t * (K + 1) + np.concatenate(cand_k)
        own = self.ns >= 1
        keys = np.unique(np.concatenate([tk_keys, nt[own] * (K + 1) + kN[own]]))
        kt, self.ks = keys // (K + 1), keys % (K + 1)
        self.k_off = np.searchsorted(kt, np.arange(T + 1))
        from_tk = np.isin(keys, tk_keys)
        # slot maps, as local slots in the neighbouring column
        nkey = nt * (N + 1) + self.ns

        def find(table_keys, off, want, t_near):
            pos = np.searchsorted(table_keys, want)
            hit = (pos < len(table_keys)) & (
                table_keys[np.minimum(pos, len(table_keys) - 1)] == want)
            return np.where(hit, pos - off[np.clip(t_near, 0, T)], -1)

        def nmap(dt, dn):
            tn = nt + dt
            return find(nkey, self.n_off, tn * (N + 1) + self.ns + dn, tn)

        self.rs, self.rp = nmap(-1, 0), nmap(-1, -1)
        self.bs, self.bn = nmap(1, 0), nmap(1, 1)
        a = np.arange(A)
        prec = self.ks[:, None] // A + a * step
        suc = (self.ks[:, None] % step) * A + a

        def kmap(dt, vals):
            tk = (kt + dt).reshape(-1, *[1] * (vals.ndim - 1))
            return find(keys, self.k_off, tk * (K + 1) + vals,
                        np.broadcast_to(tk, vals.shape))

        self.cs, self.cp = kmap(-1, self.ks), kmap(-1, prec)
        self.bcs, self.cu = kmap(1, self.ks), kmap(1, suc)
        # cells: every (n-slot, k-slot) pair of a column
        cn, ck = np.diff(self.n_off), np.diff(self.k_off)
        self.c_off = np.concatenate([[0], np.cumsum(cn * ck)])
        ct = t_of(cn * ck)
        loc = np.arange(self.c_off[-1]) - self.c_off[ct]
        gi = self.n_off[ct] + loc // ck[ct]
        gj = self.k_off[ct] + loc % ck[ct]
        n, k = self.ns[gi], self.ks[gj]
        self.allowed = from_tk[gj] | ((n >= 1) & (k == kN[gi]))
        self.n_pos, self.n_lt = n >= 1, n < N - 1
        self.cn, self.ck = cn, ck

        def hd(u, v):
            d = np.zeros(np.broadcast_shapes(u.shape, v.shape), np.int64)
            for _ in range(S):
                d += (u % A) != (v % A)
                u, v = u // A, v // A
            return -2.0 * d

        sc = lambda xx, kk: c1[kk] - c2[kk] * (xx - mu[kk]) * (xx - mu[kk])
        # forward row t reads x[t-1]; backward row t reads x[t] (its I
        # chain x[t-1]); rows outside the signal read 0, as the port pads
        xpad = np.concatenate([[0.0], x, [0.0]])
        xf, xb = xpad[ct], xpad[ct + 1]
        kn1, kn2 = kN[gi], kN2[gi]
        s_n1b, s_n2b, s_kb = sc(xb, kn1), sc(xb, kn2), sc(xb, k)
        self.sc_f = sc(xf, kn1) + sc(xf, k) + hd(kn1, k)
        self.sc1 = s_n1b + s_kb + hd(kn1, k)
        self.sc2 = s_n2b + s_kb + hd(kn2, k)
        self.sc_i = sc(xf, kn2) + sc(xf, k) + hd(kn2, k)
        sk = suc[gj]  # (cells, A) successor k-mers of the cell's k
        s_sk = sc(xb[:, None], sk)
        self.sc1s = s_n1b[:, None] + s_sk + hd(kn1[:, None], sk)
        self.sc2s = s_n2b[:, None] + s_sk + hd(kn2[:, None], sk)
        self.trans = {kk: math.log(v) for kk, v in trans.items()}

    def col(self, t):
        """(n-slice, k-slice, cell slice, cn, ck) of column t."""
        return (slice(self.n_off[t], self.n_off[t + 1]),
                slice(self.k_off[t], self.k_off[t + 1]),
                slice(self.c_off[t], self.c_off[t + 1]),
                int(self.cn[t]), int(self.ck[t]))

    def grid(self, a, t):
        _, _, c, cn, ck = self.col(t)
        return a[c].reshape(cn, ck, *a.shape[1:])


def _padded(v):
    """(5, cn, ck) -> (5, cn + 1, ck + 1) with -inf in the last row and
    column, so that slot -1 reads -inf."""
    out = np.full((5, v.shape[1] + 1, v.shape[2] + 1), NEG_INF)
    out[:, :-1, :-1] = v
    return out


def _init_column(L: Lattice, t: int, n_value: int):
    ns, _, _, cn, ck = L.col(t)
    v = np.full((5, cn, ck), NEG_INF)
    row = (L.ns[ns] == n_value)[:, None] & L.grid(L.allowed, t)
    v[E_] = np.where(row, 0.0, NEG_INF)
    return v


def backward(L: Lattice):
    """The backward columns, each (5, cn + 1, ck + 1) padded (ref:
    NTC.cpp:495-578)."""
    tl, T = L.trans, L.T
    out = [None] * T
    out[T - 1] = _padded(_init_column(L, T - 1, L.N - 1))
    for t in range(T - 2, -1, -1):
        nsl, ksl, _, cn, ck = L.col(t)
        nxt = out[t + 1]
        bs, bn = L.bs[nsl][:, None], L.bn[nsl][:, None]
        bcs, cu = L.bcs[ksl][None, :], L.cu[ksl].T[None]
        g = lambda a: L.grid(a, t)
        npos, nlt = g(L.n_pos), g(L.n_lt)
        sc1, sc2 = g(L.sc1), g(L.sc2)
        gskE = nxt[E_][bs, bcs]
        gnkS = nxt[S_][bn, bcs]
        # (cn, A, ck) successor cells, the scores of each successor k-mer
        gspP = _w(npos[:, None], nxt[P_][bs[:, :, None], cu]
                  + g(L.sc1s).transpose(0, 2, 1))
        gnaA = _w(nlt[:, None], nxt[A_][bn[:, :, None], cu]
                  + g(L.sc2s).transpose(0, 2, 1))
        e_own = _w(npos, gskE + sc1)
        s_next = _w(nlt, gnkS + sc2)
        v = np.empty((5, cn, ck))
        v[A_] = e_own
        v[P_] = la(e_own + tl["e2"], s_next + tl["s1"])
        v[S_] = la(e_own + tl["e3"], la.reduce(gspP + tl["p1"], axis=1))
        v[E_] = la(la(e_own + tl["e4"], la.reduce(la(gspP + tl["p2"], gnaA + tl["a1"]), axis=1)),
                   s_next + tl["s2"])
        v[I_] = la(la.reduce(la(gspP + tl["p3"], gnaA + tl["a2"]), axis=1),
                   s_next + tl["s3"])
        if t > 0 and cn > 1:
            ns = L.ns[nsl]
            sci = g(L.sc_i)
            for i in range(cn - 2, -1, -1):
                if ns[i + 1] == ns[i] + 1 and ns[i] < L.N - 1:
                    below = v[I_, i + 1]
                    v[I_, i] = la(v[I_, i], below + tl["i2"] + sci[i])
                    v[E_, i] = la(v[E_, i], below + tl["i1"] + sci[i])
        v[:, ~g(L.allowed)] = NEG_INF
        out[t] = _padded(v)
    return out


def _prev_cells(L: Lattice, t: int):
    """Index arrays of column t's four predecessor cell sets in column
    t - 1: (rows same, cols same), (rows n - 1, cols same), and the A
    preceding k-mers' cols with either row set, (cn, A, ck)."""
    nsl, ksl, _, _, _ = L.col(t)
    rs, rp = L.rs[nsl][:, None], L.rp[nsl][:, None]
    cs, cp = L.cs[ksl][None, :], L.cp[ksl].T[None]
    return (rs, cs), (rp, cs), (rs[:, :, None], cp), (rp[:, :, None], cp)


def forward_viterbi(L: Lattice, bwd, Zb: float):
    """The forward columns (ref: NTC.cpp:417-480) with the posteriors lp =
    fwd + bwd - Zb and the 5-state max recurrence over them (ref:
    NTC.cpp:595-653). Returns (lp, vit), each a list of padded columns,
    and Zf."""
    tl, T = L.trans, L.T
    f = _init_column(L, 0, 0)
    lp0 = f + bwd[0][:, :-1, :-1] - Zb
    lps, vits = [_padded(lp0)], [_padded(f)]
    fp = _padded(f)
    for t in range(1, T):
        nsl, _, _, cn, ck = L.col(t)
        ss, ps, sp, pp = _prev_cells(L, t)
        g = lambda a: L.grid(a, t)
        ok = g(L.allowed) & g(L.n_pos)
        sc = g(L.sc_f)
        v = np.empty((5, cn, ck))
        gpp, gsp = fp[:, pp[0], pp[1]], fp[:, sp[0], sp[1]]
        gps, gss = fp[:, ps[0], ps[1]], fp[:, ss[0], ss[1]]
        v[A_] = la.reduce(la(gpp[E_] + tl["a1"], gpp[I_] + tl["a2"]), axis=1) + sc
        v[P_] = la.reduce(la(la(gsp[S_] + tl["p1"], gsp[E_] + tl["p2"]), gsp[I_] + tl["p3"]),
                          axis=1) + sc
        v[S_] = la(la(gps[P_] + tl["s1"], gps[E_] + tl["s2"]), gps[I_] + tl["s3"]) + sc
        v[E_] = la(la(gss[A_], gss[P_] + tl["e2"]), la(gss[S_] + tl["e3"], gss[E_] + tl["e4"])) + sc
        v[:, ~ok] = NEG_INF
        v[I_] = NEG_INF
        ns = L.ns[nsl]
        chain = [i for i in range(1, cn) if ns[i - 1] == ns[i] - 1]
        for i in chain:
            v[I_, i] = _w(ok[i], la(v[E_, i - 1] + tl["i1"] + sc[i],
                                   v[I_, i - 1] + (tl["i2"] + sc[i])))
        fp = _padded(v)
        lp = v + bwd[t][:, :-1, :-1] - Zb
        vp = vits[-1]
        gpp, gsp = vp[:, pp[0], pp[1]], vp[:, sp[0], sp[1]]
        gps, gss = vp[:, ps[0], ps[1]], vp[:, ss[0], ss[1]]
        m = np.maximum
        w = np.empty((5, cn, ck))
        w[A_] = m(gpp[E_], gpp[I_]).max(axis=1) + lp[A_]
        w[P_] = m(m(gsp[E_], gsp[S_]), gsp[I_]).max(axis=1) + lp[P_]
        w[S_] = m(m(gps[E_], gps[P_]), gps[I_]) + lp[S_]
        w[E_] = m(m(gss[E_], gss[A_]), m(gss[S_], gss[P_])) + lp[E_]
        w[:, ~ok] = NEG_INF
        w[I_] = NEG_INF
        for i in chain:
            w[I_, i] = _w(ok[i], m(w[E_, i - 1], w[I_, i - 1]) + lp[I_, i])
        lps.append(_padded(lp))
        vits.append(_padded(w))
        if t == T - 1:
            last = v
    nsl, _, _, _, _ = L.col(T - 1)
    rowN = (L.ns[nsl] == L.N - 1)[:, None] & L.grid(L.allowed, T - 1)
    Zf = float(la.reduce(np.where(rowN, last[E_], NEG_INF).ravel()))
    return lps, vits, Zf


def zb_of(L: Lattice, bwd) -> float:
    nsl, _, _, cn, ck = L.col(0)
    row0 = (L.ns[nsl] == 0)[:, None] & L.grid(L.allowed, 0)
    return float(la.reduce(np.where(row0, bwd[0][E_, :cn, :ck], NEG_INF).ravel()))


class _Stall(Exception):
    """The engine's walk would stall at this column (too many I steps)."""


def walk(L: Lattice, lps, vits, kmer_size: int, scale: float):
    """Segments [(state, basepos, start, median, polish k-mer id)] in read
    order by the reference's traceback (ref: NTC.cpp:691-904), or [] where
    no start cell is finite. Raises _Stall where the engine's walk would
    stall."""
    T, N, K, A = L.T, L.N, L.K, L.A
    half = kmer_size // 2
    cache = {}

    def slots(t):
        s = cache.get(t)
        if s is None:
            nsl, ksl, _, _, _ = L.col(t)
            s = cache[t] = ({int(n): i for i, n in enumerate(L.ns[nsl])},
                            {int(k): j for j, k in enumerate(L.ks[ksl])})
        return s

    def get(arrs, t, n, k, st):
        if t < 0 or t >= T:
            return NEG_INF
        si, sj = slots(t)
        i, j = si.get(n), sj.get(k)
        if i is None or j is None:
            return NEG_INF
        return float(arrs[t][st, i, j])

    # start: the last k (ascending) attaining the best E at (T-1, N-1)
    si, sj = slots(T - 1)
    if N - 1 not in si:
        return []
    best_v, best_k = NEG_INF, None
    for k, j in sj.items():
        v = float(vits[T - 1][E_, si[N - 1], j])
        if L.grid(L.allowed, T - 1)[si[N - 1], j] and v >= best_v:
            best_v, best_k = v, k
    if best_k is None or not math.isfinite(best_v):
        return []
    V = lambda t, n, k, st: get(vits, t, n, k, st)
    P = lambda t, n, k, st: get(lps, t, n, k, st)
    prec = lambda k: [k // A + a * (K // A) for a in range(A)]
    t, n, k, state = T - 1, N - 1, best_k, E_
    probs: list = []
    segs: list = []
    i_steps = 0

    def emit(front, bp, start):
        p = sorted(probs)
        m = len(p)
        med = p[m // 2] if m % 2 else 0.5 * (p[m // 2 - 1] + p[m // 2])
        segs.append((front, bp, start, med * scale, k))
        probs.clear()

    while t:
        if state == E_:
            if t == 1:
                emit("M", half, 0)
                break
            sc, ls = V(t, n, k, E_), P(t, n, k, E_)
            probs.append(math.exp(ls))
            for st in (E_, A_, S_, P_):
                if sc == V(t - 1, n, k, st) + ls:
                    state = st
                    break
            else:
                raise RuntimeError(f"walk: no predecessor of E at t={t} n={n} k={k}")
            t -= 1
            i_steps = 0
        elif state in (A_, P_):
            if t == 1 and (state == P_ or n == 1):
                emit("M" if state == A_ else "P", half, 0)
                break
            sc, ls = V(t, n, k, state), P(t, n, k, state)
            probs.append(math.exp(ls))
            dn = 1 if state == A_ else 0
            sts = (E_, I_) if state == A_ else (E_, S_, I_)
            hit = None
            for pre in prec(k):
                for st in sts:
                    if sc == V(t - 1, n - dn, pre, st) + ls:
                        hit = (pre, st)
                        break
                if hit:
                    break
            if hit is None:
                raise RuntimeError(f"walk: no predecessor at t={t} n={n} k={k}")
            emit("M" if state == A_ else "P", n - 1 + half, t - 1)
            k, state = hit
            t, n = t - 1, n - dn
            i_steps = 0
        elif state == S_:
            if t == 1 and n == 1:
                break
            sc, ls = V(t, n, k, S_), P(t, n, k, S_)
            probs.append(math.exp(ls))
            for st in (E_, P_, I_):
                if sc == V(t - 1, n - 1, k, st) + ls:
                    state = st
                    break
            t, n = t - 1, n - 1
            i_steps = 0
        else:  # I: n - 1 at the same t; E overrides I on ties
            if n == 1:
                break
            i_steps += 1
            if i_steps > WALK_I_STEPS:
                raise _Stall()
            sc, ls = V(t, n, k, I_), P(t, n, k, I_)
            probs.append(math.exp(ls))
            if sc == V(t, n - 1, k, I_) + ls:
                state = I_
            if sc == V(t, n - 1, k, E_) + ls:
                state = E_
            n -= 1
    segs.reverse()
    return segs


def int2kmer(value: int, A: int, S: int, rna: bool) -> str:
    """ref: utils.cpp itoa: digits least significant first, reversed for
    DNA only (RNA k-mers are held 3'->5')."""
    d = "".join("ACGT"[(value // A ** p) % A] for p in range(S))
    return d if rna else d[::-1]


def _segments(x, kid, table, pore: str, exact: bool):
    """(rung, Zf, Zb, segments) of one read at the rung its candidates
    reach, or None where it needs the exact rung."""
    tr = TRANSITIONS[pore]
    pre = tr["pre"]
    A = table.alphabet_size
    mu, c1, c2 = table.score_params()
    order_n, count_n = tn_pass(x, kid, table.means, table.stdevs, pre["m1"], pre["e2"])
    order_k, count_k = tk_pass(x, mu, c1, c2, A, pre["m1"], pre["e2"])
    rung = pick_rung(count_n, count_k, exact)
    if rung is None:
        return None
    cap_n, cap_k, _ = rung
    cand_n = [np.sort(o[:min(c, cap_n)]) for o, c in zip(order_n, count_n)]
    cand_k = [o[:min(c, cap_k)] for o, c in zip(order_k, count_k)]
    L = Lattice(x, kid, table, cand_n, cand_k, tr["ntc"])
    bwd = backward(L)
    Zb = zb_of(L, bwd)
    lps, vits, Zf = forward_viterbi(L, bwd, Zb)
    del bwd
    diff = Zb - Zf
    scale = 1.0 if diff == 0.0 else math.exp(min(diff, 700.0))
    try:
        segs = walk(L, lps, vits, table.kmer_size, scale)
    except _Stall:
        return None
    if not segs and not exact:
        return None
    return (cap_n, cap_k), Zf, Zb, segs


def segment_one(signal, read: str, table, pore: str):
    """(rung, Zf, Zb, segments) of one read: the main or wide rung over the
    signal rounded to float32, else the exact rung over the float64
    signal. Segments (state, basepos, start, median, polish k-mer)."""
    kid = table.kmer_ids(read)
    sig = np.asarray(signal, np.float64)
    res = _segments(sig.astype(np.float32).astype(np.float64), kid, table, pore, False)
    if res is None:
        res = _segments(sig, kid, table, pore, True)
    rung, Zf, Zb, segs = res
    out = [(st, bp, start, med, int2kmer(k, table.alphabet_size, table.kmer_size, table.rna))
           for st, bp, start, med, k in segs]
    return rung, Zf, Zb, out


def host_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def segment(reads, table, pore: str, *, workers: int | None = None, device=None,
            dtype=None):
    """[(Zf, Zb, rows)] of each (signal, read) pair, rows as
    `banded.rows_of_segments` lays them out. The reads run longest first on
    `workers` processes (default: one a host core, at most one a read);
    NumPy float64 on the host, whatever `device` and `dtype` say."""
    from benchmark.reference.banded import rows_of_segments

    n = workers or min(len(reads), host_cores())
    order = sorted(range(len(reads)), key=lambda i: -len(reads[i][0]))
    res = [None] * len(reads)
    if n <= 1:
        for i in order:
            res[i] = segment_one(reads[i][0], reads[i][1], table, pore)
    else:
        import multiprocessing

        with ProcessPoolExecutor(n, mp_context=multiprocessing.get_context("spawn")) as ex:
            futs = {i: ex.submit(segment_one, reads[i][0], reads[i][1], table, pore)
                    for i in order}
            for i, f in futs.items():
                res[i] = f.result()
    return [(Zf, Zb, rows_of_segments(segs, len(sig), read, table))
            for (sig, read), (_, Zf, Zb, segs) in zip(reads, res)]

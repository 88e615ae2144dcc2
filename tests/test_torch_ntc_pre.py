"""The port's NTC pre-passes against dynamont_tpu's, on the CPU.

* The batched pre-pass (the plain versions of K7-K10 and the torch
  selection around them) against dynamont_tpu.ops.ntc_batch's scan path on
  three ragged short reads in one bucket: in fp64 identical candidates,
  counts and overflow flags and Zf/Zb within 1e-12*max(1, |Z|); in fp32 the
  same candidates and Z within 1e-5 + 1e-6*|Z| (torch's and XLA's CPU
  exp/log1p differ in the last bit).
* select_topk on the tie / exhausted-column / dead-column matrix of
  tests/test_ntc_batch.py, at the TN cap (iterated max) and the TK cap
  (stable sort), against the JAX function.
* The per-read pre_tn/pre_tk (the exact rung) against dynamont_tpu.ops.ntc_pre.
* K8's plain version as two passes (tn_bwd_u_plain, the chain, then
  tn_sel_plain, the selection) equals the fused one-pass form bit for bit,
  and tn_sel_plain equals a row-by-row reference of its top-cap and mass
  on rows with ties and exhausted rows (the port's own paths; no JAX run).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu.ops import nt_full as jnt_full
from dynamont_tpu.ops import ntc_batch as jnb
from dynamont_tpu.ops import ntc_pre as jpre
from dynamont_tpu.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.ops import nt_full as tnt_full
from dynamont_tpu_torch.ops import ntc_batch as tnb
from dynamont_tpu_torch.ops import ntc_pre as tpre
from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

from tests.synthetic import make_read

LM, LE = math.log(0.019889650396799997), math.log(0.9801103496029998)
CN, CK0 = 8, 120  # the resquiggle engine's kernel caps
DTYPES = {"float64": (torch.float64, jnp.float64),
          "float32": (torch.float32, jnp.float32)}


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


@pytest.fixture(scope="module")
def bucket(model):
    """Three ragged reads (as tests/test_ntc_batch.py), padded as the engine
    pads with t_pad_to 64 and n_pad_to 16."""
    reads = [make_read(model, n_bases=n, seed=s)
             for s, n in ((0, 25), (1, 31), (2, 18))]
    kids = [np.asarray(seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size),
                       np.int32) for _, r in reads]
    T = np.array([len(s) + 1 for s, _ in reads], np.int32)
    N = np.array([len(k) + 1 for k in kids], np.int32)
    T_pad = -(-int(T.max()) // 64) * 64
    N2 = -(-int(N.max()) // 16) * 16
    sig = np.zeros((3, T_pad - 1))
    kid = np.zeros((3, N2 - 1), np.int32)
    for i, ((s, _), k) in enumerate(zip(reads, kids)):
        sig[i, : len(s)] = s
        kid[i, : len(k)] = k
    means, c1, c2 = model.score_params()
    return dict(sig=sig, kid=kid, T=T, N=N, means=means, c1=c1, c2=c2,
                mu=model.means, sd=model.stdevs)


@pytest.fixture(scope="module")
def jax_pre(bucket):
    b = {k: jnp.asarray(v) for k, v in bucket.items()}
    out = {}
    for name, (_, jdt) in DTYPES.items():
        out[name] = (
            jnb.pre_tn_batch(b["sig"], b["kid"], b["N"], b["T"], b["mu"],
                             b["sd"], LM, LE, CN, jdt),
            jnb.pre_tk_batch(b["sig"], b["T"], b["means"], b["c1"], b["c2"],
                             LM, LE, 4, CK0, jdt),
        )
    return out


def _port_pre(bucket, dtype):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in bucket.items()}
    pn = tnb.pre_tn_batch(t["sig"], t["kid"], t["N"], t["T"], t["mu"],
                          t["sd"], LM, LE, CN, dtype)
    pk = tnb.pre_tk_batch(t["sig"], t["T"], t["means"], t["c1"], t["c2"],
                          LM, LE, 4, CK0, dtype)
    return pn, pk


@pytest.mark.parametrize("which", ["tn", "tk"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batched_prepass_matches_jax(bucket, jax_pre, dtype, which):
    runs = dict(kn.PLAIN_RUNS)
    pn, pk = _port_pre(bucket, DTYPES[dtype][0])
    # on CPU tensors every pre-pass stage ran its plain version once
    assert all(kn.PLAIN_RUNS[k] == runs[k] + 1 for k in kn.KERNELS)
    got = pn if which == "tn" else pk
    want = jax_pre[dtype][0 if which == "tn" else 1]
    # TN ascending, TK in selection order (descending, ties to the lower
    # index) in both packages
    np.testing.assert_array_equal(got.cand.numpy(), np.asarray(want.cand))
    np.testing.assert_array_equal(got.cnt.numpy(), np.asarray(want.cnt))
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(want.overflow))
    assert not got.overflow.any()
    for z_got, z_want in ((got.Zf, want.Zf), (got.Zb, want.Zb)):
        z_want = np.asarray(z_want, np.float64)
        tol = (1e-12 * np.maximum(1.0, np.abs(z_want)) if dtype == "float64"
               else 1e-5 + 1e-6 * np.abs(z_want))
        assert np.all(np.abs(z_got.numpy().astype(np.float64) - z_want) <= tol)
    if which == "tn":
        # the k-mer values ride with the candidates: kid[cand-1], kid[cand]
        # clipped to [0, N2-2], as ops/ntc_pre_pallas.pre_tn_pallas gives them
        kid = torch.from_numpy(bucket["kid"]).long()
        N2 = kid.shape[1] + 1
        cand = got.cand.long()
        for kn_got, off in ((got.kn1, -1), (got.kn2, 0)):
            idx = (cand + off).clamp(0, N2 - 2)
            want_kn = torch.gather(kid[None].expand(cand.shape[0], -1, -1), 2, idx)
            valid = cand < N2
            assert torch.equal(kn_got.long()[valid], want_kn[valid])


@pytest.mark.parametrize("cap", [8, 120])
def test_select_topk_matches_jax(cap):
    """Ties to the lower index, exhausted and dead columns, through the
    iterated max (cap <= 16) and the stable sort (cap > 16)."""
    rng = np.random.default_rng(0)
    U = rng.normal(size=(64, 256))
    U[1, 5:] = -np.inf                       # exhausted column
    U[2, 10] = U[2, 20] = U[2, 30] = 3.0     # ties -> lower index first
    U[3, :] = 1.0                            # a column of ties
    U[4, :] = -np.inf                        # dead: all -inf
    live = rng.random(64) > 0.1
    live[1:5] = True
    for ge in (False, True):
        got = tnb.select_topk(torch.from_numpy(U), cap, ge,
                              torch.from_numpy(live), 256)
        want = jnb.select_topk(jnp.asarray(U), cap, ge, jnp.asarray(live), 256)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _, idx = kn._topk_maxmask(torch.from_numpy(U), 8)
    assert idx[2, :3].tolist() == [10, 20, 30]
    assert idx[3].tolist() == list(range(8))


def test_wrappers_refuse_other_devices(bucket):
    """A tensor neither on the CPU nor on a card raises; no plain run."""
    sig = torch.zeros((3, 10), device="meta")
    tab = torch.zeros((3, 3, 15), device="meta")
    T = torch.zeros((3,), dtype=torch.int32, device="meta")
    runs = dict(kn.PLAIN_RUNS)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kn.tn_fwd(sig, tab, T, LM, LE)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kn.tk_bwd(sig, torch.zeros((3, 1024), device="meta"), T, 4, LM, LE)
    assert kn.PLAIN_RUNS == runs


@pytest.mark.parametrize("which", ["tn", "tk"])
def test_per_read_prepass_matches_jax(model, which):
    """The exact rung's pre-pass (global-Z normalization, associative-scan
    mass): identical candidates and counts, Z within 1e-12."""
    sig, read = make_read(model, n_bases=30, seed=2)
    if which == "tn":
        kid = seq_to_kmer_ids(read, model.kmer_size, model.alphabet_size)
        want = jpre.pre_tn(jnt_full.emission_scores(
            sig, kid, model.means, model.stdevs, jnp.float64), LM, LE, 8)
        got = tpre.pre_tn(tnt_full.emission_scores(
            sig, kid, model.means, model.stdevs, device="cpu"), LM, LE, 8)
    else:
        means, c1, c2 = model.score_params()
        want = jpre.pre_tk(jnp.asarray(sig), jnp.asarray(means),
                           jnp.asarray(c1), jnp.asarray(c2), LM, LE, 4, 16)
        t = lambda a: torch.from_numpy(np.asarray(a, np.float64))
        got = tpre.pre_tk(t(sig), t(means), t(c1), t(c2), LM, LE, 4, 16)
    np.testing.assert_array_equal(got.cand.numpy(), np.asarray(want.cand))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    assert bool(got.overflow) == bool(want.overflow)
    for g, w in ((got.Zf, want.Zf), (got.Zb, want.Zb)):
        assert abs(float(g) - float(w)) <= 1e-12 * max(1.0, abs(float(w)))


def test_running_mass_matches_associative_scan():
    """The per-read selection's running logsumexp combines in
    jax.lax.associative_scan's order at every length (odd, even, 1)."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 4, 5, 8, 13, 64, 257):
        x = np.sort(rng.normal(scale=4.0, size=(4, n)), axis=1)[:, ::-1].copy()
        x[0, n // 2:] = -np.inf
        want = np.asarray(jax.lax.associative_scan(jnp.logaddexp,
                                                   jnp.asarray(x), axis=1))
        got = tpre._running_logaddexp(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-15, atol=0)


def _fused_tn_bwd_sel(sig, tab, kid, N_r, T_r, fwd, cap, log_m1, log_e2):
    """K8's plain version in its one-pass form (the selection taken on the
    chain, row by row), the form tn_bwd_u_plain + tn_sel_plain split."""
    R, Tm1 = sig.shape
    T_pad, N2 = Tm1 + 1, tab.shape[2] + 1
    dev, dtype = sig.device, sig.dtype
    mu, sinv, l2s = tab
    B = kn.threads(N2)
    n_iota = torch.arange(N2, device=dev)[None, :]
    live = n_iota[:, :-1] < (N_r - 1)[:, None]
    term_E = torch.where(n_iota == (N_r - 1)[:, None], 0.0, -math.inf).to(dtype)
    kid = kid.long()
    pack = torch.empty((T_pad, R, 4 * cap + 2), dtype=dtype, device=dev)
    M_next = torch.full((R, N2), -math.inf, dtype=dtype, device=dev)
    E_next = M_next.clone()
    neg1 = torch.full((R, 1), -math.inf, dtype=dtype, device=dev)
    zero = torch.zeros((R,), dtype=dtype, device=dev)
    for t in range(T_pad - 1, -1, -1):
        sc = kn._tn_scores(sig[:, t] if t < Tm1 else zero, mu, sinv, l2s, live)
        ext = torch.cat([M_next[:, 1:] + sc + log_m1, neg1], dim=1)
        M_new = torch.cat([neg1, E_next[:, 1:] + sc], dim=1)
        ext[:, 1:] = torch.logaddexp(ext[:, 1:], E_next[:, 1:] + sc + log_e2)
        is_term = (t == T_r - 1)[:, None]
        dead = (t > T_r - 1)[:, None]
        M_next = torch.where(is_term | dead, -math.inf, M_new)
        E_next = torch.where(is_term, term_E, torch.where(dead, -math.inf, ext))
        u = torch.logaddexp(fwd[t, 0] + M_next, fwd[t, 1] + E_next)
        vals, idx = kn._topk_maxmask(u, cap)
        m0 = vals[:, 0]
        m0s = torch.where(torch.isfinite(m0), m0, 0.0)
        tot = kn._tree_sum(torch.exp(u - m0s[:, None]), B)
        kn1 = torch.gather(kid, 1, (idx - 1).clamp(0, N2 - 2))
        kn2 = torch.gather(kid, 1, idx.clamp(0, N2 - 2))
        pack[t] = torch.cat([vals, idx.to(dtype), kn1.to(dtype),
                             kn2.to(dtype), m0[:, None], tot[:, None]], dim=1)
    return pack, E_next


def _tn_bucket(model, n2, dtype):
    """Three short reads at N2 = n2 (reads short enough to fit), padded as
    the engine pads (T_pad a multiple of 64): sig, tab, kid, N_r, T_r."""
    bases = {8: (2, 1, 2), 64: (25, 31, 18), 2048: (25, 31, 18)}[n2]
    reads = [make_read(model, n_bases=n, seed=20 + s) for s, n in enumerate(bases)]
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size) for _, r in reads]
    T = np.array([len(s) + 1 for s, _ in reads], np.int32)
    N = np.array([len(k) + 1 for k in kids], np.int32)
    assert N.max() <= n2
    T_pad = -(-int(T.max()) // 64) * 64
    sig = np.zeros((3, T_pad - 1))
    kid = np.zeros((3, n2 - 1), np.int32)
    for i, ((s, _), k) in enumerate(zip(reads, kids)):
        sig[i, : len(s)] = s
        kid[i, : len(k)] = k
    t = lambda a: torch.from_numpy(np.asarray(a))
    tab = tnb.tn_tables(t(kid), t(model.means), t(model.stdevs), dtype)
    return t(sig).to(dtype), tab, t(kid), t(N), t(T)


@pytest.mark.parametrize("n2, cap", [(8, 1), (64, 8), (2048, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tn_bwd_sel_split_equals_fused(model, dtype, n2, cap):
    """tn_sel_plain after tn_bwd_u_plain gives the fused pass's pack and E0
    bit for bit, at B = threads(N2) 8, 64 and 512; the bucket has
    exhausted rows (fewer than cap finite columns) and dead ones."""
    sig, tab, kid, N, T = _tn_bucket(model, n2, dtype)
    fwd = kn.tn_fwd_plain(sig, tab, N, LM, LE)
    want = _fused_tn_bwd_sel(sig, tab, kid, N, T, fwd, cap, LM, LE)
    u, E0 = kn.tn_bwd_u_plain(sig, tab, N, T, fwd, LM, LE)
    runs = kn.PLAIN_RUNS["ntc_tn_bwd_sel"]
    for got in ((kn.tn_sel_plain(u, kid, cap), E0),
                kn.tn_bwd_sel_plain(sig, tab, kid, N, T, fwd, cap, LM, LE)):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert kn.PLAIN_RUNS["ntc_tn_bwd_sel"] == runs + 1
    vals = want[0][..., :cap]
    assert torch.isneginf(vals[..., 0]).any()              # dead rows
    if cap > 1:
        finite = torch.isfinite(vals[..., 0])
        assert (finite & torch.isneginf(vals[..., -1])).any()  # exhausted rows


def _sel_rows(n2, dtype):
    """(u (4, 3, n2), kid (3, n2-1)): normal rows, a tie for the max at
    three columns, a row of one value, rows with 2 finite columns (exhausted
    for cap > 2), a row all -inf, and ties at the cap boundary."""
    rng = np.random.default_rng(n2)
    u = rng.normal(scale=3.0, size=(4, 3, n2))
    u[0, 1, [1, n2 // 2, n2 - 1]] = 9.0
    u[0, 2, :] = 1.5
    u[1, 0, :] = -np.inf
    u[1, 0, [3 % n2, n2 - 2]] = [0.5, 0.25]
    u[1, 1, :] = -np.inf
    u[2, 2, ::3] = 4.0
    kid = rng.integers(0, 1024, size=(3, n2 - 1)).astype(np.int32)
    return torch.from_numpy(u).to(dtype), torch.from_numpy(kid)


def _sel_reference(u, kid, cap):
    """The selection row by row in numpy: the top cap in the order
    (value descending, index ascending), (-inf, 0) once nothing finite is
    left; the mass of exp(u - m0) (torch's exp) summed slot by slot (slot
    b: columns b, b+B, ...), then pairwise within each 32 slots, then over
    the warp sums, in u's dtype."""
    T_pad, R, N2 = u.shape
    B = kn.threads(N2)
    nd = np.float32 if u.dtype == torch.float32 else np.float64

    def halve(x):
        while len(x) > 1:
            h = len(x) // 2
            x = [x[i] + x[i + h] for i in range(h)]
        return x[0]

    pack = np.zeros((T_pad, R, 4 * cap + 2), nd)
    for t in range(T_pad):
        for r in range(R):
            row = u[t, r].numpy()
            order = sorted(range(N2), key=lambda c: (-row[c], c))[:cap]
            picks = [(row[c], c) if np.isfinite(row[c]) else (-np.inf, 0)
                     for c in order]
            picks += [(-np.inf, 0)] * (cap - len(picks))
            m0 = picks[0][0]
            e = torch.exp(u[t, r] - (m0 if np.isfinite(m0) else 0.0)).numpy()
            slots = []
            for b in range(B):
                acc = e[b]
                for c in range(b + B, N2, B):
                    acc = nd(acc + e[c])
                slots.append(acc)
            mass = (halve([halve(slots[g:g + 32]) for g in range(0, B, 32)])
                    if B > 32 else halve(slots))
            for j, (v, c) in enumerate(picks):
                pack[t, r, j] = v
                pack[t, r, cap + j] = c
                pack[t, r, 2 * cap + j] = kid[r, min(max(c - 1, 0), N2 - 2)]
                pack[t, r, 3 * cap + j] = kid[r, min(c, N2 - 2)]
            pack[t, r, 4 * cap] = m0
            pack[t, r, 4 * cap + 1] = mass
    return torch.from_numpy(pack)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tn_sel_plain_on_ties_and_exhausted_rows(dtype):
    """tn_sel_plain against the row-by-row reference, bit for bit, at N2 8,
    64, 96 and 2048 (B 8, 64, 32, 512) and caps 1, 8 and 16."""
    for n2 in (8, 64, 96, 2048):
        u, kid = _sel_rows(n2, dtype)
        for cap in (1, 8, 16):
            if cap > n2:
                continue
            torch.testing.assert_close(kn.tn_sel_plain(u, kid, cap),
                                       _sel_reference(u, kid.numpy(), cap),
                                       rtol=0, atol=0, equal_nan=True)

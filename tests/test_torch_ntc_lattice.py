"""The port's batched NTC lattice (plain versions of K11, K13, K15, K16)
against dynamont_tpu's scan path, on the CPU.

Three ragged reads (seeds 0-2, 25/31/18 bases) in one bucket padded as the
engine pads them with t_pad_to 64 and n_pad_to 16, caps (8, 120), fp64 and
fp32. Each package runs its own pre-pass; the two agree on every
candidate (tests/test_torch_ntc_pre.py), which the plan check repeats:

* the plan: every integer field identical; the gathered model parameters
  identical at live slots (dead slots read 0 in the port, a clipped table
  value in JAX; no kernel reads them);
* the backward store, lp and the terminal E columns: fp64 within
  1e-12*max(1, |x|) with -inf at the same cells; fp32 within 5e-4, the JAX
  suite's own bound between two fp32 implementations
  (tests/test_ntc_pallas.py::_cmp); the fp32 Viterbi finals within
  5e-5*max(1, |x|): they sum ~T posteriors, each a difference of ~1e2
  values good to a few fp32 ulp, to ~2e4 (one fp32 ulp there is 2e-3).
  The port folds the in-column I chains
  sequentially where JAX runs an associative scan, and sums term lists in
  list order;
* Zf and Zb: rel 1e-12 in fp64, 1e-4 in fp32;
* the Viterbi choices identical on live cells, in fp32 too (no near-tie
  of the two best candidates on these reads);
* the walk: start cells, segment counts, states, borders and polish k-mers
  identical, medians within 1e-12 (fp64) or 1e-6 (fp32).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamont_tpu.constants import NT_TRANSITIONS, NTK_TRANSITIONS
from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu.ops import ntc_batch as jnb
from dynamont_tpu.ops import ntc_walk as jnw
from dynamont_tpu.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.ops import ntc_batch as tnb
from dynamont_tpu_torch.ops import ntc_kernels as kern
from dynamont_tpu_torch.ops import ntc_walk as tnw

from tests.synthetic import make_read

CN, CK0, A, S = 8, 120, 4, 5
DTYPES = {"float64": (torch.float64, jnp.float64),
          "float32": (torch.float32, jnp.float32)}
NT = NT_TRANSITIONS["rna002"]
LM, LE = math.log(NT["m1"]), math.log(NT["e2"])
TL = {k: math.log(v) for k, v in NTK_TRANSITIONS["rna002"].items()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of tiny torch ops, where intra-op
    threads only contend for the cores (and with the other test workers):
    one thread is 2-30x faster here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bucket():
    model = load_model_for_pore("rna002")
    reads = [make_read(model, n_bases=n, seed=s)
             for s, n in ((0, 25), (1, 31), (2, 18))]
    kids = [np.asarray(seq_to_kmer_ids(r, S, A), np.int32) for _, r in reads]
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
    return dict(sig=sig, kid=kid, T=T, N=N, N2=N2, means=means, c1=c1, c2=c2,
                sd=model.stdevs, K=model.num_kmers,
                S_max=-(-(N2 + N2 // 4 + 64) // 128) * 128)


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def jax_ref(bucket):
    """JAX's scan path, stage by stage, for each dtype."""
    b = bucket
    out = {}
    for name, (_, jdt) in DTYPES.items():
        sig, kid = jnp.asarray(b["sig"]), jnp.asarray(b["kid"])
        N_r, T_r = jnp.asarray(b["N"]), jnp.asarray(b["T"])
        mu, c1, c2 = (jnp.asarray(b[k]) for k in ("means", "c1", "c2"))
        pn = jnb.pre_tn_batch(sig, kid, N_r, T_r, mu, jnp.asarray(b["sd"]),
                              LM, LE, CN, jdt)
        pk = jnb.pre_tk_batch(sig, T_r, mu, c1, c2, LM, LE, A, CK0, jdt)
        plan, dims = jnb.build_plan_batch(pn.cand, pn.cnt, pk.cand, pk.cnt,
                                          kid, N_r, mu, c1, c2, A, S, jdt)
        sigd = sig.astype(jdt)
        bwd = jnb.ntc_backward_batch(plan, dims, sigd, TL, N_r, T_r, S, jdt)
        Zb = jnb.ntc_zb_batch(plan, dims, bwd[0])
        lp, ch, apE, fwdE = jnb.ntc_posterior_viterbi_batch(
            plan, dims, sigd, bwd, Zb, TL, N_r, T_r, S, jdt)
        Zf = jnb.ntc_zf_batch(plan, dims, fwdE, N_r, T_r)
        i0, j0, k0, valid = jnw.start_slots(plan, dims, apE, N_r, T_r)
        walk = jnw.ntc_walk_batch(plan, dims, lp, ch, N_r, T_r, i0, j0, k0,
                                  valid, b["K"], S, b["S_max"])
        out[name] = dict(
            plan={f: _np(getattr(plan, f)) for f in plan._fields},
            bwd=_np(bwd), Zb=_np(Zb), lp=_np(lp), ch=_np(ch), apE=_np(apE),
            fwdE=_np(fwdE), Zf=_np(Zf),
            start=tuple(_np(x) for x in (i0, j0, k0, valid)),
            walk=tuple(_np(x) for x in walk))
    return out


@pytest.fixture(scope="module")
def port(bucket):
    """The port's pre-pass and lattice, for each dtype."""
    b = bucket
    t = lambda x: torch.from_numpy(np.array(x))
    out = {}
    for name, (dtype, _) in DTYPES.items():
        N_r, T_r = t(b["N"]), t(b["T"])
        means, c1, c2 = t(b["means"]), t(b["c1"]), t(b["c2"])
        sig = t(b["sig"])
        pn = tnb.pre_tn_batch(sig, t(b["kid"]), N_r, T_r, means, t(b["sd"]),
                              LM, LE, CN, dtype)
        pk = tnb.pre_tk_batch(sig, T_r, means, c1, c2, LM, LE, A, CK0, dtype)
        plan, dims = tnb.build_plan_batch(
            pn.cand, pn.cnt, pk.cand, pk.cnt, t(b["kid"]), N_r, b["K"], A, S,
            pn.kn1, pn.kn2)
        table = tnb.combined_tables(means, c1, c2, A, dtype)
        prm = kern.tab_gather(tnb.gather_index(plan), table, dims)
        sig = sig.to(dtype)
        bwd = kern.bwd(plan, dims, prm, sig, TL, N_r, T_r)
        Zb = tnb.ntc_zb_batch(plan, bwd[0])
        lp, ch, slots, apE, fwdE = kern.pv(plan, dims, prm, sig, bwd, Zb, TL,
                                           T_r)
        Zf = tnb.ntc_zf_batch(plan, fwdE, N_r, T_r)
        i0, j0, k0, valid = tnw.start_slots(plan, apE, N_r, T_r)
        rec, fin = kern.walk(lp, ch, slots, plan, i0, j0, k0, valid, N_r, T_r,
                             b["K"], A, S, b["S_max"])
        out[name] = dict(plan=plan, dims=dims, prm=prm, bwd=bwd, Zb=Zb, lp=lp,
                         ch=ch, slots=slots, apE=apE, fwdE=fwdE, Zf=Zf,
                         start=(i0, j0, k0, valid),
                         walk=tnw.finish_records(rec, fin, b["S_max"]))
    return out


def _close(got, want, dtype, rel32=None):
    """fp64: 1e-12*max(1, |x|); fp32: 5e-4, or rel32*max(1, |x|); -inf at
    the same cells."""
    got = got.numpy().astype(np.float64).reshape(want.shape)
    want = want.astype(np.float64)
    assert np.array_equal(np.isneginf(got), np.isneginf(want)), "-inf patterns differ"
    assert np.isfinite(got[~np.isneginf(got)]).all()
    fin = np.isfinite(want)
    d = np.abs(got[fin] - want[fin])
    scale = np.maximum(1.0, np.abs(want[fin]))
    tol = (1e-12 * scale if dtype == "float64"
           else 5e-4 if rel32 is None else rel32 * scale)
    assert np.all(d <= tol), d.max()


def _z_close(got, want, dtype):
    got = got.numpy().astype(np.float64)
    want = want.astype(np.float64)
    tol = 1e-12 * np.abs(want) if dtype == "float64" else 1e-4 * np.abs(want)
    assert np.all(np.abs(got - want) <= tol), (got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_matches_jax(bucket, jax_ref, port, dtype):
    want = jax_ref[dtype]["plan"]
    plan, dims = port[dtype]["plan"], port[dtype]["dims"]
    T = plan.cand_n.shape[0]
    R, CK = dims.R, dims.CK
    assert dims == (3, CN, CN + CK0, A)
    live = want["live"].reshape(T, R, CK)
    for f in ("cand_n", "cnt_n", "ks", "live", "allowed", "kN", "kN2", "d01",
              "d02", "row_same", "row_prev", "brow_same", "brow_next",
              "col_same", "col_prec", "bcol_same", "bcol_suc"):
        got = getattr(plan, f).numpy()
        np.testing.assert_array_equal(got, want[f].reshape(got.shape), err_msg=f)
    # from_tk is read only through `allowed`, which requires a live slot
    np.testing.assert_array_equal(plan.from_tk.numpy() & live,
                                  want["from_tk"].reshape(T, R, CK) & live)
    hd = plan.hd.numpy().astype(np.int32)
    for sh, f in zip((0, 4, 8, 12), ("hd1", "hd2", "hd1s", "hd2s")):
        np.testing.assert_array_equal((hd >> sh) & 15,
                                      want[f].reshape(hd.shape), err_msg=f)
    prm = port[dtype]["prm"]
    for got, f in zip((prm.mu_k, prm.c1_k, prm.c2_k), ("mu_k", "c1_k", "c2_k")):
        np.testing.assert_array_equal(got.numpy()[live],
                                      want[f].reshape(T, R, CK)[live], err_msg=f)
    live_a = np.broadcast_to(live[:, :, None, :], (T, R, A, CK))
    for s, f in enumerate(("mu_suc", "c1_suc", "c2_suc")):
        got = prm.suc[:, s].numpy().reshape(T, R, A, CK)
        np.testing.assert_array_equal(got[live_a],
                                      want[f].reshape(T, R, A, CK)[live_a], err_msg=f)
    for got, f in zip(prm.n_side(dims),
                      ("mu_n", "c1_n", "c2_n", "mu_n2", "c1_n2", "c2_n2")):
        np.testing.assert_array_equal(got.numpy(), want[f].reshape(got.shape),
                                      err_msg=f)


def test_tab_gather_equals_table_indexing(port):
    """K11's plain version against the one PyTorch call that computes the
    same values (advanced indexing of the stacked table) at live slots."""
    p = port["float64"]
    plan, dims = p["plan"], p["dims"]
    ks = tnb.gather_index(plan)
    table = torch.arange(15 * 1024, dtype=torch.float64).reshape(15, 1024)
    got = kern.tab_gather(ks, table, dims)
    lib = table[:, ks.clamp(0, 1023).long()]
    R, CN, CK = dims.R, dims.CN, dims.CK
    T = ks.shape[0]
    live = plan.ks < 1024
    for row, x in enumerate((got.mu_k, got.c1_k, got.c2_k)):
        assert torch.equal(x[live], lib[row, :, : R * CK].reshape(T, R, CK)[live])
        assert torch.equal(x[~live], torch.zeros_like(x[~live]))
    suc = got.suc.reshape(T, 3, R, A, CK)
    for s in range(3):
        for a in range(A):
            want = lib[3 + s * A + a, :, : R * CK].reshape(T, R, CK)
            assert torch.equal(suc[:, s, :, a][live], want[live])
    assert torch.equal(got.nsl, lib[:3, :, R * CK:].permute(1, 0, 2))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backward_matches_jax(jax_ref, port, dtype):
    _close(port[dtype]["bwd"], jax_ref[dtype]["bwd"], dtype)
    _z_close(port[dtype]["Zb"], jax_ref[dtype]["Zb"], dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_posteriors_and_finals_match_jax(jax_ref, port, dtype):
    for f in ("lp", "fwdE"):
        _close(port[dtype][f], jax_ref[dtype][f], dtype)
    _close(port[dtype]["apE"], jax_ref[dtype]["apE"], dtype, rel32=5e-5)
    _z_close(port[dtype]["Zf"], jax_ref[dtype]["Zf"], dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_choices_match_jax(jax_ref, port, dtype):
    p = port[dtype]
    plan = p["plan"]
    got = p["ch"].numpy().astype(np.int32)
    want = jax_ref[dtype]["ch"].reshape(got.shape)
    live = (plan.allowed & (plan.cand_n >= 1)[..., None]).numpy()
    assert not (live & (got != want)).any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_walk_matches_jax(bucket, jax_ref, port, dtype):
    """The walk on JAX's posteriors and choices: start cells and every
    summary identical, medians within 1e-12 (fp64) or 1e-6 (fp32). Then
    the port's own lattice end to end: borders, states and polish k-mers
    identical, medians within 1e-12 (fp64) or 2e-3 (fp32, the repo's fp32
    probability bound; lp itself differs by a few fp32 ulp of the ~1e2
    values it is taken from)."""
    b, j, p = bucket, jax_ref[dtype], port[dtype]
    plan = p["plan"]
    T_pad, R, CN, CK = plan.allowed.shape
    N_r, T_r = torch.from_numpy(b["N"]), torch.from_numpy(b["T"])
    lp = torch.from_numpy(j["lp"]).reshape(T_pad, R, 5, CN, CK)
    ch = torch.from_numpy(j["ch"]).reshape(T_pad, R, CN, CK).to(torch.int16)
    start = tnw.start_slots(plan, torch.from_numpy(j["apE"]), N_r, T_r)
    for g, w in zip(start, j["start"]):
        np.testing.assert_array_equal(g.numpy(), w)
    rec, fin = kern.walk(lp, ch, tnb.pred_slots(plan, ch), plan, *start, N_r,
                         T_r, b["K"], A, S, b["S_max"])
    same_in = tnw.finish_records(rec, fin, b["S_max"])
    names = ("seg_cnt", "state", "basepos", "start", "polish", "median", "ovf")
    for out, med_tol in ((same_in, 1e-12 if dtype == "float64" else 1e-6),
                         (p["walk"], 1e-12 if dtype == "float64" else 2e-3)):
        for name, g, w in zip(names, out, j["walk"]):
            if name == "median":
                assert np.abs(g.numpy() - w).max() <= med_tol
            else:
                np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert not out[-1].any() and (out[0] > 0).all()


def test_walk_records_finish_to_summaries(port):
    """finish_records on hand-made records: medians of even and odd
    groups, emission scatter, the overflow flag."""
    S_max = 4
    # (T_pad=3, NM=1, R=1, 8): prob, p_seg, emit, state, bp, start, k, e_seg
    rec = torch.tensor([
        [[[0.5, 0, 1, 0, 7, 2, 11, 0]]],
        [[[0.1, 0, 0, 1, 0, 0, 0, S_max]]],
        [[[0.3, 1, 1, 1, 9, 5, 12, 1]]],
    ], dtype=torch.float64)
    fin = torch.tensor([[2, 0]], dtype=torch.int32)
    cnt, st, bp, start, k, med, ovf = tnw.finish_records(rec, fin, S_max)
    assert cnt.tolist() == [2] and not ovf.any()
    assert st[0, :2].tolist() == [0, 1] and bp[0, :2].tolist() == [7, 9]
    assert start[0, :2].tolist() == [2, 5] and k[0, :2].tolist() == [11, 12]
    assert med[0].tolist() == pytest.approx([0.3, 0.3, 0.0, 0.0])


@pytest.mark.parametrize("caps", [(8, 120), (16, 240)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_bwd_instance_at_engine_caps(caps, itemsize):
    """K13's instance at the engine's caps: the main rung (8, 120) (CK
    128) takes the shared-column instance in fp32 and fp64, the wide rung
    (16, 240) (CK 256) the device-memory one, and each choice's shared
    memory fits the card's 227 KB. The bytes are csrc/ntc_lattice.cu's
    bwd_shared_bytes and bwd_smem, written out: two columns of 5*NC, the
    phase 1 -> 2 scratch (4*NC values, NC flags) and two one-row stages."""
    from dynamont_tpu_torch.models import ntc_batch as engine
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    cn, ck0 = caps
    assert caps in ((8, 120), engine.WIDE_CAPS)
    CN, CK, A = cn, ck0 + cn, 4
    NC = CN * CK
    al = lambda b: -(-b // 16) * 16
    stage = (al((3 * CK + 3 * A * CK + 6 * CN + 2) * itemsize) + al((3 * CN + CK + A * CK) * 4)
             + al(2 * NC) + al(NC + 2 * CN))
    shared = 10 * NC * itemsize + al(4 * NC * itemsize + NC) + 2 * stage
    inst = kern.bwd_instance(CN, CK, A, itemsize)
    assert inst.name == ("shared" if caps == (8, 120) else "device")
    assert inst.nbytes == (shared if inst.name == "shared" else 4 * NC * itemsize + NC)
    assert inst.nbytes <= kern.SMEM_LIMIT == 232448
    assert (shared <= kern.SMEM_LIMIT) == (inst.name == "shared")
    if caps == (8, 120):
        assert inst.nbytes == {4: 85632, 8: 158720}[itemsize]


@pytest.mark.parametrize("caps", [(8, 120), (16, 240), (16, 256)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_pv_instance_at_engine_caps(caps, itemsize):
    """K15's instance at the engine's caps: its main rung (8, 120) (CK
    128) takes the shared-column instance in fp32 and fp64, the wide rungs
    (16, 240) and (16, 256) (CK 256, 272) the device-memory one. The
    bytes are csrc/ntc_lattice.cu's pv_shared_bytes, written out: five
    columns of 5*NC, in fp32 lp (5*NC) and the reduction's 32 + NT values,
    the choice words, and two stages of row inputs (NT = threads(NC): 512
    at CK 128 and 256, 256 at CK 272)."""
    from dynamont_tpu_torch.models import ntc_batch as engine
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops.ntc_pre_kernels import threads

    cn, ck0 = caps
    assert caps in ((8, 120), engine.WIDE_CAPS, engine.BIGK_WIDE_CAPS)
    CN, CK, A = cn, ck0 + cn, 4
    NC = CN * CK
    al = lambda b: -(-b // 16) * 16
    stage = al((3 * CN + CK + A * CK) * 4) + al(2 * NC) + al(NC) + al((3 * CK + 3 * CN + 1) * itemsize)
    norm = 5 * NC * itemsize + al((32 + threads(NC)) * itemsize) if itemsize == 4 else 0
    nbytes = 25 * NC * itemsize + norm + al(2 * NC) + 2 * stage
    inst = kern.pv_instance(CN, CK, A, itemsize)
    assert inst.shared_bytes == nbytes
    assert inst.name == ("shared" if caps == (8, 120) else "device")
    assert (inst.shared_bytes <= kern.SMEM_LIMIT == 232448) == (inst.name == "shared")
    if caps == (8, 120):
        assert inst.shared_bytes == {4: 141856, 8: 224864}[itemsize]

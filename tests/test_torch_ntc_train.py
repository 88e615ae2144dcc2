"""The port's NTC Baum-Welch training at the lattice level (plain versions
of K17 ntc_fwd_store and K18 ntc_train, the training bucket program, the
host functions, the exact rung) against dynamont_tpu, on the CPU.

The JAX package trains NTC buckets only in its Pallas kernels, whose
interpret mode is too slow for a CPU test. So the port is held against:

* JAX's scan-path lattice, on three ragged reads (seeds 0-2, 25/31/18
  bases) in one bucket padded with t_pad_to 64 and n_pad_to 16, caps
  (8, 120): Zf from the forward store's row T_r-1 and Zb from K18's b0
  within rel 1e-12 of JAX's (fp64); the moment sums em (fp64) within
  1e-7*max(1, |x|) of numpy sums over JAX's lp (w = exp(logsumexp over the
  5 states of lp + Zb - Zf): JAX's fp64 lp is normalized by Zb, the
  trainer's w by Zf). The store's row T_r-1, state E, is bit for bit the
  port's pv_plain fwdEf and b0 the port's bwd_plain row 0, in both dtypes
  (one shared recurrence each);
* JAX's host functions trans_from_terms and emissions_from_moments:
  exactly equal on the same arrays, an all--inf normalization group and a
  one-cell k-mer included;
* the port's own exact path: at caps (2, 2) a read overflows and its
  result is run_ntc(mode="train")'s exactly.

The engine and the CLI against JAX's exact path and CLI are in
tests/test_torch_ntc_train_cli.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamont_tpu.constants import NT_TRANSITIONS, NTK_TRANSITIONS
from dynamont_tpu.models import ntc_batch as jax_ntc_batch
from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu.ops import ntc_batch as jnb
from dynamont_tpu.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.models import ntc_batch as torch_ntc_batch
from dynamont_tpu_torch.models.batch import BatchItem
from dynamont_tpu_torch.models.ntc import run_ntc
from dynamont_tpu_torch.ops import ntc_batch as tnb
from dynamont_tpu_torch.ops import ntc_kernels as kern
from dynamont_tpu_torch.ops import ntc_train_kernels as tkern

from tests.synthetic import make_read

CN, CK0, A, S = 8, 120, 4, 5
PAD = dict(t_pad_to=64, n_pad_to=16)
DTYPES = {"float64": torch.float64, "float32": torch.float32}
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
def model():
    return load_model_for_pore("rna002")


@pytest.fixture(scope="module")
def bucket(model):
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
    return dict(sig=sig, kid=kid, T=T, N=N, means=means, c1=c1, c2=c2,
                sd=model.stdevs, K=model.num_kmers)


@pytest.fixture(scope="module")
def jax_lattice(bucket):
    """JAX's fp64 scan path: lp, Zf from fwdE_final, Zb from bwd row 0."""
    b = bucket
    sig, kid = jnp.asarray(b["sig"]), jnp.asarray(b["kid"])
    N_r, T_r = jnp.asarray(b["N"]), jnp.asarray(b["T"])
    mu, c1, c2 = (jnp.asarray(b[k]) for k in ("means", "c1", "c2"))
    dt = jnp.float64
    pn = jnb.pre_tn_batch(sig, kid, N_r, T_r, mu, jnp.asarray(b["sd"]), LM, LE, CN, dt)
    pk = jnb.pre_tk_batch(sig, T_r, mu, c1, c2, LM, LE, A, CK0, dt)
    plan, dims = jnb.build_plan_batch(pn.cand, pn.cnt, pk.cand, pk.cnt, kid, N_r,
                                      mu, c1, c2, A, S, dt)
    sigd = sig.astype(dt)
    bwd = jnb.ntc_backward_batch(plan, dims, sigd, TL, N_r, T_r, S, dt)
    Zb = jnb.ntc_zb_batch(plan, dims, bwd[0])
    lp, _, _, fwdE = jnb.ntc_posterior_viterbi_batch(plan, dims, sigd, bwd, Zb, TL,
                                                     N_r, T_r, S, dt)
    Zf = jnb.ntc_zf_batch(plan, dims, fwdE, N_r, T_r)
    return dict(lp=np.asarray(lp), Zb=np.asarray(Zb), Zf=np.asarray(Zf))


@pytest.fixture(scope="module")
def port(bucket):
    """The port's plain forward store, train sums, backward and pv, per
    dtype."""
    b = bucket
    t = lambda x: torch.from_numpy(np.array(x))
    out = {}
    for name, dtype in DTYPES.items():
        N_r, T_r = t(b["N"]), t(b["T"])
        means, c1, c2 = t(b["means"]), t(b["c1"]), t(b["c2"])
        sig = t(b["sig"])
        pn = tnb.pre_tn_batch(sig, t(b["kid"]), N_r, T_r, means, t(b["sd"]),
                              LM, LE, CN, dtype)
        pk = tnb.pre_tk_batch(sig, T_r, means, c1, c2, LM, LE, A, CK0, dtype)
        plan, dims = tnb.build_plan_batch(pn.cand, pn.cnt, pk.cand, pk.cnt,
                                          t(b["kid"]), N_r, b["K"], A, S,
                                          pn.kn1, pn.kn2)
        prm = kern.tab_gather(tnb.gather_index(plan),
                              tnb.combined_tables(means, c1, c2, A, dtype), dims)
        sig = sig.to(dtype)
        fwd = tkern.fwd_store(plan, dims, prm, sig, TL)
        r = torch.arange(dims.R)
        Zf = tnb.ntc_zf_batch(plan, fwd[T_r.long() - 1, r, tnb.E_ST], N_r, T_r)
        tacc, em, b0 = tkern.train(plan, dims, prm, sig, fwd, Zf, TL, N_r, T_r, b["K"])
        bwd = kern.bwd(plan, dims, prm, sig, TL, N_r, T_r)
        pv = kern.pv(plan, dims, prm, sig, bwd, tnb.ntc_zb_batch(plan, bwd[0]), TL, T_r)
        out[name] = dict(plan=plan, prm=prm, fwd=fwd, Zf=Zf, tacc=tacc, em=em, b0=b0,
                         Zb=tnb.ntc_zb_batch(plan, b0), bwd=bwd, fwdEf=pv[4],
                         T_r=T_r)
    return out


def test_forward_store_zf_matches_jax(jax_lattice, port):
    got, want = port["float64"]["Zf"].numpy(), jax_lattice["Zf"]
    assert np.all(np.abs(got - want) <= 1e-12 * np.abs(want)), (got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_store_row_is_pv_fwdEf(port, dtype):
    p = port[dtype]
    T_r = p["T_r"].long()
    row = p["fwd"][T_r - 1, torch.arange(T_r.numel()), tnb.E_ST]
    assert torch.equal(row, p["fwdEf"])


def test_b0_zb_matches_jax(jax_lattice, port):
    got, want = port["float64"]["Zb"].numpy(), jax_lattice["Zb"]
    assert np.all(np.abs(got - want) <= 1e-12 * np.abs(want)), (got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_b0_is_bwd_row0(port, dtype):
    assert torch.equal(port[dtype]["b0"], port[dtype]["bwd"][0])


def test_moments_match_jax_lp(bucket, jax_lattice, port):
    """em against numpy sums of the posteriors JAX's lp gives, binned by
    each column's live k-slots (the plans agree:
    tests/test_torch_ntc_lattice.py)."""
    p = port["float64"]
    plan = p["plan"]
    T_pad, R, CN_, CK = plan.allowed.shape
    lp = jax_lattice["lp"].reshape(T_pad, R, 5, CN_, CK)
    m = lp.max(axis=2, keepdims=True)
    ms = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        lse = (np.log(np.exp(lp - ms).sum(axis=2, keepdims=True)) + ms)[:, :, 0]
    shift = (jax_lattice["Zb"] - jax_lattice["Zf"])[None, :, None, None]
    allowed = plan.allowed.numpy().copy()
    allowed[0] = False
    w = np.where(allowed, np.exp(lse + shift), 0.0)
    xm = np.concatenate([np.zeros((R, 1)), bucket["sig"]], axis=1).T   # (T_pad, R)
    d = xm[:, :, None] - p["prm"].mu_k.numpy()                          # (T_pad, R, CK)
    want = np.zeros((R, 3, bucket["K"]))
    live, ks = plan.live.numpy(), plan.ks.numpy()
    for q, v in enumerate((w, w * d[:, :, None, :], w * d[:, :, None, :] ** 2)):
        s = v.sum(axis=2)                                               # (T_pad, R, CK)
        for r in range(R):
            np.add.at(want[r, q], ks[:, r][live[:, r]], s[:, r][live[:, r]])
    got = p["em"].numpy()
    assert (got[:, 0] > 0).sum() >= 20 * R
    assert np.all(np.abs(got - want) <= 1e-7 * np.maximum(1.0, np.abs(want)))


def test_train_bucket_program_keeps_kernel_inputs(model):
    """`keep` hands out K17's and K18's inputs and outputs (the smoke run
    holds the kernels to their plain versions on them) without changing
    the bucket's results."""
    items = [BatchItem(*make_read(model, n_bases=n, seed=s))
             for s, n in ((0, 25), (1, 31), (2, 18))]
    eng = torch_ntc_batch.NTCBatchEngine(model, "rna002", device="cpu",
                                         dtype=torch.float64, **PAD)
    keep = {}
    with_keep = eng._train_bucket([0, 1, 2], items, keep=keep)[2]
    without = eng._train_bucket([0, 1, 2], items)[2]
    assert with_keep.keys() == without.keys()
    for name in without:
        np.testing.assert_array_equal(with_keep[name], without[name], err_msg=name)
    k = keep
    args = (k["plan"], k["dims"], k["prm"], k["sig"])
    assert torch.equal(tkern.fwd_store_plain(*args, k["trans_log"]), k["fwd"])
    want = tkern.train_plain(*args, k["fwd"], k["Zf"], k["trans_log"], k["N_r"],
                             k["T_r"], k["K"])
    for name, w in zip(("tacc", "em", "b0"), want):
        assert torch.equal(k[name], w), name


def test_host_functions_match_jax(model):
    """trans_from_terms and emissions_from_moments give JAX's values
    exactly, with an all--inf normalization group ("e3", "p1") and a
    k-mer seen on one cell (its variance a rounding residue)."""
    rng = np.random.default_rng(7)
    terms = rng.normal(-50.0, 5.0, 13)
    terms[list(tnb.TERMS).index("e3")] = terms[list(tnb.TERMS).index("p1")] = -np.inf
    assert torch_ntc_batch.trans_from_terms(terms) == jax_ntc_batch.trans_from_terms(terms)
    K = model.num_kmers
    em = np.zeros((3, K))
    hit = rng.choice(K, 40, replace=False)
    em[0, hit] = rng.uniform(1e-8, 30.0, 40)
    em[1, hit] = em[0, hit] * rng.normal(0.0, 3.0, 40)
    em[2, hit] = em[0, hit] * rng.uniform(1.0, 20.0, 40)
    w, dd = 0.73, 4.1  # one cell: [w, w*d, w*d*d]
    em[:, hit[0]] = (w, w * dd, w * dd * dd)
    got = torch_ntc_batch.emissions_from_moments(em, model)
    assert got == jax_ntc_batch.emissions_from_moments(em, model)
    assert 0 < len(got) < 40


def test_overflow_trains_on_the_exact_path(model):
    """Caps (2, 2) overflow; the read trains on the exact per-read path,
    whose result it then is exactly."""
    s, read = make_read(model, n_bases=25, seed=0)
    eng = torch_ntc_batch.NTCBatchEngine(model, "rna002", device="cpu",
                                         dtype=torch.float64, cap_n=2, cap_k=2,
                                         **PAD)
    got = eng.train([BatchItem(s, read)])[0]
    assert eng.profile["exact_retries"] == 1
    want = run_ntc(s, read, model, "rna002", mode="train", device="cpu")
    assert got == (want.trained_transitions, want.trained_emissions, want.Z)

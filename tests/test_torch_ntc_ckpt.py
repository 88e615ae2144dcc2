"""The native 9-mer pieces of the port's batched NTC pipeline and its
checkpointed wide-rung lattice, on the CPU.

* The checkpointed route (plain K14 ntc_bwd_ckpt and K15's checkpoint
  mode) against the full store (plain K13 and K15) on the short reads at
  the wide rung's caps (16, 240), fp64 and fp32: the checkpoints equal the
  store's rows (c+1)*8, row 0 its row 0, and lp, choices, slots, both
  finals, the walk and the bucket's results equal bit for bit; the engine
  takes that route by itself where CK > 128.
* select_topk's two-stage top-cap (W >= 32768) against JAX's on the
  (4, 65536) cases of tests/test_ntc_batch.py plus a row of exact ties
  within and across blocks: candidates, counts and overflow identical.
* pre_tk_batch_ckpt on a seeded synthetic 7-mer table (K = 16384 > 4096,
  so the big-K group sums run) against JAX's pre_tk_batch_ckpt and the
  port's dense pre_tk_batch: candidates, counts and overflow identical, Zf
  and Zb within rel 1e-12 (fp64) and 1e-6 (fp32, a few ulp: torch's and
  XLA's exp and log differ in the last bit) of JAX's and bit for bit the
  dense route's; with sel_cap below the crossing, identical to JAX's and
  to the full-width selection on every column that does not overflow,
  and overflow flagged on every read with a column whose crossing passes
  sel_cap.
* The port's plan on the 7-mer candidates against JAX's
  build_plan_batch(bigk=True): every integer field identical (from_tk on
  live slots, the only ones `allowed` reads).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamont_tpu.constants import NT_TRANSITIONS
from dynamont_tpu.ops import ntc_batch as jnb
from dynamont_tpu.utils.kmer import seq_to_kmer_ids
from dynamont_tpu.utils.pore_model import PoreModel
from dynamont_tpu_torch.models import ntc_batch as tmb
from dynamont_tpu_torch.models.batch import BatchItem
from dynamont_tpu_torch.models.registry import load_model_for_pore
from dynamont_tpu_torch.ops import ntc_batch as tnb
from dynamont_tpu_torch.ops import ntc_kernels as kern

from tests.synthetic import make_read

DTYPES = {"float64": (torch.float64, jnp.float64),
          "float32": (torch.float32, jnp.float32)}
K7 = 4 ** 7
NT = NT_TRANSITIONS["rna004"]
LM, LE = math.log(NT["m1"]), math.log(NT["e2"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of tiny torch ops, where intra-op
    threads only contend for the cores (and with the other test workers):
    one thread is 2-30x faster here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the checkpointed route against the full store
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wide_runs():
    """dtype -> (full-store keep and results, checkpointed keep and
    results) of one wide-rung bucket of two short reads."""
    model = load_model_for_pore("rna002")
    items = [BatchItem(*make_read(model, n_bases=n, seed=s)) for s, n in ((0, 25), (2, 18))]
    out = {}
    for name, (dtype, _) in DTYPES.items():
        eng = tmb.NTCBatchEngine(model, "rna002", device="cpu", dtype=dtype,
                                 t_pad_to=64, n_pad_to=16)
        runs = []
        for ckpt in (False, None):  # None: the engine's own choice
            keep = {}
            res = eng._dispatch([0, 1], items, *tmb.WIDE_CAPS, keep=keep,
                                ckpt=ckpt)[3]
            runs.append((keep, res))
        out[name] = runs
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ckpt_backward_equals_full_store(wide_runs, dtype):
    (full, _), (ck, _) = wide_runs[dtype]
    assert ck["dims"].CK == 256 > tmb.CKPT_CK and "bwd" not in ck
    store, C = full["bwd"], tnb.C_CKPT
    assert store.shape[0] % C == 0
    want = torch.cat([store[C::C], torch.full_like(store[:1], -math.inf)])
    assert torch.equal(ck["ckpt"], want)
    assert torch.equal(ck["row0"], store[0])
    assert torch.equal(ck["Zb"], full["Zb"])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ckpt_posteriors_equal_full_store(wide_runs, dtype):
    (full, res_f), (ck, res_c) = wide_runs[dtype]
    for name in ("lp", "choices", "slots", "apEf", "fwdEf", "rec", "fin"):
        assert torch.equal(ck[name], full[name]), name
    assert res_f.keys() == res_c.keys()
    for name in res_f:
        assert torch.equal(res_c[name], res_f[name]), name


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ckpt_wrappers_run_plain_on_cpu(wide_runs, dtype):
    """bwd_ckpt and pv_ckpt take their plain versions for CPU tensors and
    count them; their outputs are the bucket program's."""
    _, (ck, _) = wide_runs[dtype]
    args = (ck["plan"], ck["dims"], ck["prm"], ck["sig"], ck["trans_log"])
    runs = dict(kern.PLAIN_RUNS)
    ckpt, row0 = kern.bwd_ckpt(*args, ck["N_r"], ck["T_r"])
    got = kern.pv_ckpt(*args[:4], ckpt, ck["Zb"], ck["trans_log"], ck["N_r"], ck["T_r"])
    assert torch.equal(ckpt, ck["ckpt"]) and torch.equal(row0, ck["row0"])
    for name, g in zip(("lp", "choices", "slots", "apEf", "fwdEf"), got):
        assert torch.equal(g, ck[name]), name
    assert kern.PLAIN_RUNS["ntc_bwd_ckpt"] == runs["ntc_bwd_ckpt"] + 1
    assert kern.PLAIN_RUNS["ntc_pv_ckpt"] == runs["ntc_pv_ckpt"] + 1


# ---------------------------------------------------------------------------
# the two-stage top-cap
# ---------------------------------------------------------------------------

def test_select_topk_bigk_matches_jax():
    rng = np.random.default_rng(1)
    W = 65536
    U = rng.normal(-40, 8, size=(5, W))
    U[0, 100:50000] = -np.inf
    U[1, :] = np.sort(U[1, :])[::-1].copy()  # top values in the low blocks
    U[2, :256] = 50.0 + np.arange(256) * 1e-9  # one block holds the top
    # exact ties: within one block and across blocks whose maxima differ
    U[3, [7, 9, 300, 5000, 40000]] = 30.0
    U[3, [5001, 40001]] = 31.0
    U[4, :] = np.round(U[4, :] / 4) * 4  # many ties everywhere
    live = np.ones(5, bool)
    for cap in (120, 256):
        want = jnb.select_topk(jnp.asarray(U), cap, True, jnp.asarray(live), W)
        got = tnb.select_topk(torch.from_numpy(U), cap, True, torch.from_numpy(live), W)
        for name, g, w in zip(("cand", "cnt", "overflow"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"cap {cap} {name}")


# ---------------------------------------------------------------------------
# the checkpoint-recompute TK pre-pass and the plan at K = 4^7
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bucket7():
    """Two short reads of a seeded synthetic 7-mer table (means U(-2, 2),
    stdevs U(0.15, 0.4), as tests/test_9mer.py builds its 9-mer tables),
    padded as the engine pads with t_pad_to 64 and n_pad_to 16."""
    rng = np.random.default_rng(7)
    model = PoreModel(rng.uniform(-2.0, 2.0, K7), rng.uniform(0.15, 0.4, K7),
                      4, 7, True)
    reads = [make_read(model, n_bases=n, seed=s) for s, n in ((0, 14), (1, 10))]
    kids = [np.asarray(seq_to_kmer_ids(r, 7, 4), np.int32) for _, r in reads]
    T = np.array([len(s) + 1 for s, _ in reads], np.int32)
    N = np.array([len(k) + 1 for k in kids], np.int32)
    T_pad = -(-int(T.max()) // 64) * 64
    N2 = -(-int(N.max()) // 16) * 16
    sig = np.zeros((2, T_pad - 1))
    kid = np.zeros((2, N2 - 1), np.int32)
    for i, ((s, _), k) in enumerate(zip(reads, kids)):
        sig[i, : len(s)] = s
        kid[i, : len(k)] = k
    means, c1, c2 = model.score_params()
    return dict(sig=sig, kid=kid, T=T, N=N, means=means, c1=c1, c2=c2,
                sd=model.stdevs)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tk_args(b, lib):
    conv = jnp.asarray if lib == "jax" else _t
    return (conv(b["sig"]), conv(b["T"]), conv(b["means"]), conv(b["c1"]),
            conv(b["c2"]), LM, LE, 4)


def _pre_tk7(b, dtype, sel_cap):
    tdt, jdt = DTYPES[dtype]
    want = jnb.pre_tk_batch_ckpt(*_tk_args(b, "jax"), 120, jdt, chunk=64,
                                 sel_cap=sel_cap)
    got = tnb.pre_tk_batch_ckpt(*_tk_args(b, "torch"), 120, tdt, chunk=64,
                                sel_cap=sel_cap)
    return got, want


def _same_selection(got, want, what):
    for f in ("cand", "cnt", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what} {f}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pre_tk_ckpt_matches_jax_and_dense(bucket7, dtype):
    got, want = _pre_tk7(bucket7, dtype, None)
    _same_selection(got, want, "against JAX")
    rel = 1e-12 if dtype == "float64" else 1e-6
    for f in ("Zf", "Zb"):
        g, w = getattr(got, f).numpy().astype(np.float64), np.asarray(getattr(want, f))
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, rtol=rel, atol=0, err_msg=f)
    dense = tnb.pre_tk_batch(*_tk_args(bucket7, "torch"), 120, DTYPES[dtype][0])
    for f in dense._fields:
        a, b = getattr(got, f), getattr(dense, f)
        assert (a is None and b is None) or torch.equal(a, b), f


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pre_tk_ckpt_sel_cap(bucket7, dtype):
    """sel_cap 3 lies below the crossing of some columns: JAX's result
    exactly; equal to the full-width selection wherever the crossing lies
    within sel_cap; overflow on the reads where it does not."""
    sel = 3
    got, want = _pre_tk7(bucket7, dtype, sel)
    _same_selection(got, want, "against JAX")
    full, _ = _pre_tk7(bucket7, dtype, None)
    within = full.cnt <= sel
    beyond = ~within & (full.cnt > 0)
    assert beyond.any() and within.any()
    assert torch.equal(got.cnt[within], full.cnt[within])
    assert torch.equal(got.cand[within], full.cand[within])
    assert (got.cnt[beyond] == sel).all()
    assert (got.cand[:, :, sel:] == K7).all()
    assert torch.equal(got.overflow, full.overflow | beyond.any(dim=0))
    assert torch.equal(got.Zf, full.Zf) and torch.equal(got.Zb, full.Zb)


def test_plan_matches_jax_bigk(bucket7):
    """The port's plan (sort + binary search, no (T, K+1) table) against
    JAX's big-K plan (slot-level eq-broadcasts), fp64, both from their own
    package's pre-pass candidates (identical, checked first)."""
    b = bucket7
    CN, CK0 = 8, 120
    jp = (jnp.asarray(b["sig"]), jnp.asarray(b["kid"]), jnp.asarray(b["N"]),
          jnp.asarray(b["T"]))
    jn = jnb.pre_tn_batch(*jp, jnp.asarray(b["means"]), jnp.asarray(b["sd"]), LM,
                          LE, CN, jnp.float64)
    jk = jnb.pre_tk_batch_ckpt(*_tk_args(b, "jax"), CK0, jnp.float64, chunk=64,
                               sel_cap=48)
    mu, c1, c2 = (jnp.asarray(b[k]) for k in ("means", "c1", "c2"))
    plan_j, dims_j = jnb.build_plan_batch(jn.cand, jn.cnt, jk.cand, jk.cnt, jp[1],
                                          jp[2], mu, c1, c2, 4, 7, jnp.float64,
                                          bigk=True)
    tp = (_t(b["sig"]), _t(b["kid"]), _t(b["N"]), _t(b["T"]))
    tn = tnb.pre_tn_batch(*tp, _t(b["means"]), _t(b["sd"]), LM, LE, CN, torch.float64)
    tk = tnb.pre_tk_batch_ckpt(*_tk_args(b, "torch"), CK0, torch.float64,
                               chunk=64, sel_cap=48)
    for f in ("cand", "cnt"):
        np.testing.assert_array_equal(getattr(tn, f).numpy(), np.asarray(getattr(jn, f)))
    _same_selection(tk, jk, "TK")
    plan, dims = tnb.build_plan_batch(tn.cand, tn.cnt, tk.cand, tk.cnt, tp[1],
                                      tp[2], K7, 4, 7, tn.kn1, tn.kn2)
    assert tuple(dims) == tuple(dims_j)
    T, R, CK = plan.ks.shape
    want = {f: np.asarray(getattr(plan_j, f)) for f in plan_j._fields}
    live = want["live"].reshape(T, R, CK)
    assert live.any()
    for f in ("cand_n", "cnt_n", "ks", "live", "allowed", "kN", "kN2", "d01",
              "d02", "row_same", "row_prev", "brow_same", "brow_next",
              "col_same", "col_prec", "bcol_same", "bcol_suc"):
        got = getattr(plan, f).numpy()
        np.testing.assert_array_equal(got, want[f].reshape(got.shape), err_msg=f)
    np.testing.assert_array_equal(plan.from_tk.numpy() & live,
                                  want["from_tk"].reshape(T, R, CK) & live)
    hd = plan.hd.numpy().astype(np.int32)
    for sh, f in zip((0, 4, 8, 12), ("hd1", "hd2", "hd1s", "hd2s")):
        np.testing.assert_array_equal((hd >> sh) & 15, want[f].reshape(hd.shape),
                                      err_msg=f)


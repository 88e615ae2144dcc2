"""The port's probes of K13 (ops/ntc_probe_kernels.py, probes/) against the
JAX package's TPU probes, on the CPU.

* synth_inputs is reproducible from its seed and passes the wrappers'
  checks: ascending n-slot candidates, maps in range, hd nibbles within
  the k-mer length, digits in [0, A), c2 > 0, reads at full length.
* bwd_variant_plain in reverse order, at every C and both stores, equals
  plain K13 (ntc_kernels.bwd_plain) bit for bit on
  tests/test_torch_ntc_lattice.py's bucket, and JAX's scan path
  (ops/ntc_batch.ntc_backward_batch) within that file's bound: fp64
  1e-12*max(1, |x|), fp32 5e-4, -inf at the same cells.
* The forward order visits the rows as stated (recorded, not compared:
  its values are wrong by design).
* Each of the TPU probe's 15 blocks: microop_plain at ITERS 4 against
  run_block's body rebuilt here from ntc_pallas's helpers and run by
  Pallas in interpret mode, on the input tile the block's branches need.
  Exact, except the blocks that take exp, log or log1p (the affine
  chains, the 13-term lse): within 8 ulps of max(1, |x|), for XLA's and
  torch's CPU transcendentals differ in the last bit (measured: 1.7).
* The card-form blocks against their own definitions.
* slow: JAX's _bwd_kernel in interpret mode under each C, in reverse order
  (the scripts' variant_bwd with today's five inputs), against the port's
  plain variant through _to_kernel_layout within 5e-4, on 16 reads whose
  plans hold the same TK candidates in the same slots.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dynamont_tpu.constants import NT_TRANSITIONS, NTK_TRANSITIONS
from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu.ops import ntc_batch as jnb
from dynamont_tpu.ops import ntc_pallas as npk
from dynamont_tpu.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.ops import ntc_batch as tnb
from dynamont_tpu_torch.ops import ntc_kernels as kern
from dynamont_tpu_torch.ops import ntc_probe_kernels as pk
from dynamont_tpu_torch.probes import ALL_VARIANTS, variant_kwargs
from dynamont_tpu_torch.probes.ntc_bwd_synth import synth_inputs

from tests.synthetic import make_read

CN, CK0, A, S = 8, 120, 4, 5
DTYPES = {"float64": (torch.float64, jnp.float64),
          "float32": (torch.float32, jnp.float32)}
NT = NT_TRANSITIONS["rna002"]
LM, LE = math.log(NT["m1"]), math.log(NT["e2"])
TL = {k: math.log(v) for k, v in NTK_TRANSITIONS["rna002"].items()}
ITERS = 4
TRANSCENDENTAL = ("affine_chain_up", "affine_chain_down", "lse_13_terms")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of tiny torch ops: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# synth_inputs
# ---------------------------------------------------------------------------

SYNTH_DIMS = tnb.PlanDims(2, CN, CN + CK0, A)


def _fields(inp):
    return [*inp.plan, *inp.prm, inp.sig, inp.N_r, inp.T_r]


def test_synth_inputs_reproducible_and_valid():
    a = synth_inputs(64, 1024, SYNTH_DIMS, seed=3)
    b = synth_inputs(64, 1024, SYNTH_DIMS, seed=3)
    c = synth_inputs(64, 1024, SYNTH_DIMS, seed=4)
    assert all(torch.equal(x, y) for x, y in zip(_fields(a), _fields(b)))
    assert not torch.equal(a.sig, c.sig) and not torch.equal(a.plan.ks, c.plan.ks)
    assert a.dims == SYNTH_DIMS and a.trans_log == TL
    assert kern._check_bwd_inputs("probe", a.plan, a.dims, a.prm, a.sig, a.N_r,
                                  a.T_r) == 64
    p = a.plan
    assert (p.cand_n[..., 1:] > p.cand_n[..., :-1]).all()
    for f in ("row_same", "row_prev", "brow_same", "brow_next"):
        x = getattr(p, f)
        assert ((x >= -1) & (x < CN)).all(), f
    for f in ("col_same", "col_prec", "bcol_same", "bcol_suc"):
        x = getattr(p, f)
        assert ((x >= -1) & (x < CN + CK0)).all(), f
    assert p.allowed.dtype == torch.bool and p.allowed.any()
    h = p.hd.to(torch.int32)
    for sh in (0, 4, 8, 12):
        assert (((h >> sh) & 15) <= S).all()
    assert ((p.d01 >= 0) & (p.d01 < A)).all() and ((p.d02 >= 0) & (p.d02 < A)).all()
    live = p.live
    assert (a.prm.c2_k[live] > 0).all() and (a.prm.nsl[:, 2] > 0).all()
    assert (a.T_r == 64).all() and (a.N_r == max(2 * CN, 64 // 8)).all()
    # the lattice these inputs make has live cells to the first row
    store = pk.bwd_variant_plain(*a, C=8)
    assert torch.isfinite(store[0]).any()


def test_stage_bytes_and_fit():
    dims = tnb.PlanDims(16, CN, CN + CK0, A)
    per_row = pk.stage_bytes(dims, 8) / 8
    assert 13600 < per_row < 13640  # suc 6144, hd 2048, bcol_suc 2048, ...
    assert pk.smem_bytes(dims, 8, False) == 17408  # K13's own
    assert pk.smem_bytes(dims, 4, True) <= pk.SMEM_LIMIT
    assert pk.smem_bytes(dims, 8, True) <= pk.SMEM_LIMIT
    assert pk.smem_bytes(dims, 16, True) > pk.SMEM_LIMIT


def test_forward_order_visits_rows_as_stated(monkeypatch):
    assert pk.row_order(32, 8, True) == list(range(31, -1, -1))
    fwd = pk.row_order(32, 8, False)
    assert fwd == [c * 8 + i for c in range(4) for i in range(7, -1, -1)]
    seen = []
    column = tnb._bwd_column

    def record(plan, dims, rows, tl, t, nxt, Nm1, **kw):
        seen.append(t)
        return column(plan, dims, rows, tl, t, nxt, Nm1, **kw)

    monkeypatch.setattr(tnb, "_bwd_column", record)
    inp = synth_inputs(32, 1024, SYNTH_DIMS, seed=0)
    for C, reverse in ((8, False), (4, False), (16, True)):
        seen.clear()
        pk.bwd_variant_plain(*inp, C=C, reverse=reverse)
        assert seen == pk.row_order(32, C, reverse)


@pytest.mark.parametrize("reverse", (True, False))
def test_plain_rows_restart_from_a_stored_row(reverse):
    """What chip_smoke.same_steps relies on: rows recomputed from the row
    stored before them equal the whole run's."""
    inp = synth_inputs(32, 1024, SYNTH_DIMS, seed=0)
    full = pk.bwd_variant_plain(*inp, C=8, reverse=reverse)
    order = pk.row_order(32, 8, reverse)
    got = dict(pk.plain_rows(*inp, order[:8]))
    for k in (1, 2, 3):  # the forward order's rows are finite in its last chunk only
        rows = order[8 * k:8 * k + 8]
        step = dict(pk.plain_rows(*inp, rows, full[order[8 * k - 1]]))
        assert list(step) == rows
        got.update(step)
    assert sorted(got) == list(range(32))
    assert all(torch.equal(full[t], row) for t, row in got.items())
    assert torch.isfinite(full[order[-1]]).any()


@pytest.mark.parametrize("argv", (["ntc_bwd_synth", "64"], ["ntc_bwd_variants", "200"],
                                  ["ntc_microops"]))
def test_probe_clis_exit_without_a_card(monkeypatch, argv):
    import importlib

    from dynamont_tpu_torch.cli._protocol import NO_CUDA_EXIT

    mod = importlib.import_module(f"dynamont_tpu_torch.probes.{argv[0]}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        mod.main([*argv[1:], "--device", "cuda"])
    assert e.value.code == NO_CUDA_EXIT


def test_microops_cli_reads_micro_iters(monkeypatch):
    from dynamont_tpu_torch.probes import ntc_microops

    seen = {}
    monkeypatch.setattr(ntc_microops, "run",
                        lambda iters, device, log: seen.update(iters=iters, device=device))
    monkeypatch.setenv("MICRO_ITERS", "3")
    assert ntc_microops.main(["--device", "cpu"]) == 0
    assert seen == {"iters": 3, "device": torch.device("cpu")}


def test_wrappers_take_cpu_or_cuda_only():
    inp = synth_inputs(32, 1024, SYNTH_DIMS, seed=0)
    pk.reset_counts()
    pk.bwd_variant(*inp, C=8, store="none")
    x, aux = (torch.from_numpy(v) for v in pk.micro_inputs(0))
    pk.microop("noop", x, aux, 2)
    assert pk.PLAIN_RUNS == {"ntc_bwd_variant": 1, "ntc_microop": 1}
    assert not any(pk.LAUNCHES.values())
    with pytest.raises(ValueError, match="cuda or cpu"):
        pk.microop("noop", x.to("meta"), aux.to("meta"), 2)
    with pytest.raises(ValueError, match="nt"):
        pk.bwd_variant(*inp, C=8, nt=64)
    with pytest.raises(ValueError, match="multiple"):
        pk.bwd_variant(*inp, C=5)


def test_variant_table():
    assert set(ALL_VARIANTS) >= {"prod", "rev", "fwd", "c4", "c16", "none"}
    assert variant_kwargs("prod") == dict(C=8, stage=False, reverse=True, nt=512,
                                          store="full")
    for name in ALL_VARIANTS:
        kw = variant_kwargs(name)
        assert kw["nt"] in pk.THREADS and kw["store"] in pk.STORES


# ---------------------------------------------------------------------------
# bwd_variant_plain on the lattice tests' bucket, against K13 and JAX
# ---------------------------------------------------------------------------

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
    return dict(sig=sig, kid=kid, T=T, N=N, means=means, c1=c1, c2=c2,
                sd=model.stdevs, K=model.num_kmers)


@pytest.fixture(scope="module")
def jax_bwd(bucket):
    """JAX's scan-path backward store, for each dtype."""
    b = bucket
    out = {}
    for name, (_, jdt) in DTYPES.items():
        sig, kid = jnp.asarray(b["sig"]), jnp.asarray(b["kid"])
        N_r, T_r = jnp.asarray(b["N"]), jnp.asarray(b["T"])
        mu, c1, c2 = (jnp.asarray(b[k]) for k in ("means", "c1", "c2"))
        pn = jnb.pre_tn_batch(sig, kid, N_r, T_r, mu, jnp.asarray(b["sd"]),
                              LM, LE, CN, jdt)
        pk_ = jnb.pre_tk_batch(sig, T_r, mu, c1, c2, LM, LE, A, CK0, jdt)
        plan, dims = jnb.build_plan_batch(pn.cand, pn.cnt, pk_.cand, pk_.cnt,
                                          kid, N_r, mu, c1, c2, A, S, jdt)
        out[name] = np.asarray(jnb.ntc_backward_batch(
            plan, dims, sig.astype(jdt), TL, N_r, T_r, S, jdt))
    return out


@pytest.fixture(scope="module")
def port(bucket):
    """The port's K13 inputs and plain K13 store, for each dtype."""
    b = bucket
    t = lambda x: torch.from_numpy(np.array(x))
    out = {}
    for name, (dtype, _) in DTYPES.items():
        N_r, T_r = t(b["N"]), t(b["T"])
        means, c1, c2 = t(b["means"]), t(b["c1"]), t(b["c2"])
        sig = t(b["sig"])
        pn = tnb.pre_tn_batch(sig, t(b["kid"]), N_r, T_r, means, t(b["sd"]),
                              LM, LE, CN, dtype)
        pk_ = tnb.pre_tk_batch(sig, T_r, means, c1, c2, LM, LE, A, CK0, dtype)
        plan, dims = tnb.build_plan_batch(
            pn.cand, pn.cnt, pk_.cand, pk_.cnt, t(b["kid"]), N_r, b["K"], A, S,
            pn.kn1, pn.kn2)
        table = tnb.combined_tables(means, c1, c2, A, dtype)
        prm = kern.tab_gather(tnb.gather_index(plan), table, dims)
        inp = (plan, dims, prm, sig.to(dtype), TL, N_r, T_r)
        out[name] = dict(inp=inp, k13=kern.bwd_plain(*inp), variants={})
    return out


def _variant(port, dtype, C, store):
    got = port[dtype]["variants"].get((C, store))
    if got is None:
        got = pk.bwd_variant_plain(*port[dtype]["inp"], C=C, store=store)
        port[dtype]["variants"][(C, store)] = got
    return got


@pytest.mark.parametrize("store", pk.STORES)
@pytest.mark.parametrize("C", (4, 8, 16))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_reverse_variant_equals_k13(port, dtype, C, store):
    got = _variant(port, dtype, C, store)
    want = port[dtype]["k13"]
    assert torch.equal(got, want if store == "full" else want[0])


def _close(got, want, dtype):
    got = got.numpy().astype(np.float64).reshape(want.shape)
    want = want.astype(np.float64)
    assert np.array_equal(np.isneginf(got), np.isneginf(want)), "-inf patterns differ"
    fin = np.isfinite(want)
    d = np.abs(got[fin] - want[fin])
    tol = 1e-12 * np.maximum(1.0, np.abs(want[fin])) if dtype == "float64" else 5e-4
    assert np.all(d <= tol), d.max()


@pytest.mark.parametrize("store", pk.STORES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_reverse_variant_matches_jax(port, jax_bwd, dtype, store):
    want = jax_bwd[dtype]
    got = _variant(port, dtype, 8, store)
    if store == "none":
        want = want[:1]
        got = got[None]
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# #21: the TPU probe's blocks, and the card's forms
# ---------------------------------------------------------------------------

def _mk_ks(a):
    return jnp.where(a[:npk.CK, :npk.R] > -1.0,
                     jnp.abs(a[:npk.CK, :npk.R] * 100.0) % 1024.0, -1.0)


def _rg2(v, a):
    g = npk._row_gather(a[:, 0:1], [v, v * 0.5])
    return g[0] + g[1]


def _rg5(v, a):
    g = npk._row_gather(a[:, 0:1], [v, v, v, v, v])
    return sum(g)


def _cg4(v, a):
    ksT = _mk_ks(a)
    ks_cur = a[:npk.R, :npk.CK] % 1024.0
    same, suc = npk._col_gather(
        [v, v * 0.5, v * 0.25, v * 2.0], ksT,
        npk._dst_vals(ks_cur, 1024, "same"), npk._dst_vals(ks_cur, 1024, "suc"))
    return same[0] + suc[3][:, :npk.CK]


def _cg16(v, a):
    ksT = _mk_ks(a)
    ks_cur = a[:npk.R, :npk.CK] % 1024.0
    blocks = [v * (0.9 + 0.01 * i) for i in range(16)]
    same, suc, cs, _ = npk._col_gather(
        blocks, ksT, npk._dst_vals(ks_cur, 1024, "same"),
        npk._dst_vals(ks_cur, 1024, "prec"), want_slots=True)
    return same[0] + suc[15][:, :npk.CK] + npk._exp16(npk._expand16(), cs)


def _unpack(v, a):
    h1, h2, h3, h4 = npk._unpack_hd(a.astype(jnp.int16))
    return v + h1 + h2 + h3 + h4


# scripts/probe_ntc_microops.py's blocks (main), in its order
JAX_BLOCKS = {
    "noop": lambda v, a: v,
    "roll_up_1": lambda v, a: pltpu.roll(v, 1, axis=0),
    "roll_up_4": lambda v, a: pltpu.roll(v, 4, axis=0),
    "roll_down_127": lambda v, a: pltpu.roll(v, 127, axis=0),
    "roll_down_124": lambda v, a: pltpu.roll(v, 124, axis=0),
    "roll_lane_1": lambda v, a: pltpu.roll(v, 1, axis=1),
    "affine_chain_up": lambda v, a: npk._affine_chain(v, a, True, False),
    "affine_chain_down": lambda v, a: npk._affine_chain(v, a, False, False),
    "row_gather_x2": _rg2,
    "row_gather_x5": _rg5,
    "col_gather_L4": _cg4,
    "col_gather_L16+slots": _cg16,
    "lse_13_terms": lambda v, a: npk._lse([v + 0.01 * i for i in range(13)]),
    "unpack_hd": _unpack,
    "transpose_24x128": lambda v, a: v + jnp.transpose(a[:24, :]).sum(axis=1, keepdims=True),
}


def _run_block(body_fn, x, aux):
    """scripts/probe_ntc_microops.run_block's kernel, in interpret mode."""
    def kernel(x_ref, aux_ref, o_ref):
        def body(i, v):
            return body_fn(v, aux_ref[...]) * 0.999
        o_ref[...] = jax.lax.fori_loop(0, ITERS, body, x_ref[...])

    f = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((npk.RC, npk.CK), jnp.float32),
                       interpret=True)
    return np.asarray(f(jnp.asarray(x), jnp.asarray(aux)))


def test_jax_blocks_are_the_ported_ones():
    assert tuple(JAX_BLOCKS) == pk.MICRO_TPU
    assert (npk.RC, npk.CK, npk.R, npk.CN, npk.A) == (pk.M_RC, pk.M_CK, pk.M_R,
                                                      pk.M_CN, pk.M_A)


@pytest.mark.parametrize("block", pk.MICRO_TPU)
def test_microop_plain_matches_jax_block(block):
    x, aux = pk.micro_inputs(0, pk.MICRO_KIND.get(block, "normal"))
    want = _run_block(JAX_BLOCKS[block], x, aux)
    got = pk.microop_plain(block, torch.from_numpy(x), torch.from_numpy(aux),
                           ITERS).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert fin.sum() > 1000  # the block's values, not only its -inf branch
    if block in TRANSCENDENTAL:
        tol = 8 * np.finfo(np.float32).eps * np.maximum(1.0, np.abs(want[fin]))
        assert np.all(np.abs(got[fin].astype(np.float64) - want[fin]) <= tol)
    else:
        assert np.array_equal(got, want)


def _tiles(kind="normal"):
    return [torch.from_numpy(v) for v in pk.micro_inputs(1, kind)]


def test_gat_slot_map_is_indexing():
    x, aux = _tiles("rows")
    got = pk.microop_plain("gat_slot_map", x, aux, 1)
    a = aux.numpy()
    v = x.numpy()
    rmap = np.clip(np.floor(a[:, 0]), -1, CN - 1).astype(int)
    cmap = np.clip(np.floor(a[:16] * np.float32(16)), -1, 127).astype(int)
    want = np.full((128, 128), -np.inf, np.float32)
    for m in range(128):
        r = m // CN
        for j in range(128):
            if rmap[m] >= 0 and cmap[r, j] >= 0:
                want[m, j] = v[r * CN + rmap[m], cmap[r, j]] * np.float32(0.999)
    assert (rmap >= 0).any() and (rmap < 0).any() and (cmap < 0).any()
    assert np.array_equal(got.numpy(), want)


def test_ichain_fold_is_the_sequential_chain():
    x, aux = _tiles()
    got = pk.ichain_fold(x, aux).numpy().astype(np.float64)
    v, b = x.numpy().astype(np.float64), aux.numpy().astype(np.float64)
    want = v.copy()
    for m in range(128):
        i = m % CN
        if i == CN - 1:
            continue
        # the chain from row m down to its read's last row, in closed form
        terms = [v[m]]
        acc = np.zeros(128)
        for k in range(i + 1, CN):
            acc = acc + b[m + k - i - 1]
            terms.append(v[m + k - i] + acc)
        want[m] = np.logaddexp.reduce(terms, axis=0)
    assert np.allclose(got, want, rtol=1e-5, atol=1e-5)
    # the doubling scan computes the same chain up to rounding
    scan = pk.affine_chain(x, aux, up=False).numpy().astype(np.float64)
    tol = 8 * np.finfo(np.float32).eps * np.maximum(1.0, np.abs(scan))
    assert np.all(np.abs(got - scan) <= tol)


def test_sc_score_is_the_emission_formula():
    x, aux = _tiles()
    got = pk.microop_plain("sc_score", x, aux, 1).numpy()
    d = x.numpy() - aux.numpy()
    want = (np.float32(pk.SC_C1) - (np.float32(pk.SC_C2) * d) * d) * np.float32(0.999)
    assert np.array_equal(got, want)


def test_sync_pair_and_noop_only_decay():
    x, aux = _tiles()
    want = x.numpy()
    for _ in range(ITERS):
        want = want * np.float32(0.999)
    for block in ("noop", "sync_pair"):
        assert np.array_equal(pk.microop_plain(block, x, aux, ITERS).numpy(), want)


# ---------------------------------------------------------------------------
# slow: JAX's _bwd_kernel under each C, interpret mode
# ---------------------------------------------------------------------------

def _variant_bwd(packs, trans_log, *, C, reverse):
    """scripts/probe_ntc_bwd_synth.variant_bwd with today's five inputs
    (nrow, kcol, suc, alw, hd) and interpret mode."""
    T_pad = packs.T_pad
    nc = T_pad // C
    tl = {k: np.float32(v) for k, v in trans_log.items()}
    kernel = functools.partial(npk._bwd_kernel, C=C, nc=nc, tl=tl, K=packs.K)
    ix = (lambda c: nc - 1 - c) if reverse else (lambda c: c)
    vm = pltpu.VMEM
    return pl.pallas_call(
        kernel,
        grid=(nc,),
        in_specs=[
            pl.BlockSpec((C, npk.NS, npk.RC), lambda c: (ix(c), 0, 0), memory_space=vm),
            pl.BlockSpec((C, npk.NKS, npk.R, npk.CK), lambda c: (ix(c), 0, 0, 0),
                         memory_space=vm),
            pl.BlockSpec((C, npk.NSS, npk.R, npk.ACK), lambda c: (ix(c), 0, 0, 0),
                         memory_space=vm),
            pl.BlockSpec((C, npk.RC, npk.CK), lambda c: (ix(c), 0, 0), memory_space=vm),
            pl.BlockSpec((C, npk.RC, npk.CK), lambda c: (ix(c), 0, 0), memory_space=vm),
        ],
        out_specs=pl.BlockSpec((C, 5 * npk.RC, npk.CK), lambda c: (ix(c), 0, 0),
                               memory_space=vm),
        out_shape=jax.ShapeDtypeStruct((T_pad, 5 * npk.RC, npk.CK), jnp.float32),
        scratch_shapes=[pltpu.VMEM((npk.RC, npk.CK), jnp.float32) for _ in range(5)],
        interpret=True,
    )(packs.nrow, packs.kcol, packs.suc, packs.alw, packs.hd)


@pytest.mark.slow
def test_jax_variant_kernel_matches_port_variant():
    from tests.test_ntc_pallas import _cmp, _to_kernel_layout

    model = load_model_for_pore("rna002")
    # both packages read the tables in float32, as JAX's kernel suite does
    means, sd, c1, c2 = (np.asarray(v, np.float32)
                         for v in (*model.score_params()[:1], model.stdevs,
                                   *model.score_params()[1:]))
    R = npk.R
    sigs, kids = [], []
    for s in range(R):
        sig, read = make_read(model, n_bases=20 + (s % 3) * 5, seed=s)
        sigs.append(sig)
        kids.append(np.asarray(seq_to_kmer_ids(read, S, A), np.int32))
    T_arr = np.array([len(s) + 1 for s in sigs], np.int32)
    N_arr = np.array([len(k) + 1 for k in kids], np.int32)
    T_pad = -(-int(T_arr.max()) // 32) * 32
    N2 = -(-int(N_arr.max()) // 16) * 16
    sigp = np.zeros((R, T_pad - 1), np.float32)
    kidp = np.zeros((R, N2 - 1), np.int32)
    for j in range(R):
        sigp[j, : T_arr[j] - 1] = sigs[j]
        kidp[j, : N_arr[j] - 1] = kids[j]
    f32 = jnp.float32
    mt, sdt, c1t, c2t = (jnp.asarray(v) for v in (means, sd, c1, c2))
    sigj, kidj = jnp.asarray(sigp), jnp.asarray(kidp)
    T_r, N_r = jnp.asarray(T_arr), jnp.asarray(N_arr)
    pn = jnb.pre_tn_batch(sigj, kidj, N_r, T_r, mt, sdt, LM, LE, CN, f32)
    pk_ = jnb.pre_tk_batch(sigj, T_r, mt, c1t, c2t, LM, LE, A, CK0, f32)
    plan, dims = jnb.build_plan_batch(pn.cand, pn.cnt, pk_.cand, pk_.cnt, kidj, N_r,
                                      mt, c1t, c2t, A, S, f32)
    packs = npk.build_kernel_packs(plan, dims, sigj, N_r, T_r, model.num_kmers)

    t = torch.from_numpy
    mean_t, c1_t, c2_t = t(means), t(c1), t(c2)
    pn_t = tnb.pre_tn_batch(t(sigp), t(kidp), t(N_arr), t(T_arr), mean_t, t(sd), LM,
                            LE, CN, torch.float32)
    pk_t = tnb.pre_tk_batch(t(sigp), t(T_arr), mean_t, c1_t, c2_t, LM, LE, A, CK0,
                            torch.float32)
    # the same TK candidates in the same slots: in fp32 one of these rows
    # orders two near-tied candidates the other way in the port's pre-pass
    cand_k = np.asarray(pk_.cand)
    assert all(set(a) == set(b) for a, b in zip(cand_k.reshape(-1, CK0),
                                                pk_t.cand.numpy().reshape(-1, CK0)))
    plan_t, dims_t = tnb.build_plan_batch(
        pn_t.cand, pn_t.cnt, t(cand_k.astype(np.int32)),
        t(np.asarray(pk_.cnt).astype(np.int32)), t(kidp), t(N_arr), model.num_kmers, A,
        S, pn_t.kn1, pn_t.kn2)
    table = tnb.combined_tables(mean_t, c1_t, c2_t, A, torch.float32)
    prm = kern.tab_gather(tnb.gather_index(plan_t), table, dims_t)
    port = pk.bwd_variant_plain(plan_t, dims_t, prm, t(sigp), TL, t(N_arr), t(T_arr),
                                C=8)
    want = _to_kernel_layout(port.numpy().reshape(T_pad, R, -1), 5)
    for C in (4, 8, 16):
        got = np.asarray(_variant_bwd(packs, TL, C=C, reverse=True))
        _cmp(got, want)

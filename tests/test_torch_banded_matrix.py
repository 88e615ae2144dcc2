"""The port's matrix route (plain versions of K5 -> K1 -> K4, the host walk,
BandedBatchEngine(device_pipeline=False)) against the JAX package's
bb.banded_batch_run and its Pallas _vit_kernel, on the CPU.

Bounds. fp64, on rows t < T_r (JAX leaves later rows unspecified):
choices identical, PM/PE within 1e-12, Zf/Zb rel 1e-12; the engine at
tests/test_nt_banded_batch.py's bounds (segments identical, medians 1e-6,
Z rel 1e-12). fp32: choices identical in at least 99.9 % of live cells and
posteriors within 1e-3 in log space (tests/test_pallas_kernels.py:70-90:
torch's and XLA's exp/log1p differ in the last bit), PM/PE within 2e-3,
borders identical. The matrix route against the device route on signals
snapped to the int16 wire grid: borders identical.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamont_tpu import native as jax_native
from dynamont_tpu.models.batch import BandedBatchEngine as JaxEngine
from dynamont_tpu.models.batch import BatchItem as JaxItem
from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu.ops import nt_banded_batch as jbb
from dynamont_tpu.ops import nt_banded_pallas as pk
from dynamont_tpu.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.models.batch import BandedBatchEngine, BatchItem
from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops import nt_banded_device as dv
from dynamont_tpu_torch.ops import nt_banded_kernels as kk

from tests.synthetic import make_read

M1, E2 = 0.019889650396799997, 0.9801103496029998
LM, LE = math.log(M1), math.log(E2)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "fp64": (jnp.float64, torch.float64)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of tiny torch ops, where intra-op
    threads only contend for the cores: one thread is faster here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def _reads(model, n_reads=4, base_len=40):
    """tests/test_nt_banded_batch.py's _items."""
    return [make_read(model, n_bases=base_len + 13 * s, seed=s)
            for s in range(n_reads)]


@pytest.fixture(scope="module")
def batches(model):
    """The short reads as one padded batch of each package, per dtype."""
    reads = _reads(model)
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size)
            for _, r in reads]
    sigs = [s for s, _ in reads]
    return {name: (jbb.prepare_batch(sigs, kids, model.means, model.stdevs,
                                     dtype=jdt),
                   bb.prepare_batch(sigs, kids, model, device="cpu", dtype=tdt))
            for name, (jdt, tdt) in DTYPES.items()}


@pytest.fixture(scope="module", params=["fp32", "fp64"])
def runs(request, batches):
    """One batch of the short reads through both packages' banded_batch_run."""
    jb, tb = batches[request.param]
    want = jbb.make_banded_batch_fn(M1, E2)(jb)
    kk.reset_counts()
    got = bb.make_banded_batch_fn(M1, E2)(tb)
    plain = {k: kk.PLAIN_RUNS[k] for k in kk.MATRIX_KERNELS}
    return request.param, jb, tb, want, got, plain


def _live(x, T):
    return [np.asarray(x)[i, : int(t)] for i, t in enumerate(T)]


def test_batch_run_matches_jax(runs, model):
    name, jb, tb, want, got, plain = runs
    assert plain == dict.fromkeys(kk.MATRIX_KERNELS, 1)
    T = np.asarray(jb.T)
    rel = 1e-12 if name == "fp64" else 1e-6
    np.testing.assert_allclose(got.Zf.numpy(), np.asarray(want.Zf), rtol=rel)
    np.testing.assert_allclose(got.Zb.numpy(), np.asarray(want.Zb), rtol=rel)
    ch_g, ch_w = _live(got.choices, T), _live(want.choices, T)
    for a, b in zip(ch_g, ch_w):
        if name == "fp64":
            np.testing.assert_array_equal(a, b)
        else:
            assert (a == b).mean() >= 0.999
    atol = 1e-12 if name == "fp64" else 2e-3
    for f in ("PM", "PE"):
        for a, b in zip(_live(getattr(got, f), T), _live(getattr(want, f), T)):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    if name == "fp32":  # borders after the host walk
        args = (np.asarray(jb.bstart), T, np.asarray(jb.N), np.asarray(jb.bw))
        segs_g = bb.traceback_batch(got, *args, model.kmer_size)
        segs_w = jax_native.banded_traceback_batch(
            np.asarray(want.choices), np.asarray(want.PM), np.asarray(want.PE),
            *args, model.kmer_size)
        assert [[s[1:3] for s in r] for r in segs_g] \
            == [[s[1:3] for s in r] for r in segs_w]


def test_viterbi_post_matches_pallas_vit_kernel(batches):
    """Plain K4 against JAX's _vit_kernel (fp32 only) in interpret mode on
    the same stored rows, at tests/test_pallas_kernels.py's bounds."""
    jb, tb = batches["fp32"]
    fM, fE = bb.forward(tb, LM, LE)
    bM, bE = bb.backward(tb, LM, LE)
    r = torch.arange(fM.shape[0])
    Zb = bE[r, 0, tb.bw.long() + 1]
    ch, LPM, LPE = kk.viterbi_post(tb, fM, fE, bM, bE, Zb)
    j = lambda x: jnp.asarray(x.numpy())
    ch_p, LPM_p, LPE_p = pk.viterbi_post_pallas(j(fM), j(fE), j(bM), j(bE),
                                                j(Zb), jb, interpret=True)
    T = np.asarray(jb.T)
    for a, b in zip(_live(ch, T), _live(ch_p, T)):
        assert (a.astype(bool) == b).mean() > 0.999
    for got, want in ((LPM, LPM_p), (LPE, LPE_p)):
        for a, b in zip(_live(got, T), _live(want, T)):
            live = ~(np.isneginf(a) & np.isneginf(b))
            assert np.abs(a[live] - b[live]).max() < 1e-3


@pytest.fixture(scope="module", params=["fp32", "fp64"])
def engines(request, model):
    """Both packages' matrix-route engines on the short reads (fp32: four
    reads of 50 + 13 s bases, as tests/test_nt_banded_batch.py)."""
    jdt, tdt = DTYPES[request.param]
    reads = _reads(model, base_len=50 if request.param == "fp32" else 40)
    want = JaxEngine(model, "rna002", dtype=jdt, batch_size=3,
                     device_pipeline=False).run([JaxItem(s, r) for s, r in reads])
    eng = BandedBatchEngine(model, "rna002", device="cpu", dtype=tdt,
                            batch_size=3, device_pipeline=False)
    kk.reset_counts()
    got = eng.run([BatchItem(s, r) for s, r in reads])
    return request.param, want, got, dict(kk.PLAIN_RUNS)


def test_engine_matrix_route_matches_jax(engines):
    name, want, got, plain = engines
    assert all(plain[k] == 2 for k in kk.MATRIX_KERNELS)  # two buckets
    assert not any(plain[k] for k in ("banded_fwd_vit", "banded_walk"))
    for g, w in zip(got, want):
        assert g.error is None and w.error is None
        assert [s[:3] for s in g.segments] == [s[:3] for s in w.segments]
        atol = 1e-6 if name == "fp64" else 2e-3
        for a, b in zip(g.segments, w.segments):
            assert a[3] == pytest.approx(b[3], abs=atol)
        if name == "fp64":
            assert g.Z == pytest.approx(w.Z, rel=1e-12)


def test_matrix_route_matches_device_route(model):
    """The same reads, snapped to the int16 wire grid as
    tests/test_device_pipeline.py snaps them, through both routes of the
    port's fp32 engine: borders identical."""
    items = []
    for s in range(3):
        sig, read = make_read(model, n_bases=45 + 9 * s, seed=100 + s)
        dac, a, b = dv.quantize_signal(sig)
        items.append(BatchItem(dac.astype(np.float64) * a + b, read))
    outs = {route: BandedBatchEngine(model, "rna002", device="cpu",
                                     device_pipeline=route).run(items)
            for route in (True, False)}
    for d, m in zip(outs[True], outs[False]):
        assert d.error is None and m.error is None
        assert [s[1:3] for s in m.segments] == [s[1:3] for s in d.segments]
        assert max(abs(x[3] - y[3]) for x, y in zip(m.segments, d.segments)) <= 2e-3

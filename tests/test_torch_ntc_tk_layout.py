"""The layout of K9 ntc_tk_bwd and K10 ntc_tk_fwd_u (csrc/ntc_pre.cu), on
the CPU and without JAX: the kernels give each thread one k-mer group,
so these tests pin what the kernels assume and what the card cannot show
here.

* The launch geometry (ntc_pre_kernels.tk_geometry) for K = 4^1 .. 4^6 in
  fp32 and fp64: threads (one k-mer group of A columns each), the thread
  count the kernel is built for, K10's ring, shared bytes within the card's
  232448; the threads' columns (tk_columns) partition the row, and each
  thread's columns share one successor group (K9) or one predecessor class
  (K10).
* The wrappers' CUDA path refuses K > 4096, K % A != 0 and A != 4 before
  any launch, and hands the entry the shape (and K10 tk_geometry's ring),
  with the CUDA entry replaced by a recorder.
* A torch reference of the kernels' per-thread order -- each group's
  logsumexp computed once, in the kernel's op order, then applied to the
  thread's A columns -- equals tk_bwd_plain and tk_fwd_u_plain bit for bit
  on the three short test reads, in fp32 and fp64: the deduplication is
  exact.
"""

import math

import numpy as np
import pytest
import torch

from dynamont_tpu_torch.models.registry import load_model_for_pore
from dynamont_tpu_torch.ops import ntc_pre_kernels as kn
from dynamont_tpu_torch.utils.synthetic import make_read

LM, LE = math.log(0.019889650396799997), math.log(0.9801103496029998)
A = 4
DTYPES = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e", range(1, 7))
def test_geometry_partitions_groups(e, dtype):
    K, itemsize = A ** e, DTYPES[dtype].itemsize
    step = K // A
    geo = kn.tk_geometry(K, A, itemsize)
    assert geo.threads == step <= kn.TK_MAX_THREADS
    assert geo.max_threads == (kn.MAX_THREADS if step <= kn.MAX_THREADS else kn.TK_MAX_THREADS)
    assert 2 <= geo.ring <= kn.TK_RING
    assert geo.bwd_bytes == (2 * K + 2 * kn.TK_CHUNK) * itemsize
    assert geo.fwd_bytes == geo.bwd_bytes + geo.ring * 2 * K * itemsize
    assert geo.fwd_bytes <= kn.SMEM_LIMIT == 232448
    for kernel in ("bwd", "fwd"):
        cols = kn.tk_columns(K, A, itemsize, kernel)
        assert cols.shape == (geo.threads, A)
        assert sorted(cols.flatten().tolist()) == list(range(K))
        if kernel == "bwd":  # one successor group (k % step) * A + j
            key = cols % step
        else:  # one predecessor class k // A + j * step
            key = cols // A
        assert (key == key[:, :1]).all()
        assert len(set(key[:, 0].tolist())) == step
        if kernel == "fwd":  # contiguous: one vector load or store a group
            assert (cols == cols[:, :1] + torch.arange(A)).all()


class _Recorder:
    """Stands in for a CUDA entry point: records its integer arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append([a for a in args if isinstance(a, int)])
        return 0


@pytest.fixture
def cuda_path(monkeypatch):
    """The wrappers' CUDA path on CPU tensors, with every entry a
    recorder: {name: recorder}."""
    rec = {}
    monkeypatch.setattr(kn, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kn, "_stream", lambda device: None)
    monkeypatch.setattr(kn, "_entry", lambda name, dtype: rec.setdefault(name, _Recorder()))
    launches = dict(kn.LAUNCHES)
    yield rec
    kn.LAUNCHES.update(launches)


def _inputs(K, R=2, T_pad=9, dtype=torch.float32):
    sig = torch.zeros((R, T_pad - 1), dtype=dtype)
    tabk = torch.zeros((3, K), dtype=dtype)
    T_r = torch.full((R,), T_pad, dtype=torch.int32)
    bwd = torch.zeros((T_pad, 2, R, K), dtype=dtype)
    return sig, tabk, T_r, bwd


@pytest.mark.parametrize("K, alphabet, what", [
    (4 ** 7, 4, "K up to 4096"), (4100, 4, "K up to 4096"),
    (1022, 4, "a multiple"), (27, 3, "A = 4")])
def test_wrappers_refuse_shapes(cuda_path, K, alphabet, what):
    sig, tabk, T_r, bwd = _inputs(K)
    with pytest.raises(ValueError, match="the TK kernels"):
        kn.tk_bwd(sig, tabk, T_r, alphabet, LM, LE)
    with pytest.raises(ValueError, match="the TK kernels"):
        kn.tk_fwd_u(sig, tabk, T_r, bwd, alphabet, LM, LE)
    assert not any(r.calls for r in cuda_path.values()), what


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [16, 256, 1024, 4096])
def test_wrappers_pass_geometry(cuda_path, K, dtype):
    dt = DTYPES[dtype]
    sig, tabk, T_r, bwd = _inputs(K, dtype=dt)
    geo = kn.tk_geometry(K, A, dt.itemsize)
    kn.tk_bwd(sig, tabk, T_r, A, LM, LE)
    kn.tk_fwd_u(sig, tabk, T_r, bwd, A, LM, LE)
    R, T_pad = sig.shape[0], sig.shape[1] + 1
    assert cuda_path["ntc_tk_bwd"].calls == [[R, T_pad, K, A]]
    assert cuda_path["ntc_tk_fwd_u"].calls == [[R, T_pad, K, A, geo.ring]]


# ---------------------------------------------------------------------------
# the kernels' per-thread order on the short reads
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def short_bucket():
    """The three short test reads of the pre-pass tests, zero-padded to
    (3, T_pad - 1) with T_pad a multiple of 64, and the rna002 TK table."""
    model = load_model_for_pore("rna002")
    reads = [make_read(model, n_bases=n, seed=s) for s, n in ((0, 25), (1, 31), (2, 18))]
    T = np.array([len(s) + 1 for s, _ in reads], np.int32)
    T_pad = -(-int(T.max()) // 64) * 64
    sig = np.zeros((3, T_pad - 1))
    for i, (s, _) in enumerate(reads):
        sig[i, : len(s)] = s
    return sig, T, np.stack(model.score_params())


def _group_lse_once(v):
    """The kernels' group_lse over the last dim (A values): the max as a
    chain of NaN-propagating maxima, exp, the sum in ascending j, log;
    -inf where the max is not finite. One value per group."""
    m = v[..., 0]
    for j in range(1, A):
        m = torch.maximum(m, v[..., j])
    fin = torch.isfinite(m)
    safe = torch.where(fin, m, 0.0)
    s = torch.exp(v[..., 0] - safe)
    for j in range(1, A):
        s = s + torch.exp(v[..., j] - safe)
    return torch.where(fin, torch.log(s) + safe, -math.inf)


def _bwd_grouped(sig, tabk, T_r):
    """K9 in its threads' order: thread i's successor group q, V[qA + j]
    summed once, applied to its columns q + j*step."""
    R, Tm1 = sig.shape
    K = tabk.shape[1]
    cols = kn.tk_columns(K, A, sig.element_size(), "bwd")  # (threads, A)
    q = cols[:, 0]
    M = torch.full((R, K), -math.inf, dtype=sig.dtype)
    E = M.clone()
    bwd = torch.empty((Tm1 + 1, 2, R, K), dtype=sig.dtype)
    for t in range(Tm1, -1, -1):
        x = sig[:, t] if t < Tm1 else torch.zeros(R, dtype=sig.dtype)
        sc = kn.tk_scores(x, tabk)
        V = (M + sc) + LM
        em = E + sc
        y = _group_lse_once(V[:, q[:, None] * A + torch.arange(A)])  # (R, threads)
        e_new = torch.empty_like(E)
        # y copied to its A columns, as a thread holds it for them (torch's
        # CPU logaddexp rounds a broadcast operand on another code path)
        y_cols = y[..., None].expand(-1, -1, A).contiguous()
        e_new[:, cols] = torch.logaddexp(y_cols, em[:, cols] + LE)
        term, dead = kn.tk_row_masks(t, T_r)
        M = torch.where(term | dead, -math.inf, em)
        E = torch.where(term, 0.0, torch.where(dead, -math.inf, e_new))
        bwd[t, 0], bwd[t, 1] = M, E
    return bwd


def _fwd_grouped(sig, tabk, T_r, bwd):
    """K10 in its threads' order: thread i's predecessor class c,
    E[c + j*step] summed once, applied to its columns cA + j."""
    R, Tm1 = sig.shape
    K = tabk.shape[1]
    step = K // A
    cols = kn.tk_columns(K, A, sig.element_size(), "fwd")
    c = cols[:, 0] // A
    M = torch.full((R, K), -math.inf, dtype=sig.dtype)
    E = torch.zeros_like(M)
    U = torch.empty((Tm1 + 1, R, K), dtype=sig.dtype)
    finalE = M.clone()
    for t in range(Tm1 + 1):
        if t > 0:
            sc = kn.tk_scores(sig[:, t - 1], tabk)
            X = _group_lse_once(E[:, c[:, None] + torch.arange(A) * step])
            m_new = torch.empty_like(M)
            m_new[:, cols] = (X[..., None] + sc[:, cols]) + LM
            e_new = torch.logaddexp(M + sc, (E + sc) + LE)
            dead = kn.tk_row_masks(t, T_r)[1]
            M = torch.where(dead, -math.inf, m_new)
            E = torch.where(dead, -math.inf, e_new)
        finalE = torch.where((t == T_r - 1)[:, None], E, finalE)
        U[t] = torch.logaddexp(bwd[t, 0] + M, bwd[t, 1] + E)
    return U, finalE


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_order_is_plain_bit_for_bit(short_bucket, dtype):
    dt = DTYPES[dtype]
    sig_np, T, tab = short_bucket
    sig = torch.from_numpy(sig_np).to(dt)
    tabk = torch.from_numpy(tab).to(dt).contiguous()
    T_r = torch.from_numpy(T)
    same = lambda g, w: torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    want = kn.tk_bwd_plain(sig, tabk, T_r, A, LM, LE)
    same(_bwd_grouped(sig, tabk, T_r), want)
    for g, w in zip(_fwd_grouped(sig, tabk, T_r, want),
                    kn.tk_fwd_u_plain(sig, tabk, T_r, want, A, LM, LE)):
        same(g, w)

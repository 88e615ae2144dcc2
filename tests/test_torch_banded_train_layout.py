"""The layout and arithmetic of K5 banded_fwd and K6 banded_bwd_train
(csrc/nt_banded_train.cu), on the CPU and without JAX: these tests pin
what the kernels assume and what the card cannot show here.

* The staged chunks (ops/nt_banded_kernels.train_staging): at every band
  width the kernels take (multiples of 32 up to 1024), in fp32 and fp64,
  K5's and K6's two stages fit the card's 232448 bytes with at least one
  row a chunk, each takes the most rows that fit up to its cap, and the
  bytes are the .cu sums (fwd_smem_bytes, bwd_train_smem_bytes) written
  out.
* K6's numerator fold takes one exp where ops/nt_banded_batch._online_add
  takes two: a torch transcription of the kernel's `fold`, op for op,
  equals _online_add bit for bit on edge values (-inf and +inf on either
  side, NaN, ties, signed zeros, the first fold from m = -inf, gaps near
  exp's underflow) and along seeded sequences of folds.
* With the CUDA entries replaced by a recorder, the wrappers hand K5 and
  K6 their chunk rows, and K6 refuses an fE that does not start 16-byte
  aligned before any launch.
"""

import math

import pytest
import torch

from dynamont_tpu_torch.models.registry import load_model_for_pore
from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops import nt_banded_kernels as kk
from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.utils.synthetic import make_read

LM, LE = math.log(0.019889650396799997), math.log(0.9801103496029998)
DTYPES = {"float32": torch.float32, "float64": torch.float64}
INF, NAN = float("inf"), float("nan")


# ---------------------------------------------------------------------------
# staged chunks
# ---------------------------------------------------------------------------

def _fwd_bytes(B, C, es):
    """csrc/nt_banded_train.cu's fwd_smem_bytes: two previous rows [2][B]
    of M and E, two stages of a C + B window of mu/c1/c2 and C samples,
    two stages of C + 1 band starts."""
    return (4 * B + 2 * (3 * (B + C) + C)) * es + 2 * (C + 1) * 4


def _bwd_train_bytes(B, C, es):
    """bwd_train_smem_bytes: two previous rows, two stages of C fE rows,
    two of a C + B + 2 window of mu/c1/c2 and C samples, the band reduction
    over P (B rounded up to a power of two), two stages of band starts."""
    P = 1
    while P < B:
        P *= 2
    return (4 * B + 2 * C * B + 2 * (3 * (C + B + 2) + C) + P) * es + 2 * (C + 1) * 4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["banded_fwd", "banded_bwd_train"])
def test_train_staging_fits_shared_memory(kernel, dtype):
    es = torch.empty((), dtype=DTYPES[dtype]).element_size()
    nbytes, rows, used, cap = {
        "banded_fwd": (_fwd_bytes, "fwd_rows", "fwd_bytes", kk.FWD_MAX_ROWS),
        "banded_bwd_train": (_bwd_train_bytes, "bwd_train_rows", "bwd_train_bytes",
                             kk.BWD_TRAIN_MAX_ROWS),
    }[kernel]
    for B in range(32, kk.MAX_B + 1, 32):
        st = kk.train_staging(B, es)
        C = getattr(st, rows)
        assert C >= 1, B
        assert getattr(st, used) == nbytes(B, C, es), B
        assert getattr(st, used) <= kk.SMEM_LIMIT == 232448, B
        assert C == cap or nbytes(B, C + 1, es) > kk.SMEM_LIMIT, B


def test_train_staging_at_the_trainers_width():
    """The trainer's B 512: K5 takes its cap in both dtypes; K6's fE rows
    leave it fewer rows in fp64 than in fp32, and more than a few in
    both."""
    f32, f64 = kk.train_staging(512, 4), kk.train_staging(512, 8)
    assert f32.fwd_rows == f64.fwd_rows == kk.FWD_MAX_ROWS == 256
    assert 16 <= f64.bwd_train_rows < f32.bwd_train_rows <= kk.BWD_TRAIN_MAX_ROWS


# ---------------------------------------------------------------------------
# the one-exp numerator fold
# ---------------------------------------------------------------------------

def _fold(m, s, x):
    """csrc/nt_banded_train.cu's `fold`, op for op: max_nan, then one exp
    whose argument and partner (1 + (d - d)) a select on x > m picks."""
    m_new = torch.where(torch.isnan(m) | (m > x), m, x)  # max_nan(m, x)
    up = x > m
    e = torch.exp(torch.where(up, m - m_new, x - m_new))
    one = 1 + torch.where(up, x - m_new, m - m_new)
    s_new = torch.where(up, s * e + one, s * one + e)
    return m_new, torch.where(m_new > -INF, s_new, s)


def _same_state(got, want):
    """m as values (max_nan and torch.maximum pick different zeros on a tie
    of +0 and -0, as the kernel's fold did before it took one exp); s bit
    for bit, any NaN equal to any NaN."""
    (gm, gs), (wm, ws) = got, want
    assert torch.equal(torch.isnan(gm), torch.isnan(wm))
    assert torch.equal(gm[~torch.isnan(gm)], wm[~torch.isnan(wm)])
    as_int = torch.int32 if gs.dtype == torch.float32 else torch.int64
    nan = torch.isnan(gs)
    assert torch.equal(nan, torch.isnan(ws))
    assert torch.equal(gs[~nan].view(as_int), ws[~nan].view(as_int))


def _edges(dtype):
    """Terms and sums at the edges: infinities, NaN, signed zeros, and
    values whose differences fall near exp's underflow (to subnormals and
    to zero) in fp32 and fp64."""
    under = [-87.3, -87.4, -103.9, -104.0, -708.3, -708.5, -745.1, -745.2]
    vals = [-INF, INF, NAN, -0.0, 0.0, 1.0, -1.0, 2.5, -3.25, 80.0, -80.0, 1e30, -1e30,
            *under, *(u + 1.0 for u in under)]
    sums = [0.0, 1.0, 0.5, 3.0, 1e-40, 1e-310, 1e38, INF, NAN]
    return (torch.tensor(vals, dtype=dtype), torch.tensor(sums, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fold_takes_online_adds_values_on_edges(dtype):
    vals, sums = _edges(DTYPES[dtype])
    m, s, x = torch.meshgrid(vals, sums, vals, indexing="ij")
    m, s, x = m.reshape(-1), s.reshape(-1), x.reshape(-1)
    _same_state(_fold(m, s, x), bb._online_add(m, s, x))
    # the first fold of a column: from m = -inf, s = 0
    m0, s0 = torch.full_like(vals, -INF), torch.zeros_like(vals)
    _same_state(_fold(m0, s0, vals), bb._online_add(m0, s0, vals))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fold_takes_online_adds_values_along_sequences(dtype):
    """Seeded sequences of 400 folds over 256 columns from (-inf, 0), the
    terms mostly finite with runs of -inf (cells outside the band), ties,
    gaps near underflow and rare infinities and NaN: the state after every
    fold is _online_add's."""
    dt = DTYPES[dtype]
    g = torch.Generator().manual_seed(17)
    vals, _ = _edges(dt)
    m = torch.full((256,), -INF, dtype=dt)
    s = torch.zeros_like(m)
    pm, ps = m.clone(), s.clone()
    for _ in range(400):
        x = (torch.randn(256, generator=g, dtype=dt) * 30).round(decimals=1)
        pick = torch.rand(256, generator=g)
        x = torch.where(pick < 0.3, -INF, x)
        x = torch.where((pick > 0.9) & (pick < 0.95), m, x)  # ties with the max
        edge = vals[torch.randint(len(vals), (256,), generator=g)]
        x = torch.where(pick > 0.995, edge, x)
        m, s = _fold(m, s, x)
        pm, ps = bb._online_add(pm, ps, x)
        _same_state((m, s), (pm, ps))
    assert torch.isfinite(s).sum() > 200  # most columns kept finite sums


# ---------------------------------------------------------------------------
# the wrappers' CUDA path, the entries replaced by a recorder
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for a CUDA entry point: records its integer arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append([a for a in args if isinstance(a, int)])
        return 0


@pytest.fixture
def cuda_path(monkeypatch):
    """The wrappers' CUDA path on CPU tensors, every entry a recorder."""
    rec = {}
    monkeypatch.setattr(kk, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kk, "_stream", lambda device: None)
    monkeypatch.setattr(kk, "_entry", lambda name, dtype: rec.setdefault(name, _Recorder()))
    counts = dict(kk.LAUNCHES)
    yield rec
    kk.LAUNCHES.update(counts)


def _batch(dtype):
    model = load_model_for_pore("rna002")
    items = [make_read(model, n_bases=40 + 10 * s, seed=s) for s in range(2)]
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size) for _, r in items]
    return bb.prepare_batch([s for s, _ in items], kids, model, device="cpu",
                            dtype=dtype, t_pad_to=64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_training_wrappers_pass_chunk_rows(cuda_path, dtype):
    b = _batch(DTYPES[dtype])
    R, T_pad = b.bstart.shape
    st = kk.train_staging(b.B, b.sig.element_size())
    fM, fE = kk.forward(b, LM, LE)
    assert fM.shape == fE.shape == (R, T_pad, b.B)
    kk.backward_train(b, fE, LM, LE)
    head = [R, T_pad, b.mu_pad.shape[1], b.B, b.pad]
    assert cuda_path["nt_banded_fwd"].calls == [head + [st.fwd_rows]]
    assert cuda_path["nt_banded_bwd_train"].calls == [head + [st.bwd_train_rows]]


def test_bwd_train_refuses_unaligned_fE_before_launch(cuda_path):
    b = _batch(torch.float32)
    shape = (b.bstart.shape[0], b.bstart.shape[1], b.B)
    fE = torch.zeros(math.prod(shape) + 1)[1:].view(shape)
    with pytest.raises(ValueError, match="fE does not start 16-byte aligned"):
        kk.backward_train(b, fE, LM, LE)
    assert not cuda_path

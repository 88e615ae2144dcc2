"""The layout of K4 banded_vit (csrc/nt_banded.cu), on the CPU and without
JAX: these tests pin what the kernel assumes and what the card cannot
show here.

* The staged chunks (ops/nt_banded_kernels.staging's vit_rows and
  vit_bytes): at every band width the kernel takes (multiples of 32 up to
  1024), in fp32 and fp64, K4's two stages fit the card's 232448 bytes
  with at least one row a chunk, it takes the most rows that fit up to
  VIT_MAX_ROWS, the bytes are the .cu sum (vit_smem_bytes) written out,
  and every array the kernel copies or stores in 16-byte pieces starts
  16-byte aligned in that layout.
* The kernel's chunk order, transcribed in torch (stage C rows and C + 1
  band starts, form the chunk's posteriors, then step its rows), equals
  viterbi_post_plain bit for bit at several C, with reads whose T is 1, is
  within a chunk, and is not a multiple of C.
* With the CUDA entry replaced by a recorder, the wrapper hands K4 its
  chunk rows and refuses an input that does not start 16-byte aligned
  before any launch.
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


@pytest.fixture(autouse=True)
def one_thread():
    """The plain Viterbi loop is thousands of tiny ops: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# staged chunks
# ---------------------------------------------------------------------------

def _vit_layout(B, C, es):
    """csrc/nt_banded.cu's banded_vit shared memory, array by array: byte
    offset and size of two stages of fM, fE, bM, bE rows [C][B], the
    Viterbi rows [2][B + 4] of M and E, the chunk's row records [C] (16
    bytes each), the stages' two mbarriers (8 bytes each) and two stages
    of C + 1 band starts (int32)."""
    parts, at = {}, 0
    for name, n in (*((f"{a}{st}", C * B * es) for st in (0, 1)
                      for a in ("fM", "fE", "bM", "bE")),
                    ("VMp", 2 * (B + 4) * es), ("VEp", 2 * (B + 4) * es),
                    ("rows", 16 * C), ("bars", 16), ("bs0", (C + 1) * 4),
                    ("bs1", (C + 1) * 4)):
        parts[name] = (at, n)
        at += n
    return parts, at


@pytest.mark.parametrize("dtype", DTYPES)
def test_vit_staging_fits_shared_memory(dtype):
    es = torch.empty((), dtype=DTYPES[dtype]).element_size()
    for B in range(32, kk.MAX_B + 1, 32):
        st = kk.staging(B, es)
        C = st.vit_rows
        _, total = _vit_layout(B, C, es)
        assert C >= 1, B
        assert st.vit_bytes == total == ((8 * C * B + 4 * (B + 4)) * es + 16 * C + 16
                                         + 2 * (C + 1) * 4), B
        assert st.vit_bytes <= kk.SMEM_LIMIT == 232448, B
        assert C == kk.VIT_MAX_ROWS or _vit_layout(B, C + 1, es)[1] > kk.SMEM_LIMIT, B


@pytest.mark.parametrize("dtype", DTYPES)
def test_vit_stages_are_16_byte_aligned(dtype):
    """Stored rows are copied by bulk copies, formed in 16-byte pieces and
    stored by bulk copies; each Viterbi row buffer starts 16-byte aligned
    (so a thread's two columns, at c + 2, move as one 8- or 16-byte
    vector); row records are read as 16 bytes, mbarriers want 8; band
    starts are copied as ints."""
    es = torch.empty((), dtype=DTYPES[dtype]).element_size()
    for B in range(32, kk.MAX_B + 1, 32):
        parts, _ = _vit_layout(B, kk.staging(B, es).vit_rows, es)
        for name, (at, n) in parts.items():
            align = {"bs0": 4, "bs1": 4}.get(name, 16)
            assert at % align == 0 and n % align == 0, (B, name)
        assert (parts["VMp"][0] + (B + 4) * es) % 16 == 0, B  # row buffer 1


def test_vit_staging_at_the_matrix_width():
    """The matrix route's B 512: 13 rows a chunk in fp32, 6 in fp64, so a
    chunk in flight is 104 KB and 96 KB of stored rows; at B 1024 fp64
    still three rows a chunk."""
    f32, f64 = kk.staging(512, 4), kk.staging(512, 8)
    assert (f32.vit_rows, f64.vit_rows) == (13, 6)
    assert 4 * f32.vit_rows * 512 * 4 == 106496 and 4 * f64.vit_rows * 512 * 8 == 98304
    assert kk.staging(kk.MAX_B, 8).vit_rows == 3
    assert kk.staging(32, 4).vit_rows == kk.VIT_MAX_ROWS == 32


# ---------------------------------------------------------------------------
# the chunk order
# ---------------------------------------------------------------------------

def _batch(dtype, t_pad_to=64, n_bases=(40, 50)):
    model = load_model_for_pore("rna002")
    items = [make_read(model, n_bases=n, seed=s) for s, n in enumerate(n_bases)]
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size) for _, r in items]
    return bb.prepare_batch([s for s, _ in items], kids, model, device="cpu",
                            dtype=dtype, t_pad_to=t_pad_to)


def _rows(b):
    fM, fE = bb.forward(b, LM, LE)
    bM, bE = bb.backward(b, LM, LE)
    return fM, fE, bM, bE, bE[torch.arange(b.bstart.shape[0]), 0, b.bw.long() + 1]


def _vit_chunked(b, rows, C):
    """banded_vit's order, read by read: chunk k stages rows t0 = k*C ..
    t0 + n - 1 of the four stored rows and band starts of rows t0 - 1 ..
    t0 + n - 1 (chunk 0 has no row -1), forms lpm = (fM + bM) - Zb and
    lpe = (fE + bE) - Zb over the whole chunk, then steps its rows (row 0
    takes no step) from the staged copies alone."""
    fM, fE, bM, bE, Zb = rows
    R, T_pad, B = fM.shape
    NEG = float("-inf")
    ch = torch.zeros((R, T_pad, B), dtype=torch.uint8)
    LPM, LPE = torch.full_like(fM, NEG), torch.full_like(fM, NEG)
    j = torch.arange(B)
    for r in range(R):
        T, N, bw = int(b.T[r]), int(b.N[r]), int(b.bw[r])
        vM = torch.full((1, B), NEG, dtype=fM.dtype)
        vE = torch.where(j == bw + 1, 0.0, NEG).to(fM.dtype)[None]
        for k in range((T + C - 1) // C):
            t0 = k * C
            n = min(C, T - t0)
            sl = slice(t0, t0 + n)
            bs = [None] + b.bstart[r, t0:t0 + n].tolist() if k == 0 \
                else b.bstart[r, t0 - 1:t0 + n].tolist()
            lpm = (fM[r, sl] + bM[r, sl]) - Zb[r]
            lpe = (fE[r, sl] + bE[r, sl]) - Zb[r]
            LPM[r, sl], LPE[r, sl] = lpm, lpe
            for i in range(1 if k == 0 else 0, n):
                s = bs[i + 1]
                s1 = torch.tensor([[s != bs[i]]])
                valid = (j >= max(s, 1) - s + 1) & (j < min(s + 2 * bw + 1, N) - s + 1)
                vM, vE, c = bb._viterbi_row(vM, vE, s1, lpm[i][None], lpe[i][None],
                                            valid[None])
                ch[r, t0 + i] = c[0].to(torch.uint8)
    return ch, LPM, LPE


def _bits(x):
    return x.view({1: torch.uint8, 4: torch.int32, 8: torch.int64}[x.element_size()])


@pytest.mark.parametrize("C", [1, 3, 13, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_vit_chunk_order_matches_plain(dtype, C):
    """Three reads (t_pad_to 128): T as prepared (at C > 1 one of them not a
    multiple of C, so its last chunk is short), one cut to T = 1 in the
    bucket of longer reads."""
    b = _batch(DTYPES[dtype], t_pad_to=128, n_bases=(20, 25, 30))
    b = b._replace(T=torch.tensor([int(b.T[0]), 1, int(b.T[2])], dtype=torch.int32))
    assert int(b.T.max()) > C and (C == 1 or any(int(t) % C for t in b.T))
    rows = _rows(b)
    want = kk.viterbi_post_plain(b, *rows)
    got = _vit_chunked(b, rows, C)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


# ---------------------------------------------------------------------------
# the wrapper's CUDA path, the entry replaced by a recorder
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
    """The wrapper's CUDA path on CPU tensors, every entry a recorder."""
    rec = {}
    monkeypatch.setattr(kk, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kk, "_stream", lambda device: None)
    monkeypatch.setattr(kk, "_entry", lambda name, dtype: rec.setdefault(name, _Recorder()))
    counts = dict(kk.LAUNCHES)
    yield rec
    kk.LAUNCHES.update(counts)


@pytest.mark.parametrize("dtype", DTYPES)
def test_viterbi_post_passes_chunk_rows(cuda_path, dtype):
    b = _batch(DTYPES[dtype])
    R, T_pad = b.bstart.shape
    rows = [torch.zeros((R, T_pad, b.B), dtype=DTYPES[dtype]) for _ in range(4)]
    ch, LPM, LPE = kk.viterbi_post(b, *rows, torch.zeros(R, dtype=DTYPES[dtype]))
    assert ch.dtype == torch.uint8 and ch.shape == LPM.shape == LPE.shape == (R, T_pad, b.B)
    C = kk.staging(b.B, b.sig.element_size()).vit_rows
    assert cuda_path["nt_banded_vit"].calls == [[R, T_pad, b.B, C]]


@pytest.mark.parametrize("arg", ["fM", "fE", "bM", "bE"])
def test_viterbi_post_refuses_unaligned_rows_before_launch(cuda_path, arg):
    b = _batch(torch.float32)
    shape = (b.bstart.shape[0], b.bstart.shape[1], b.B)
    rows = {a: torch.zeros(shape) for a in ("fM", "fE", "bM", "bE")}
    rows[arg] = torch.zeros(math.prod(shape) + 1)[1:].view(shape)
    with pytest.raises(ValueError, match=f"{arg} does not start 16-byte aligned"):
        kk.viterbi_post(b, *rows.values(), torch.zeros(shape[0]))
    assert not cuda_path

"""The layout of K7 ntc_tn_fwd (csrc/ntc_pre.cu) and K16 ntc_walk
(csrc/ntc_lattice.cu), on the CPU and without JAX: these tests pin what
the kernels assume and what the card cannot show here.

* K7's launch geometry (ntc_pre_kernels.tn_fwd_geometry) at widths whose
  thread count differs: whole warps, 4 or 8 columns a thread, the
  threads' columns (tn_fwd_columns) partitioning the row, contiguous in
  groups of four in fp32 and strided in fp64 (tn_fwd_layout); widths it
  does not take are refused before any launch.
* K16's chunk (ntc_kernels.walk_geometry) at the main and the wide caps
  (and as the engine pads them) in fp32 and fp64: the two stages, the
  records and the mbarriers fit the card's 232448 bytes; the padded caps
  take the tensor-copy instance; a shape where not one row fits is
  refused before any launch.
* With the CUDA entries replaced by a recorder, the wrappers hand K7 its
  geometry's threads, K8's chain the threads it always had (threads(N2)),
  and K16 its shape.
* A torch reference of K16's chunked order -- rows staged a chunk at a
  time (only the rows the walk can load, the rest poisoned), the chain's
  records kept per chunk, micro-steps that cannot move recorded from the
  registers without a load, lp gathered and the records written a chunk
  behind -- equals walk_records_plain bit for bit on seeded plans with
  hand-built reads (one t-step a row across every chunk boundary, I-chains
  of two steps, a read that goes stuck, an invalid read, a read shorter
  than the bucket) beside random ones, in fp32 and fp64.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dynamont_tpu_torch.ops import ntc_kernels as kern
from dynamont_tpu_torch.ops import ntc_pre_kernels as kn
from dynamont_tpu_torch.ops import ntc_walk as nw
from dynamont_tpu_torch.ops.ntc_batch import A_ST, E_ST, I_ST, P_ST, S_ST, slot_bits

LM, LE = math.log(0.019889650396799997), math.log(0.9801103496029998)
DTYPES = {"float32": torch.float32, "float64": torch.float64}
WIDTHS = (4, 48, 64, 1000, 2048, 2052, 4092, 4096)
CAPS = ((8, 120), (16, 240))
K, S_MAX, KMER = 1024, 64, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N2", WIDTHS)
def test_tn_fwd_columns_partition_the_row(N2, dtype):
    itemsize = DTYPES[dtype].itemsize
    geo = kn.tn_fwd_geometry(N2)
    assert geo.threads % 32 == 0 and geo.threads <= kn.MAX_THREADS
    assert geo.cols == (4 if N2 <= 4 * kn.MAX_THREADS else 8)
    assert geo.threads == -(-(-(-N2 // geo.cols)) // 32) * 32  # ceil(N2 / cols), whole warps
    cols = kn.tn_fwd_columns(N2, itemsize)
    assert cols.shape == (geo.threads, geo.cols)
    owned = cols[cols < N2]
    assert sorted(owned.tolist()) == list(range(N2))
    q, j = torch.arange(geo.threads)[:, None], torch.arange(geo.cols)
    if kn.tn_fwd_layout(itemsize) == "strided":  # fp64: a warp's lanes adjacent in each slot
        assert itemsize == 8 and (cols == q + j * geo.threads).all()
    else:  # fp32: contiguous, in groups of four (one vector store of M and of E a group)
        assert itemsize == 4 and (cols == q * geo.cols + j).all()
        groups = cols.reshape(geo.threads, -1, 4)
        in_row = groups < N2
        assert (in_row == in_row[..., :1]).all()  # a group lies wholly in or past the row


@pytest.mark.parametrize("N2", [2, 6, 50, 1022, 4100, 8192])
def test_tn_fwd_geometry_refuses_widths(N2):
    with pytest.raises(ValueError, match="ntc_tn_fwd takes"):
        kn.tn_fwd_geometry(N2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("caps", CAPS + ((8, 128), (16, 256), (2, 2), (3, 5)))
def test_walk_geometry_fits(caps, dtype):
    CN, CK = caps
    NC, NM = CN * CK, nw.n_micro(CN)
    geo = kern.walk_geometry(CN, CK)
    al128 = lambda b: (b + 127) // 128 * 128
    nbytes = lambda C: 2 * (al128(2 * NC * C) + al128(4 * NC * C) + 2 * al128(4 * CN * C)) \
        + 2 * C * NM * 16 + 16
    assert geo.row_bytes == 2 * NC + 4 * NC + 2 * 4 * CN
    assert geo.nbytes == nbytes(geo.rows) <= kern.SMEM_LIMIT == 232448
    assert 1 <= geo.rows <= kern.WALK_MAX_ROWS
    if geo.rows < kern.WALK_MAX_ROWS:  # the most rows that fit
        assert nbytes(geo.rows + 1) > kern.SMEM_LIMIT
    # the engine pads CK to 128 and 256: whole 16-byte rows, the tensor copies
    assert geo.instance == ("tma" if caps in ((8, 128), (16, 256)) else "copy")
    if caps == (8, 120):
        assert geo.row_bytes == 5824 and geo.rows == 19
    if caps == (16, 240):
        assert geo.row_bytes == 23168 and geo.rows == 5


def test_walk_geometry_refuses_rows_that_do_not_fit():
    with pytest.raises(ValueError, match="ntc_walk: two stages of one row"):
        kern.walk_geometry(32, 640)


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
    """Both wrapper modules' CUDA paths on CPU tensors, with every entry a
    recorder: {name: recorder}."""
    rec = {}
    for mod in (kn, kern):
        monkeypatch.setattr(mod, "_on_cpu", lambda t: False)
        monkeypatch.setattr(mod, "_stream", lambda device: None)
        monkeypatch.setattr(mod, "_entry",
                            lambda name, dtype: rec.setdefault(name, _Recorder()))
    counts = (dict(kn.LAUNCHES), dict(kn.TN_BWD_SEL_LAUNCHES), dict(kern.LAUNCHES))
    yield rec
    kn.LAUNCHES.update(counts[0])
    kn.TN_BWD_SEL_LAUNCHES.update(counts[1])
    kern.LAUNCHES.update(counts[2])


def _tn_inputs(N2, R=3, T_pad=9, dtype=torch.float32):
    sig = torch.zeros((R, T_pad - 1), dtype=dtype)
    tab = torch.zeros((3, R, N2 - 1), dtype=dtype)
    N_r = torch.full((R,), N2, dtype=torch.int32)
    return sig, tab, N_r


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N2", [48, 64, 2048, 4096])
def test_tn_wrappers_pass_geometry(cuda_path, N2, dtype):
    sig, tab, N_r = _tn_inputs(N2, dtype=DTYPES[dtype])
    T_r = N_r.clone()
    fwd = torch.zeros((sig.shape[1] + 1, 2, sig.shape[0], N2), dtype=sig.dtype)
    kn.tn_fwd(sig, tab, N_r, LM, LE)
    kn.tn_bwd_u(sig, tab, N_r, T_r, fwd, LM, LE)
    R, T_pad = sig.shape[0], sig.shape[1] + 1
    assert cuda_path["ntc_tn_fwd"].calls == [[R, T_pad, N2, kn.tn_fwd_geometry(N2).threads]]
    # K8's chain keeps its strided layout and its arguments
    assert cuda_path["ntc_tn_bwd_u"].calls == [[R, T_pad, N2, kn.threads(N2)]]


@pytest.mark.parametrize("N2", [6, 50, 4100])
def test_tn_fwd_refuses_widths_before_launch(cuda_path, N2):
    sig, tab, N_r = _tn_inputs(N2)
    with pytest.raises(ValueError, match="ntc_tn_fwd takes"):
        kn.tn_fwd(sig, tab, N_r, LM, LE)
    assert not cuda_path


def _walk_inputs(CN, CK, R=2, T_pad=7, dtype=torch.float32):
    lp = torch.zeros((T_pad, R, 5, CN, CK), dtype=dtype)
    ch = torch.zeros((T_pad, R, CN, CK), dtype=torch.int16)
    slots = torch.zeros((T_pad, R, CN, CK), dtype=torch.int32)
    plan = SimpleNamespace(row_same=torch.zeros((T_pad, R, CN), dtype=torch.int32),
                           row_prev=torch.zeros((T_pad, R, CN), dtype=torch.int32))
    z = torch.zeros(R, dtype=torch.int32)
    return (lp, ch, slots, plan, z, z, z, torch.ones(R, dtype=torch.bool),
            torch.full((R,), 4, dtype=torch.int32), torch.full((R,), T_pad, dtype=torch.int32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("caps", CAPS)
def test_walk_wrapper_passes_shape(cuda_path, caps, dtype):
    CN, CK = caps
    args = _walk_inputs(CN, CK, dtype=DTYPES[dtype])
    rec, fin = kern.walk(*args, K, 4, KMER, S_MAX)
    T_pad, R = args[0].shape[:2]
    NM = nw.n_micro(CN)
    assert rec.shape == (T_pad, NM, R, nw.NREC) and fin.shape == (R, 2)
    assert cuda_path["ntc_walk"].calls == [[R, T_pad, CN, CK, 4, K, KMER // 2, S_MAX, NM,
                                           slot_bits(CK)]]


def test_walk_refuses_rows_that_do_not_fit_before_launch(cuda_path):
    with pytest.raises(ValueError, match="ntc_walk: two stages of one row"):
        kern.walk(*_walk_inputs(32, 640), K, 4, KMER, S_MAX)
    assert not cuda_path


# ---------------------------------------------------------------------------
# K16's chunked order
# ---------------------------------------------------------------------------

def _word(chE=0, chA=0, chP=0, chS=0, chI=0):
    """A Viterbi choice word (ops/ntc_batch.py's packing)."""
    return chE | (chA << 2) | (chP << 5) | (chS << 9) | (chI << 11)


def walk_rows(T_pad, CN, CK, dtype, seed, n_random=3, device="cpu"):
    """K16's inputs (lp, choices, slots, plan with row_same/row_prev, i0,
    j0, k0, valid, N_r, T_r) for 5 hand-built reads and n_random random
    ones, from a seed:
      0: E -> A -> E ..., one t-step every row (T_r = T_pad), so the
         chain crosses every chunk boundary;
      1: E -> A -> I (A-steps to the top n-slot), then two I-steps (I at
         the top n-slot, E below it) and the row's t-step, every other row
         (CN >= 3: three micro-steps);
      2: E -> A -> I -> I ...: every micro-step an I-step, the read stuck;
      3: an invalid read;
      4: T_r = T_pad - 5;
    the random reads draw every word, slot and row map (row maps and
    slots include values the walk clamps)."""
    rng = np.random.default_rng(seed)
    R = 5 + n_random
    slb = slot_bits(CK)
    lp = rng.normal(-2.0, 1.0, (T_pad, R, 5, CN, CK))
    ch = rng.integers(0, 4096, (T_pad, R, CN, CK))
    slot = lambda: rng.integers(0, CK + 1, (T_pad, R, CN, CK))
    slots = slot() | (slot() << slb) | (slot() << (2 * slb))
    row_same = rng.integers(-1, CN + 1, (T_pad, R, CN))
    row_prev = rng.integers(-1, CN + 1, (T_pad, R, CN))
    i0, j0, k0 = rng.integers(0, CN, R), rng.integers(0, CK, R), rng.integers(0, K, R)
    valid = np.ones(R, bool)
    N_r = rng.integers(3, 3 * T_pad, R)
    T_r = rng.integers(2, T_pad + 1, R)
    iota = np.arange(CN)
    ch[:, 0] = _word(chE=1, chA=0)
    T_r[0], N_r[0] = T_pad, 2 * T_pad
    ch[:, 1] = _word(chE=1, chA=1)
    ch[:, 1] |= (iota == CN - 1)[None, :, None].astype(np.int64) << 11
    row_prev[:, 1], row_same[:, 1] = CN - 1, iota
    i0[1], T_r[1], N_r[1] = CN - 1, T_pad, 4 * T_pad
    ch[:, 2] = _word(chE=1, chA=1, chI=1)
    T_r[2], N_r[2] = T_pad, 4 * T_pad
    valid[3] = False
    T_r[4] = T_pad - 5
    put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)
    i32 = torch.int32
    plan = SimpleNamespace(row_same=put(row_same, i32), row_prev=put(row_prev, i32))
    return (put(lp, dtype), put(ch, torch.int16), put(slots, i32), plan, put(i0, i32),
            put(j0, i32), put(k0, i32), torch.from_numpy(valid).to(device), put(N_r, i32),
            put(T_r, i32))


POISON = -(1 << 14)  # in rows no chunk stages: read there, the walk would go astray


def walk_chunked(lp, choices, slots, plan, i0, j0, k0, valid, N_r, T_r, C):
    """K16 in its chunks of C rows (csrc/ntc_lattice.cu walk_kernel), read
    by read: (rec, fin) as walk_records_plain returns them."""
    T_pad, R, _, CN, CK = lp.shape
    NM, slb, half, Kdiv = nw.n_micro(CN), slot_bits(CK), KMER // 2, K // 4
    SLM = (1 << slb) - 1
    rec = torch.full((T_pad, NM, R, nw.NREC), float("nan"), dtype=lp.dtype)
    fin = torch.zeros((R, 2), dtype=torch.int32)
    nchunks = -(-T_pad // C)
    for r in range(R):
        val, tm1, nm1 = bool(valid[r]), int(T_r[r]) - 1, int(N_r[r]) - 1
        last = tm1 if val else -1
        active = stuck = False
        state = i = j = k = n = seg = 0

        def stage(c):
            """Chunk c's rows hi..lo as the copy warp stages them."""
            hi, lo = T_pad - 1 - c * C, max(0, T_pad - C - c * C)
            st = {}
            for t in range(hi, lo - 1, -1):
                if t <= last:
                    st[t] = (choices[t, r].long(), slots[t, r].long(),
                             plan.row_same[t, r].long(), plan.row_prev[t, r].long())
                else:
                    st[t] = tuple(torch.full_like(a[t, r].long(), POISON) for a in
                                  (choices, slots, plan.row_same, plan.row_prev))
            return hi, lo, st

        def emit(hi, lo, recs):
            """The copy warp's pass over a walked chunk: lp at the cells of
            the steps that moved, one exp over them, the records out."""
            moved = [(t, m, w) for (t, m, w, *_) in recs if w & 8]
            idx = torch.tensor([[t, w & 7, (w >> 6) // CK, (w >> 6) % CK] for t, _, w in moved],
                               dtype=torch.long).reshape(-1, 4)
            p = torch.exp(lp[idx[:, 0], r, idx[:, 1], idx[:, 2], idx[:, 3]])
            probs = {(t, m): p[q] for q, (t, m, _) in enumerate(moved)}
            for t, m, w, sg, nn, kk in recs:
                mv, em, eb = bool(w & 8), bool(w & 16), bool(w & 32)
                rec[t, m, r] = torch.tensor([
                    0.0, sg if mv else S_MAX, float(em), float((w & 7) == P_ST),
                    half if eb else nn - 1 + half, 0 if eb else t - 1, kk,
                    sg if em else S_MAX], dtype=lp.dtype)
                if mv:
                    rec[t, m, r, 0] = probs[(t, m)]

        behind = None
        for c in range(nchunks):
            hi, lo, st = stage(c)
            recs = []
            for t in range(hi, lo - 1, -1):
                ch_t, sl_t, rs_t, rp_t = st[t]
                if t == tm1 and val:
                    active, state, i, j, k, n, seg = True, E_ST, int(i0[r]), int(j0[r]), \
                        int(k0[r]), nm1, 0
                did_t, t_pos = False, t >= 1
                for m in range(NM):
                    is_I = state == I_ST
                    if not (active and t_pos and (is_I or not did_t)):
                        recs.append((t, m, state, seg, n, k))  # no load
                        continue
                    is_A, is_P, is_S, is_E = (state == s for s in (A_ST, P_ST, S_ST, E_ST))
                    c_ = i * CK + j
                    ch, slv = int(ch_t[i, j]), int(sl_t[i, j])
                    row_i = int((rs_t if is_E or is_P else rp_t)[i])
                    i_break = is_I and n == 1
                    i_go = is_I and not i_break
                    tstep = not is_I
                    brk = tstep and t == 1 and (is_E or is_P or ((is_A or is_S) and n == 1))
                    go = tstep and not brk
                    emit_break = brk and (is_E or is_A or is_P)
                    em = emit_break or (go and (is_A or is_P))
                    moved = i_go or go
                    recs.append((t, m, state | (8 if moved else 0) | (16 if em else 0)
                                 | (32 if emit_break else 0) | (c_ << 6), seg, n, k))
                    chE, chA, chP = ch & 3, (ch >> 2) & 7, (ch >> 5) & 15
                    chS, chI = (ch >> 9) & 3, (ch >> 11) & 1
                    ai = chA >> 1 if is_A else chP // 3
                    cs = (slv & SLM) - 1
                    cpa = ((slv >> slb) & SLM if is_A else (slv >> (2 * slb)) & SLM) - 1
                    stE = (E_ST, A_ST, S_ST, P_ST)[chE]
                    stA = E_ST if (chA & 1) == 0 else I_ST
                    m3 = chP - ai * 3
                    stP = E_ST if m3 == 0 else S_ST if m3 == 1 else I_ST
                    stS = E_ST if chS == 0 else P_ST if chS == 1 else I_ST
                    stI = E_ST if chI == 0 else I_ST
                    st_go = stE if is_E else stA if is_A else stP if is_P else stS
                    j_go = cs if (is_E or is_S) else cpa
                    k_go = k // 4 + ai * Kdiv if (is_A or is_P) else k
                    n_go = n - 1 if (is_A or is_S) else n
                    state = stI if i_go else st_go if go else state
                    i = min(max(i - 1 if i_go else row_i if go else i, 0), CN - 1)
                    j = min(max(j_go if go else j, 0), CK - 1)
                    k = k_go if go else k
                    n = n - 1 if i_go else n_go if go else n
                    seg += 1 if em else 0
                    active = not (i_break or brk)
                    did_t = did_t or go or brk
                if active and not did_t and t_pos:
                    stuck = True
            if behind is not None:
                emit(*behind)  # a chunk behind the chain
            behind = (hi, lo, recs)
        emit(*behind)
        fin[r] = torch.tensor([seg, int(stuck)], dtype=torch.int32)
    return rec, fin


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 120, 45, None), (16, 240, 23, None), (8, 120, 45, 7),
                                   (2, 2, 150, None), (3, 5, 40, 3)])
def test_walk_chunked_order_is_plain_bit_for_bit(shape, dtype):
    """C from walk_geometry (None) and small C's that put several chunk
    boundaries on the walk; (3, 5) has an odd NC, rows of int16 choices
    that no 4-byte piece covers."""
    CN, CK, T_pad, C = shape
    C = C or kern.walk_geometry(CN, CK).rows
    assert T_pad > 2 * C  # at least three chunks
    args = walk_rows(T_pad, CN, CK, DTYPES[dtype], seed=T_pad * CN)
    lp, ch, slots, plan, *rest = args
    want = nw.walk_records_plain(lp, ch, slots, plan.row_same, plan.row_prev, *rest,
                                 K, 4, KMER, S_MAX)
    got = walk_chunked(*args, C)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    rec, fin = want
    moved = rec[..., 0] > 0  # (T_pad, NM, R): exp(lp) where a step moved, else 0
    assert moved[2:, 0, 0].all()  # read 0: one t-step every row above the break at t = 1
    assert fin[2, 1] == 1 and fin[3].tolist() == [0, 0]  # stuck; invalid
    assert not moved[T_pad - 5:, :, 4].any() and moved[:, :, 4].any()  # T_r < T_pad
    if CN >= 3:  # two I-steps, then the t-step, in one row of read 1
        assert moved[:, :, 1].all(dim=1).any()

"""The port's CUDA kernels against their plain-torch versions, on a
card. JAX-free, so it runs where the port runs:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

(--noconftest: tests/conftest.py configures JAX). Cases marked `cuda`
skip without a CUDA device. Kernel and plain version compute the same
float operations in the same order on the same device inputs, so every
kernel's outputs equal its plain version's bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from dynamont_tpu_torch.models.registry import load_model_for_pore
from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.utils.synthetic import make_read
from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops import nt_banded_kernels as kk
from dynamont_tpu_torch.ops.nt_banded_train import banded_batch_train

LM, LE = math.log(0.019889650396799997), math.log(0.9801103496029998)


def _same_band(got, want, T):
    """Bit for bit on every read's rows < T, after the same -inf pattern."""
    for i in range(got.shape[0]):
        x, y = got[i, : int(T[i])], want[i, : int(T[i])]
        assert torch.equal(torch.isneginf(x), torch.isneginf(y)), f"read {i}: -inf pattern"
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; any other non-CUDA
    device raises instead of falling back."""
    model = load_model_for_pore("rna002")
    sig, read = make_read(model, n_bases=40, seed=0)
    kid = seq_to_kmer_ids(read, model.kmer_size, model.alphabet_size)
    b = bb.prepare_batch([sig], [kid], model, device="meta",
                         dtype=torch.float32)
    runs = dict(kk.PLAIN_RUNS)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kk.backward(b, LM, LE)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kk.walk(b.mu_pad, b.mu_pad, b.bstart, b, 2)
    assert kk.PLAIN_RUNS == runs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _reads():
    model = load_model_for_pore("rna002")
    items = [make_read(model, n_bases=40 + 10 * s, seed=s) for s in range(3)]
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size)
            for _, r in items]
    return model, items, kids


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_on_cuda(card, dtype):
    model, items, kids = _reads()
    b = bb.prepare_batch([s for s, _ in items], kids, model, device="cuda",
                         dtype=dtype, t_pad_to=256)
    T = b.T.cpu().numpy()
    N_max = int(b.N.max())
    launches = dict(kk.LAUNCHES)

    bM, bE = kk.backward(b, LM, LE)
    pM, pE = kk.backward_plain(b, LM, LE)
    _same_band(bM, pM, T)
    _same_band(bE, pE, T)

    Zb = pE[torch.arange(3, device="cuda"), 0, b.bw.long() + 1]
    ch, LPM, LPE, Zf = kk.fwd_vit(b, pM, pE, Zb, LM, LE)
    pch, pLPM, pLPE, pZf = kk.fwd_vit_plain(b, pM, pE, Zb, LM, LE)
    assert torch.equal(ch, pch)
    _same_band(LPM, pLPM, T)
    _same_band(LPE, pLPE, T)
    torch.testing.assert_close(Zf, pZf, rtol=0, atol=0)

    path_n, prob, close = kk.walk(pLPM, pLPE, pch, b, N_max)
    p_path_n, p_prob, p_close = kk.walk_plain(pLPM, pLPE, pch, b, N_max)
    torch.cuda.synchronize()
    assert torch.equal(path_n, p_path_n)
    assert torch.equal(close, p_close)
    torch.testing.assert_close(prob, p_prob, rtol=0, atol=0)
    assert all(kk.LAUNCHES[k] == launches[k] + 1 for k in kk.SEGMENT_KERNELS)


def _widened(b, B):
    """The batch at band width B >= 2*max_bw + 3: the parameter arrays
    padded on the right so that every band window stays in range."""
    import torch.nn.functional as F

    pad = lambda x: F.pad(x, (0, max(0, B - b.B)))
    return b._replace(mu_pad=pad(b.mu_pad), c1_pad=pad(b.c1_pad),
                      c2_pad=pad(b.c2_pad), B=B)


def _staging_case(case, dtype, device="cuda"):
    """A bucket for each edge of K1's, K2's and K3's staged chunks (K1's
    and K2's C rows a chunk from kk.staging, at most 256 and 32; K3's 64,
    a constant of the kernel): reads of different T; T > C and not a
    multiple of C (K1's T - 1 rows not a multiple of its C either); T <= C;
    T = T_pad for every read; B 32; the largest B (1024)."""
    model = load_model_for_pore("rna002")
    n_bases, t_pad_to, band, B = {
        "ragged": ([40, 50, 60], 256, 400, None),
        "t_not_multiple": ([60], 256, 400, None),
        "t_within_chunk": ([12], 64, 400, None),
        "t_eq_t_pad": ([50, 55], 1, 400, None),
        "b32": ([40, 50, 60], 256, 20, 32),
        "b_max": ([120], 1, 1000, kk.MAX_B),
    }[case]
    short = {"mean_dwell": 2.0, "polya_prefix": False} if case == "t_within_chunk" else {}
    items = [make_read(model, n_bases=n, seed=7 + s, **short) for s, n in enumerate(n_bases)]
    st = kk.staging(128, torch.empty((), dtype=dtype).element_size())
    T_cut = {"t_not_multiple": st.bwd_rows + 7 * st.fwd_vit_rows + 3,
             "t_eq_t_pad": min(len(sig) for sig, _ in items) + 1}.get(case)
    if T_cut is not None:
        items = [(sig[: T_cut - 1], r) for sig, r in items]
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size) for _, r in items]
    b = bb.prepare_batch([s for s, _ in items], kids, model, band, device=device,
                         dtype=dtype, t_pad_to=t_pad_to)
    assert b.B == 128 or case in ("b32", "b_max")
    return b if B is None else _widened(b, B)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "t_not_multiple", "t_within_chunk",
                                  "t_eq_t_pad", "b32", "b_max", "walk_leaves_band"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_staged_kernels_match_plain_on_cuda(card, dtype, case):
    """K1, K2 and K3 at the edges of their staged chunks: every output (bM,
    bE; ch, LPM, LPE, Zf; path_n, prob, close) bit for bit its plain
    version's. walk_leaves_band walks random choice bits over random
    posteriors (NaN, -inf and positive values among them), so that paths
    leave the band array [0, B) and the walk reads lp 0 / choice 0 there."""
    b = _staging_case("b32" if case == "walk_leaves_band" else case, dtype)
    T = b.T.cpu().numpy()
    st = kk.staging(b.B, b.sig.element_size())
    C, C1 = st.fwd_vit_rows, st.bwd_rows
    assert {"t_not_multiple": T[0] % C and T[0] > C and (T[0] - 1) % C1 and T[0] > C1,
            "t_within_chunk": T[0] <= C and T[0] <= C1,
            "t_eq_t_pad": (T == b.bstart.shape[1]).all()}.get(case, True)
    N_max = int(b.N.max())
    bM, bE = kk.backward_plain(b, LM, LE)
    kM, kE = kk.backward(b, LM, LE)
    torch.cuda.synchronize()
    _same_band(kM, bM, T)
    _same_band(kE, bE, T)
    del kM, kE
    Zb = bE[torch.arange(len(T), device="cuda"), 0, b.bw.long() + 1]
    got = kk.fwd_vit(b, bM, bE, Zb, LM, LE)
    want = kk.fwd_vit_plain(b, bM, bE, Zb, LM, LE)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    _same_band(got[1], want[1], T)
    _same_band(got[2], want[2], T)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)
    assert torch.isfinite(got[3]).all()
    ch, LPM, LPE = want[:3]
    if case == "walk_leaves_band":
        g = torch.Generator().manual_seed(3)
        ch = (torch.rand(ch.shape, generator=g) < 0.7).to(torch.uint8).cuda()
        LPM = (torch.randn(LPM.shape, generator=g, dtype=dtype) * 3).cuda()
        LPE = (torch.randn(LPE.shape, generator=g, dtype=dtype) * 3).cuda()
        LPM[..., ::5] = float("nan")
        LPE[..., 1::7] = float("-inf")
    walked = kk.walk(LPM, LPE, ch, b, N_max)
    plain = kk.walk_plain(LPM, LPE, ch, b, N_max)
    torch.cuda.synchronize()
    for g, w in zip(walked, plain):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    if case == "walk_leaves_band":  # the walk did leave [0, B)
        assert _leaves_band(plain, b, N_max)


def _climbing_case(dtype, device="cuda"):
    """Two reads of 300 bases cut to T 400; read 0's band start climbs by
    one column a row over its top 300 rows and by two at row 300, so that
    the lowest row of K1's top chunk lies a column outside the chunk's
    staged emission window; read 1 keeps its own band starts."""
    model = load_model_for_pore("rna002")
    items = [make_read(model, n_bases=300, seed=11 + s) for s in range(2)]
    items = [(sig[:399], r) for sig, r in items]
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size) for _, r in items]
    b = bb.prepare_batch([s for s, _ in items], kids, model, 400, device=device,
                         dtype=dtype, t_pad_to=512)
    T, N = int(b.T[0]), int(b.N[0])
    t = torch.arange(b.bstart.shape[1], device=b.bstart.device)
    climb = (t - (T - N)).clamp(min=0) + (t >= 300).to(t.dtype)
    bstart = b.bstart.clone()
    bstart[0] = torch.where(t < T, climb, bstart[0, T - 1]).to(torch.int32)
    return b._replace(bstart=bstart)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_banded_bwd_window_exit_gives_nan_z_on_cuda(card, dtype):
    """A band start that climbs by 2 in a row where every other row of
    K1's chunk climbs by 1 leaves the chunk's staged window: K1 turns
    that read's row 0 into NaN, so its Zb is NaN and the Z gate rejects
    it; the other read stays bit for bit its plain version's."""
    b = _climbing_case(dtype)
    T = b.T.cpu().numpy()
    C1 = kk.staging(b.B, b.sig.element_size()).bwd_rows
    assert T[0] - 2 - 300 < C1 <= T[0] - 2 - (T[0] - int(b.N[0]))
    bM, bE = kk.backward(b, LM, LE)
    pM, pE = kk.backward_plain(b, LM, LE)
    torch.cuda.synchronize()
    Zb = bE[torch.arange(2, device="cuda"), 0, b.bw.long() + 1].cpu()
    pZb = pE[torch.arange(2, device="cuda"), 0, b.bw.long() + 1].cpu()
    assert torch.isnan(Zb[0]) and not torch.isnan(pZb[0])
    assert torch.isnan(bM[0, 0]).all() and torch.isnan(bE[0, 0]).all()
    _same_band(bM[1:], pM[1:], T[1:])
    _same_band(bE[1:], pE[1:], T[1:])
    ok = bb.check_z_batch(np.zeros(2), Zb.double().numpy(), T, b.B, dtype)
    assert not ok[0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "t_not_multiple", "t_within_chunk",
                                  "t_eq_t_pad", "b32", "b_max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_staged_training_kernels_match_plain_on_cuda(card, dtype, case):
    """K5 and K6 at the edges of their staged chunks (C5 rows a chunk from
    the bottom up, C6 from the top down, kk.train_staging): fM, fE and bM,
    bE, rawM1, rawE2 bit for bit their plain versions', K6 over the plain
    fE."""
    b = _staging_case(case, dtype)
    T = b.T.cpu().numpy()
    st = kk.train_staging(b.B, b.sig.element_size())
    C5, C6 = st.fwd_rows, st.bwd_train_rows
    assert {"t_not_multiple": T[0] % C5 and T[0] > C5 and (T[0] - 1) % C6 and T[0] - 1 > C6,
            "t_within_chunk": T[0] <= C5 and T[0] - 1 <= C6,
            "t_eq_t_pad": (T == b.bstart.shape[1]).all()}.get(case, True)
    fM, fE = kk.forward(b, LM, LE)
    pM, pE = kk.forward_plain(b, LM, LE)
    torch.cuda.synchronize()
    assert torch.equal(fM, pM) and torch.equal(fE, pE)
    del fM, fE, pM
    got = kk.backward_train(b, pE, LM, LE)
    want = kk.backward_train_plain(b, pE, LM, LE)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.isfinite(got[2]).all() and torch.isfinite(got[3]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "t_not_multiple", "t_within_chunk",
                                  "t_eq_t_pad", "b32", "b_max", "t_one"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_staged_vit_matches_plain_and_fwd_vit_on_cuda(card, dtype, case):
    """K4 at the edges of its staged chunks (C4 rows a chunk from the
    bottom up, kk.staging's vit_rows) over the plain forward and backward
    rows: ch, LPM and LPE bit for bit its plain version's and K2's on the
    same bM, bE and Zb. t_one cuts the ragged bucket's second read to T 1
    among longer reads."""
    b = _staging_case("ragged" if case == "t_one" else case, dtype)
    if case == "t_one":
        b = b._replace(T=torch.where(torch.arange(3, device="cuda") == 1, 1, b.T).int())
    T = b.T.cpu().numpy()
    C4 = kk.staging(b.B, b.sig.element_size()).vit_rows
    assert {"t_not_multiple": lambda: T[0] % C4 and (T[0] - 1) % C4 and T[0] > C4,
            "t_within_chunk": lambda: T[0] <= C4,
            "t_eq_t_pad": lambda: (T == b.bstart.shape[1]).all(),
            "t_one": lambda: T[1] == 1 and (T[[0, 2]] > C4).all()}.get(case, lambda: True)()
    fM, fE = kk.forward_plain(b, LM, LE)
    bM, bE = kk.backward_plain(b, LM, LE)
    Zb = bE[torch.arange(len(T), device="cuda"), 0, b.bw.long() + 1]
    launches = kk.LAUNCHES["banded_vit"]
    got = kk.viterbi_post(b, fM, fE, bM, bE, Zb)
    want = kk.viterbi_post_plain(b, fM, fE, bM, bE, Zb)
    fused = kk.fwd_vit(b, bM, bE, Zb, LM, LE)[:3]
    torch.cuda.synchronize()
    assert kk.LAUNCHES["banded_vit"] == launches + 1
    for g, w, f in zip(got, want, fused):
        assert torch.equal(g, w) and torch.equal(g, f)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vit_launches_at_every_band_width_on_cuda(card, dtype):
    """K4 at every band width it takes (multiples of 32 up to MAX_B, each
    with its own chunk rows and B / 2 threads), on the b32 bucket widened
    with -inf columns: ch, LPM and LPE bit for bit its plain version's."""
    import torch.nn.functional as F

    b = _staging_case("b32", dtype)
    fM, fE = kk.forward_plain(b, LM, LE)
    bM, bE = kk.backward_plain(b, LM, LE)
    Zb = bE[torch.arange(3, device="cuda"), 0, b.bw.long() + 1]
    for B in range(32, kk.MAX_B + 1, 32):
        wide = _widened(b, B)
        rows = [F.pad(x, (0, B - b.B), value=float("-inf")) for x in (fM, fE, bM, bE)]
        got = kk.viterbi_post(wide, *rows, Zb)
        want = kk.viterbi_post_plain(wide, *rows, Zb)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), B


def _window_exits(bstart, T, C, pad, down: bool) -> bool:
    """Whether a row of one read leaves its chunk's staged emission window:
    K6's chunks from the top down (window C + B + 2 wide from
    bstart[hi + 1] - C - 2 + pad, clamped at 0; a row's offset in [0, C + 1]),
    K5's from the bottom up (C + B wide from bstart[t0 - 1] - 2 + pad;
    offsets in [0, C]); the rules of csrc/nt_banded_train.cu."""
    bs = [int(x) for x in bstart]
    if down:
        for hi in range(T - 2, -1, -C):
            lo = max(0, hi - C + 1)
            w0 = max(0, bs[hi + 1] - C - 2 + pad)
            if any(not 0 <= bs[t] - 2 + pad - w0 <= C + 1 for t in range(lo, hi + 1)):
                return True
        return False
    for t0 in range(0, T, C):
        w = bs[max(t0 - 1, 0)]
        if any(not 0 <= bs[t] - w <= C for t in range(max(t0, 1), min(t0 + C, T))):
            return True
    return False


def _jumping_case(dtype, device="cuda"):
    """The climbing case's reads with read 0's band start raised by K5's
    rows a chunk from row 150 on (capped at N - 1), so that a row of K5's
    first chunk lies more than a chunk above the window staged for it."""
    b = _climbing_case(dtype, device)
    C5 = kk.train_staging(b.B, b.sig.element_size()).fwd_rows
    N = int(b.N[0])
    t = torch.arange(b.bstart.shape[1], device=b.bstart.device)
    bstart = b.bstart.clone()
    bstart[0] = torch.where(t >= 150, (bstart[0] + C5).clamp(max=N - 1),
                            bstart[0]).to(torch.int32)
    return b._replace(bstart=bstart)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["banded_fwd", "banded_bwd_train"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_training_kernels_window_exit_gives_nan_z_on_cuda(card, dtype, kernel):
    """A band start that leaves its chunk's staged window: K5 turns that
    read's fE row T-1 into NaN (Zf NaN), K6 its row 0 of bM and bE (Zb
    NaN), so the Z gate rejects it; the other read stays bit for bit its
    plain version's."""
    fwd = kernel == "banded_fwd"
    b = (_jumping_case if fwd else _climbing_case)(dtype)
    T = b.T.cpu().numpy()
    st = kk.train_staging(b.B, b.sig.element_size())
    C = st.fwd_rows if fwd else st.bwd_train_rows
    bstart = b.bstart.cpu()
    assert _window_exits(bstart[0], int(T[0]), C, b.pad, not fwd)
    assert not _window_exits(bstart[1], int(T[1]), C, b.pad, not fwd)
    r = torch.arange(2, device="cuda")
    pM, pE = kk.forward_plain(b, LM, LE)
    if fwd:
        got, want = kk.forward(b, LM, LE), (pM, pE)
        Z = got[1][r, b.T.long() - 1, b.bw.long() + 1].cpu()
        pZ = pE[r, b.T.long() - 1, b.bw.long() + 1].cpu()
        assert torch.isnan(got[1][0, T[0] - 1]).all()
    else:
        got = kk.backward_train(b, pE, LM, LE)
        want = kk.backward_train_plain(b, pE, LM, LE)
        Z = got[1][r, 0, b.bw.long() + 1].cpu()
        pZ = want[1][r, 0, b.bw.long() + 1].cpu()
        assert torch.isnan(got[0][0, 0]).all() and torch.isnan(got[1][0, 0]).all()
        assert torch.equal(got[2][1:], want[2][1:]) and torch.equal(got[3][1:], want[3][1:])
    torch.cuda.synchronize()
    assert torch.isnan(Z[0]) and not torch.isnan(pZ[0])
    _same_band(got[0][1:], want[0][1:], T[1:])
    _same_band(got[1][1:], want[1][1:], T[1:])
    ok = bb.check_z_batch(np.zeros(2), Z.double().numpy(), T, b.B, dtype)
    assert not ok[0]


def _leaves_band(walked, b, N_max) -> bool:
    """Whether some read's walk reaches a column outside [0, B): replayed
    on the host from the recorded bases and closes."""
    path_n, _, close = (x.cpu() for x in walked)
    bs = b.bstart.cpu()
    for i in range(path_n.shape[0]):
        j, T = int(b.bw[i]) + 1, int(b.T[i])
        for t in range(T - 1, 0, -1):
            if int(path_n[i, t - 1]) == N_max:
                break
            if not 0 <= j < b.B:
                return True
            s = int(bs[i, t] != bs[i, t - 1])
            j = j - 1 + s if bool(close[i, t - 1]) else j + s
    return False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_training_kernels_match_plain_on_cuda(card, dtype):
    """K5 fM/fE and K6 bM/bE, rawM1/rawE2 bit for bit: the plain version
    folds the numerators in the kernel's order and reduces the band in
    the kernel's tree order."""
    model, items, kids = _reads()
    b = bb.prepare_batch([s for s, _ in items], kids, model, device="cuda",
                         dtype=dtype, t_pad_to=256)
    launches = dict(kk.LAUNCHES)
    fM, fE = kk.forward(b, LM, LE)
    pfM, pfE = kk.forward_plain(b, LM, LE)
    assert torch.equal(fM, pfM) and torch.equal(fE, pfE)
    got = kk.backward_train(b, pfE, LM, LE)
    want = kk.backward_train_plain(b, pfE, LM, LE)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kk.LAUNCHES["banded_fwd"] == launches["banded_fwd"] + 1
    assert kk.LAUNCHES["banded_bwd_train"] == launches["banded_bwd_train"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_matrix_route_kernels_match_plain_on_cuda(card, dtype):
    """K4 over K5's and K1's stored rows: ch, LPM, LPE bit for bit its
    plain version's and K2's on the same bucket (one Viterbi step in
    both); bb.banded_batch_run launches K5, K1 and K4 once each."""
    model, items, kids = _reads()
    b = bb.prepare_batch([s for s, _ in items], kids, model, device="cuda",
                         dtype=dtype, t_pad_to=256)
    fM, fE = kk.forward(b, LM, LE)
    bM, bE = kk.backward(b, LM, LE)
    Zb = bE[torch.arange(3, device="cuda"), 0, b.bw.long() + 1]
    got = kk.viterbi_post(b, fM, fE, bM, bE, Zb)
    want = kk.viterbi_post_plain(b, fM, fE, bM, bE, Zb)
    fused = kk.fwd_vit(b, bM, bE, Zb, LM, LE)[:3]
    torch.cuda.synchronize()
    for g, w, f in zip(got, want, fused):
        assert torch.equal(g, w) and torch.equal(g, f)
    launches = dict(kk.LAUNCHES)
    res = bb.banded_batch_run(b, LM, LE)
    torch.cuda.synchronize()
    assert all(kk.LAUNCHES[k] == launches[k] + 1 for k in kk.MATRIX_KERNELS)
    assert torch.equal(res.choices, got[0].bool())


@pytest.mark.cuda
def test_batch_train_repeats_bit_for_bit_on_cuda(card):
    """Two runs of the training op on the card give identical estimates
    (no atomics in the position and k-mer sums)."""
    model, items, kids = _reads()
    b = bb.prepare_batch([s for s, _ in items], kids, model, device="cuda",
                         dtype=torch.float32, t_pad_to=256)
    kid_pad = np.zeros((3, max(len(k) for k in kids)), np.int32)
    for i, k in enumerate(kids):
        kid_pad[i, : len(k)] = k
    a = banded_batch_train(b, LM, LE, kid_pad, model.num_kmers)
    c = banded_batch_train(b, LM, LE, kid_pad, model.num_kmers)
    for x, y in zip(a, c):
        assert torch.equal(x, y)


def _ntc_bucket(dtype, full_row=False):
    """The three ragged reads of tests/test_torch_ntc_pre.py on the card,
    padded to (3, 320) with N2 48, and the model tables; with full_row a
    fourth read of 36 bases cut to T_r = T_pad = 320."""
    from dynamont_tpu_torch.ops import ntc_batch as nb

    model = load_model_for_pore("rna002")
    spec = ((0, 25), (1, 31), (2, 18)) + (((3, 36),) if full_row else ())
    reads = [make_read(model, n_bases=n, seed=s) for s, n in spec]
    R = len(reads)
    sig = np.zeros((R, 319))
    kid = np.zeros((R, 47), np.int32)
    T, N = np.zeros(R, np.int32), np.zeros(R, np.int32)
    for i, (s, r) in enumerate(reads):
        s = s[:319]
        k = seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size)
        sig[i, : len(s)], kid[i, : len(k)] = s, k
        T[i], N[i] = len(s) + 1, len(k) + 1
    cuda = lambda a: torch.from_numpy(np.asarray(a)).cuda()
    means, c1, c2 = model.score_params()
    tab = nb.tn_tables(cuda(kid), cuda(model.means), cuda(model.stdevs), dtype)
    tabk = nb.tk_tables(cuda(means), cuda(c1), cuda(c2), dtype)
    return cuda(sig).to(dtype), cuda(kid), cuda(N), cuda(T), tab, tabk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ntc_pre_kernels_match_plain_on_cuda(card, dtype):
    """K7-K10 against their plain versions: the TN forward store, the TN
    pack and E0, the TK backward store, U and finalE bit for bit, and the
    selections made from them identical."""
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

    sig, kid, N, T, tab, tabk = _ntc_bucket(dtype)
    launches = dict(kn.LAUNCHES)
    same = lambda g, w: torch.testing.assert_close(g, w, rtol=0, atol=0,
                                                   equal_nan=True)
    fwd = kn.tn_fwd_plain(sig, tab, N, LM, LE)
    same(kn.tn_fwd(sig, tab, N, LM, LE), fwd)
    got = kn.tn_bwd_sel(sig, tab, kid, N, T, fwd, 8, LM, LE)
    want = kn.tn_bwd_sel_plain(sig, tab, kid, N, T, fwd, 8, LM, LE)
    for g, w in zip(got, want):
        same(g, w)
    for g, w in zip(nb.tn_select(got[0], T, 8, 48).values(),
                    nb.tn_select(want[0], T, 8, 48).values()):
        same(g, w)
    bwd = kn.tk_bwd_plain(sig, tabk, T, 4, LM, LE)
    same(kn.tk_bwd(sig, tabk, T, 4, LM, LE), bwd)
    got = kn.tk_fwd_u(sig, tabk, T, bwd, 4, LM, LE)
    want = kn.tk_fwd_u_plain(sig, tabk, T, bwd, 4, LM, LE)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        same(g, w)
    assert all(kn.LAUNCHES[k] == launches[k] + 1 for k in kn.KERNELS)


def _tk_case(K, dtype):
    """(sig, tabk, T_r) on the card for K9/K10 at K columns: the rna002
    table at K 1024, a seeded synthetic one elsewhere (means U(-2, 2),
    stdevs U(0.15, 0.4)); five reads of a signal drawn from the table
    (dwell 9) in a bucket of T_pad 1125, two signal stages of TK_CHUNK 512
    and a partial third, at T_r = T_pad, with T_r - 1 at the last row of
    K10's first stage (512), at the lowest row of K9's first (612), inside
    a stage (300) and at 1."""
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

    rng = np.random.default_rng(K)
    if K == 1024:
        model = load_model_for_pore("rna002")
        mu, sd = model.means, model.stdevs
    else:
        mu, sd = rng.uniform(-2.0, 2.0, K), rng.uniform(0.15, 0.4, K)
    c1 = -0.5 * 1.8378770664093453 - np.log(sd)
    c2 = 0.5 / (sd * sd)
    T_pad = 2 * kn.TK_CHUNK + 101
    T_r = np.array([T_pad, kn.TK_CHUNK + 1, T_pad - kn.TK_CHUNK, 301, 2], np.int32)
    ks = rng.integers(0, K, size=(len(T_r), T_pad // 9 + 1)).repeat(9, axis=1)[:, : T_pad - 1]
    sig = rng.normal(mu[ks], sd[ks])
    sig[np.arange(T_pad - 1)[None, :] >= T_r[:, None] - 1] = 0.0
    cuda = lambda a: torch.from_numpy(np.asarray(a)).cuda()
    tabk = nb.tk_tables(cuda(mu), cuda(c1), cuda(c2), dtype)
    return cuda(sig).to(dtype), tabk, cuda(T_r)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [16, 256, 1024, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ntc_tk_kernels_match_plain_on_cuda(card, dtype, K):
    """K9 and K10 (whole k-mer groups a thread, tk_geometry's launch)
    against their plain versions on ragged reads across signal stages:
    the TK backward store, U and finalE bit for bit, one launch each."""
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

    sig, tabk, T_r = _tk_case(K, dtype)
    same = lambda g, w: torch.testing.assert_close(g, w, rtol=0, atol=0,
                                                   equal_nan=True)
    launches = dict(kn.LAUNCHES)
    bwd = kn.tk_bwd_plain(sig, tabk, T_r, 4, LM, LE)
    same(kn.tk_bwd(sig, tabk, T_r, 4, LM, LE), bwd)
    got = kn.tk_fwd_u(sig, tabk, T_r, bwd, 4, LM, LE)
    want = kn.tk_fwd_u_plain(sig, tabk, T_r, bwd, 4, LM, LE)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        same(g, w)
    assert torch.isfinite(want[1]).all()  # every read reaches its row T_r - 1
    assert {k: kn.LAUNCHES[k] - launches[k] for k in ("ntc_tk_bwd", "ntc_tk_fwd_u")} == \
        {"ntc_tk_bwd": 1, "ntc_tk_fwd_u": 1}


def _sel_rows(n2, dtype):
    """(u (4, 3, n2), kid (3, n2-1)) on the card: normal rows, a tie for
    the max at three columns, a row of one value, a row with 2 finite
    columns (exhausted for cap > 2), a row all -inf, ties at the cap
    boundary (tests/test_torch_ntc_pre.py's rows)."""
    rng = np.random.default_rng(n2)
    u = rng.normal(scale=3.0, size=(4, 3, n2))
    u[0, 1, [1, n2 // 2, n2 - 1]] = 9.0
    u[0, 2, :] = 1.5
    u[1, 0, :] = -np.inf
    u[1, 0, [3 % n2, n2 - 2]] = [0.5, 0.25]
    u[1, 1, :] = -np.inf
    u[2, 2, ::3] = 4.0
    kid = rng.integers(0, 1024, size=(3, n2 - 1)).astype(np.int32)
    return torch.from_numpy(u).to(dtype).cuda(), torch.from_numpy(kid).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ntc_tn_bwd_sel_kernels_match_plain_on_cuda(card, dtype):
    """K8's two kernels against their plain functions, bit for bit: the
    chain (tn_bwd_u: the u store and E0) on the short reads, and the
    selection (tn_sel) on its plain u there and on rows with ties and
    exhausted rows at N2 8, 64, 96 and 2048 (B 8, 64, 32, 512: the B <= 32
    path and the warp-sum path), caps 1, 8 and 16."""
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

    same = lambda g, w: torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    sig, kid, N, T, tab, _ = _ntc_bucket(dtype)
    fwd = kn.tn_fwd_plain(sig, tab, N, LM, LE)
    parts = dict(kn.TN_BWD_SEL_LAUNCHES)
    u, E0 = kn.tn_bwd_u(sig, tab, N, T, fwd, LM, LE)
    pu, pE0 = kn.tn_bwd_u_plain(sig, tab, N, T, fwd, LM, LE)
    same(u, pu)
    same(E0, pE0)
    for cap in (1, 8, 16):
        same(kn.tn_sel(pu, kid, cap), kn.tn_sel_plain(pu, kid, cap))
    n_sel = 3
    for n2 in (8, 64, 96, 2048):
        u, kid = _sel_rows(n2, dtype)
        for cap in (1, 8, 16):
            if cap <= n2:
                same(kn.tn_sel(u, kid, cap), kn.tn_sel_plain(u, kid, cap))
                n_sel += 1
    torch.cuda.synchronize()
    assert kn.TN_BWD_SEL_LAUNCHES == {"tn_bwd_u": parts["tn_bwd_u"] + 1,
                                      "tn_sel": parts["tn_sel"] + n_sel}


@pytest.mark.cuda
def test_ntc_per_read_cuda_matches_cpu(card):
    """The exact per-read NTC on the card against the plain route: borders
    and polish k-mers identical, probabilities within 1e-9, Z within rel
    1e-12; no pre-pass kernel launched."""
    from dynamont_tpu_torch.models.ntc import run_ntc
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

    model = load_model_for_pore("rna002")
    sig, read = make_read(model, n_bases=25, seed=0)
    launches = dict(kn.LAUNCHES)
    got = run_ntc(sig, read, model, "rna002", device="cuda")
    want = run_ntc(sig, read, model, "rna002", device="cpu")
    assert kn.LAUNCHES == launches
    assert abs(got.Z - want.Z) <= 1e-12 * abs(want.Z)
    assert [s[:3] + s[4:] for s in got.segments] == [s[:3] + s[4:] for s in want.segments]
    assert max(abs(g[3] - w[3]) for g, w in zip(got.segments, want.segments)) <= 1e-9


def test_lattice_wrappers_refuse_other_devices():
    """The NTC lattice wrappers take the plain version only for CPU
    tensors; any other non-CUDA device raises."""
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    runs = dict(kern.PLAIN_RUNS)
    ks = torch.zeros((4, 2 * 8 + 2 * 2), dtype=torch.int32, device="meta")
    table = torch.zeros((15, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kern.tab_gather(ks, table, nb.PlanDims(1, 2, 8, 4))
    with pytest.raises(ValueError, match="cuda or cpu"):
        kern.table_gather(ks, torch.zeros((16, 16), device="meta"))
    assert kern.PLAIN_RUNS == runs


@pytest.mark.cuda
def test_table_gather_matches_plain_on_cuda(card):
    """#12 against its plain version, bit for bit: ks (8, 512) at K = 1024
    with the sentinels K and -1 mixed in."""
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    mu, c1, c2 = load_model_for_pore("rna002").score_params()
    tabT = nb.combined_tablesT(*(torch.from_numpy(x).cuda() for x in (mu, c1, c2)), 4)
    rng = np.random.default_rng(12)
    ks = rng.integers(-1, 1025, size=(8, 512)).astype(np.int32)
    ks = torch.from_numpy(ks).cuda()
    launches = kern.LAUNCHES["ntc_table_gather"]
    got = kern.table_gather(ks, tabT)
    want = kern.table_gather_plain(ks, tabT)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kern.LAUNCHES["ntc_table_gather"] == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(8, 120), (16, 240)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ntc_lattice_kernels_match_plain_on_cuda(card, dtype, caps):
    """K11, K13, K14, K15 (lp written over the store, and its checkpoint
    mode) and K16 against their plain versions on the short reads: every
    output bit for bit; K14's checkpoints are K13's rows (c+1)*8 and its
    row 0 K13's, and K15's checkpoint mode gives the full-store K15's
    outputs."""
    from dynamont_tpu_torch.constants import NTK_TRANSITIONS
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_walk as nw

    sig, kid, N, T, _, _ = _ntc_bucket(dtype)
    model = load_model_for_pore("rna002")
    cuda = lambda a: torch.from_numpy(np.asarray(a, np.float64)).cuda()
    means, c1, c2 = (cuda(a) for a in model.score_params())
    tl = {k: math.log(v) for k, v in NTK_TRANSITIONS["rna002"].items()}
    pn = nb.pre_tn_batch(sig, kid, N, T, means, cuda(model.stdevs), LM, LE, caps[0], dtype)
    pk = nb.pre_tk_batch(sig, T, means, c1, c2, LM, LE, 4, caps[1], dtype)
    plan, dims = nb.build_plan_batch(pn.cand, pn.cnt, pk.cand, pk.cnt, kid, N, 1024, 4, 5,
                                     pn.kn1, pn.kn2)
    table = nb.combined_tables(means, c1, c2, 4, dtype)
    same = lambda g, w: torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    launches = dict(kern.LAUNCHES)
    ks = nb.gather_index(plan)
    prm = kern.tab_gather_plain(ks, table, dims)
    for g, w in zip(kern.tab_gather(ks, table, dims), prm):
        same(g, w)
    bwd = kern.bwd_plain(plan, dims, prm, sig, tl, N, T)
    same(kern.bwd(plan, dims, prm, sig, tl, N, T), bwd)
    Zb = nb.ntc_zb_batch(plan, bwd[0])
    store = bwd.clone()
    got = kern.pv(plan, dims, prm, sig, store, Zb, tl, T, out=store)
    want = kern.pv_plain(plan, dims, prm, sig, bwd, Zb, tl, T)
    for g, w in zip(got, want):
        same(g, w)
    ckpt, row0 = kern.bwd_ckpt(plan, dims, prm, sig, tl, N, T)
    for g, w in zip((ckpt, row0), kern.bwd_ckpt_plain(plan, dims, prm, sig, tl, N, T)):
        same(g, w)
    C = nb.C_CKPT
    same(ckpt[:-1], bwd[C::C])
    same(row0, bwd[0])
    got_ck = kern.pv_ckpt(plan, dims, prm, sig, ckpt, Zb, tl, N, T)
    for g, w, p in zip(got_ck, want, kern.pv_ckpt_plain(plan, dims, prm, sig, ckpt, Zb,
                                                         tl, N, T)):
        same(g, p)
        same(g, w)
    lp, ch, slots, apE, _ = want
    args = (lp, ch, slots, plan, *nw.start_slots(plan, apE, N, T), N, T, 1024, 4, 5, 128)
    torch.cuda.synchronize()
    for g, w in zip(kern.walk(*args), kern.walk_plain(*args)):
        same(g, w)
    assert all(kern.LAUNCHES[k] == launches[k] + 1 for k in kern.LATTICE_KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(8, 120), (16, 240)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ntc_pv_instances_match_plain_on_cuda(card, dtype, caps):
    """K15's full store in the instance its shape takes (the shared-column
    one at (8, 120), CK 128; the device-memory one at (16, 240), CK 256)
    against pv_plain on four reads of different T_r, one at T_r = T_pad:
    lp (written over the store), choices, slots, apEf and fwdEf bit for
    bit, and the launch counted under that instance."""
    from dynamont_tpu_torch.constants import NTK_TRANSITIONS
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    sig, kid, N, T, _, _ = _ntc_bucket(dtype, full_row=True)
    assert len(set(T.tolist())) == 4 and int(T.max()) == sig.shape[1] + 1
    model = load_model_for_pore("rna002")
    cuda = lambda a: torch.from_numpy(np.asarray(a, np.float64)).cuda()
    means, c1, c2 = (cuda(a) for a in model.score_params())
    tl = {k: math.log(v) for k, v in NTK_TRANSITIONS["rna002"].items()}
    pn = nb.pre_tn_batch(sig, kid, N, T, means, cuda(model.stdevs), LM, LE, caps[0], dtype)
    pk = nb.pre_tk_batch(sig, T, means, c1, c2, LM, LE, 4, caps[1], dtype)
    plan, dims = nb.build_plan_batch(pn.cand, pn.cnt, pk.cand, pk.cnt, kid, N, 1024, 4, 5,
                                     pn.kn1, pn.kn2)
    prm = kern.tab_gather_plain(nb.gather_index(plan), nb.combined_tables(means, c1, c2, 4,
                                                                          dtype), dims)
    bwd = kern.bwd_plain(plan, dims, prm, sig, tl, N, T)
    Zb = nb.ntc_zb_batch(plan, bwd[0])
    inst = kern.pv_instance(dims.CN, dims.CK, dims.A, sig.element_size())
    assert (dims.CK, inst.name) == {(8, 120): (128, "shared"), (16, 240): (256, "device")}[caps]
    before = dict(kern.PV_LAUNCHES)
    store = bwd.clone()
    got = kern.pv(plan, dims, prm, sig, store, Zb, tl, T, out=store)
    want = kern.pv_plain(plan, dims, prm, sig, bwd, Zb, tl, T)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert {k: kern.PV_LAUNCHES[k] - before[k] for k in before} == \
        {k: int(k == inst.name) for k in before}


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(8, 120), (16, 240)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ntc_bwd_instances_match_plain_on_cuda(card, dtype, caps):
    """K13 in the instance its shape takes (the shared-column one at (8,
    120), CK 128; bwd_kernel at (16, 240), CK 256) against bwd_plain on
    four reads of different T_r, one at T_r = T_pad: the store bit for
    bit, and the launch counted under that instance."""
    from dynamont_tpu_torch.constants import NTK_TRANSITIONS
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    sig, kid, N, T, _, _ = _ntc_bucket(dtype, full_row=True)
    assert len(set(T.tolist())) == 4 and int(T.max()) == sig.shape[1] + 1
    model = load_model_for_pore("rna002")
    cuda = lambda a: torch.from_numpy(np.asarray(a, np.float64)).cuda()
    means, c1, c2 = (cuda(a) for a in model.score_params())
    tl = {k: math.log(v) for k, v in NTK_TRANSITIONS["rna002"].items()}
    pn = nb.pre_tn_batch(sig, kid, N, T, means, cuda(model.stdevs), LM, LE, caps[0], dtype)
    pk = nb.pre_tk_batch(sig, T, means, c1, c2, LM, LE, 4, caps[1], dtype)
    plan, dims = nb.build_plan_batch(pn.cand, pn.cnt, pk.cand, pk.cnt, kid, N, 1024, 4, 5,
                                     pn.kn1, pn.kn2)
    prm = kern.tab_gather_plain(nb.gather_index(plan), nb.combined_tables(means, c1, c2, 4,
                                                                          dtype), dims)
    inst = kern.bwd_instance(dims.CN, dims.CK, dims.A, sig.element_size())
    assert (dims.CK, inst.name) == {(8, 120): (128, "shared"), (16, 240): (256, "device")}[caps]
    before = dict(kern.BWD_LAUNCHES)
    got = kern.bwd(plan, dims, prm, sig, tl, N, T)
    want = kern.bwd_plain(plan, dims, prm, sig, tl, N, T)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert {k: kern.BWD_LAUNCHES[k] - before[k] for k in before} == \
        {k: int(k == inst.name) for k in before}


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(16, 240), (16, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ntc_ckpt_cluster_instances_match_plain_on_cuda(card, dtype, caps):
    """K14 and K15's checkpoint mode in the instances their shape takes
    (the cluster ones at the wide rung's (16, 240), CK 256; at native big
    K's (16, 256), CK 272, K15's fp32 keeps pv_kernel<S, true>) and at
    every other cluster size the pickers allow there, against their plain
    versions on four reads of different T_r, one at T_r = T_pad: the
    checkpoints, row 0, lp, choices, slots, apEf and fwdEf bit for bit,
    and each launch counted under its instance."""
    from dynamont_tpu_torch.constants import NTK_TRANSITIONS
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern

    sig, kid, N, T, _, _ = _ntc_bucket(dtype, full_row=True)
    assert len(set(T.tolist())) == 4 and int(T.max()) == sig.shape[1] + 1
    model = load_model_for_pore("rna002")
    cuda = lambda a: torch.from_numpy(np.asarray(a, np.float64)).cuda()
    means, c1, c2 = (cuda(a) for a in model.score_params())
    tl = {k: math.log(v) for k, v in NTK_TRANSITIONS["rna002"].items()}
    pn = nb.pre_tn_batch(sig, kid, N, T, means, cuda(model.stdevs), LM, LE, caps[0], dtype)
    pk = nb.pre_tk_batch(sig, T, means, c1, c2, LM, LE, 4, caps[1], dtype)
    plan, dims = nb.build_plan_batch(pn.cand, pn.cnt, pk.cand, pk.cnt, kid, N, 1024, 4, 5,
                                     pn.kn1, pn.kn2)
    prm = kern.tab_gather_plain(nb.gather_index(plan), nb.combined_tables(means, c1, c2, 4,
                                                                          dtype), dims)
    isz = sig.element_size()
    b_inst = kern.bwd_ckpt_instance(dims.CN, dims.CK, dims.A, isz)
    p_inst = kern.pv_ckpt_instance(dims.CN, dims.CK, dims.A, isz)
    want_pv = "device" if (caps, isz) == ((16, 256), 4) else "cluster"
    assert (dims.CK, b_inst.name, p_inst.name) == ({(16, 240): 256, (16, 256): 272}[caps],
                                                   "cluster", want_pv)
    same = lambda g, w: torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)

    def sizes(pick):
        out = []
        for G in kern.CLUSTER_SIZES + (1,):
            try:
                out.append(pick(dims.CN, dims.CK, dims.A, isz, G))
            except ValueError:
                pass  # no cluster of G at this shape
        return out

    ckpt, row0 = kern.bwd_ckpt_plain(plan, dims, prm, sig, tl, N, T)
    for inst in sizes(kern.bwd_ckpt_instance):
        before = dict(kern.BWD_CKPT_LAUNCHES)
        got = kern.bwd_ckpt(plan, dims, prm, sig, tl, N, T, G=inst.G)
        torch.cuda.synchronize()
        same(got[0], ckpt)
        same(got[1], row0)
        assert {k: kern.BWD_CKPT_LAUNCHES[k] - before[k] for k in before} == \
            {k: int(k == inst.name) for k in before}, inst
    Zb = nb.ntc_zb_batch(plan, row0)
    want = kern.pv_ckpt_plain(plan, dims, prm, sig, ckpt, Zb, tl, N, T)
    for inst in sizes(kern.pv_ckpt_instance):
        before = dict(kern.PV_CKPT_LAUNCHES)
        got = kern.pv_ckpt(plan, dims, prm, sig, ckpt, Zb, tl, N, T, G=inst.G)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            same(g, w)
        assert {k: kern.PV_CKPT_LAUNCHES[k] - before[k] for k in before} == \
            {k: int(k == inst.name) for k in before}, inst


def test_train_wrappers_refuse_other_devices():
    """The NTC training wrappers take the plain version only for CPU
    tensors; any other non-CUDA device raises."""
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk

    runs = dict(tk.PLAIN_RUNS)
    sig = torch.zeros((1, 7), device="meta")
    dims = nb.PlanDims(1, 2, 8, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.fwd_store(None, dims, None, sig, {})
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.train(None, dims, None, sig, None, None, {}, None, None, 16)
    assert tk.PLAIN_RUNS == runs


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(8, 120), (16, 240)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ntc_train_kernels_match_plain_on_cuda(card, dtype, caps):
    """K17 (forward store) and K18 (training sums) against their plain
    versions on the short reads, in every instance the wrappers run at the
    shape (the picked one and the device-memory one): every output bit for
    bit, each launch counted under its instance; K17's row T_r-1 E is K15's
    fwdEf and K18's b0 K13's row 0."""
    from dynamont_tpu_torch.constants import NTK_TRANSITIONS
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_train_kernels as tk

    sig, kid, N, T, _, _ = _ntc_bucket(dtype)
    model = load_model_for_pore("rna002")
    cuda = lambda a: torch.from_numpy(np.asarray(a, np.float64)).cuda()
    means, c1, c2 = (cuda(a) for a in model.score_params())
    tl = {k: math.log(v) for k, v in NTK_TRANSITIONS["rna002"].items()}
    pn = nb.pre_tn_batch(sig, kid, N, T, means, cuda(model.stdevs), LM, LE, caps[0], dtype)
    pk = nb.pre_tk_batch(sig, T, means, c1, c2, LM, LE, 4, caps[1], dtype)
    plan, dims = nb.build_plan_batch(pn.cand, pn.cnt, pk.cand, pk.cnt, kid, N, 1024, 4, 5,
                                     pn.kn1, pn.kn2)
    prm = kern.tab_gather(nb.gather_index(plan), nb.combined_tables(means, c1, c2, 4, dtype),
                          dims)
    same = lambda g, w: torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    isz = sig.element_size()
    instances = lambda pick: {pick(dims.CN, dims.CK, dims.A, isz).name, "device"}
    fwd = tk.fwd_store_plain(plan, dims, prm, sig, tl)
    for inst in instances(tk.fwd_store_instance):
        launches, by_inst = dict(tk.LAUNCHES), dict(tk.FWD_STORE_LAUNCHES)
        same(tk.fwd_store(plan, dims, prm, sig, tl, instance=inst), fwd)
        assert tk.LAUNCHES["ntc_fwd_store"] == launches["ntc_fwd_store"] + 1
        assert {k: tk.FWD_STORE_LAUNCHES[k] - by_inst[k] for k in by_inst} == \
            {k: int(k == inst) for k in by_inst}, inst
    r = torch.arange(dims.R, device="cuda")
    Zf = nb.ntc_zf_batch(plan, fwd[T.long() - 1, r, nb.E_ST], N, T)
    want = tk.train_plain(plan, dims, prm, sig, fwd, Zf, tl, N, T, 1024)
    bwd = kern.bwd(plan, dims, prm, sig, tl, N, T)
    for inst in instances(tk.train_instance):
        launches, by_inst = dict(tk.LAUNCHES), dict(tk.TRAIN_LAUNCHES)
        got = tk.train(plan, dims, prm, sig, fwd, Zf, tl, N, T, 1024, instance=inst)
        for g, w in zip(got, want):
            same(g, w)
        same(got[2], bwd[0])
        assert tk.LAUNCHES["ntc_train"] == launches["ntc_train"] + 1
        assert {k: tk.TRAIN_LAUNCHES[k] - by_inst[k] for k in by_inst} == \
            {k: int(k == inst) for k in by_inst}, inst
    fwdEf = kern.pv(plan, dims, prm, sig, bwd, nb.ntc_zb_batch(plan, bwd[0]), tl, T)[4]
    same(fwd[T.long() - 1, r, nb.E_ST], fwdEf)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pre_tk_ckpt_matches_dense_kernels_on_cuda(card, dtype):
    """The checkpoint-recompute TK pre-pass (torch ops on the card, the
    plain K9/K10 columns) against the dense route through K9 and K10 on
    the short reads: candidates, counts, overflow, Zf and Zb bit for bit."""
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

    sig, _, _, T, _, _ = _ntc_bucket(dtype)
    model = load_model_for_pore("rna002")
    means, c1, c2 = (torch.from_numpy(a).cuda() for a in model.score_params())
    launches = dict(kn.LAUNCHES)
    dense = nb.pre_tk_batch(sig, T, means, c1, c2, LM, LE, 4, 120, dtype)
    assert kn.LAUNCHES["ntc_tk_bwd"] == launches["ntc_tk_bwd"] + 1
    ckpt = nb.pre_tk_batch_ckpt(sig, T, means, c1, c2, LM, LE, 4, 120, dtype, chunk=64)
    for f in ("cand", "cnt", "overflow", "Zf", "Zb"):
        torch.testing.assert_close(getattr(ckpt, f), getattr(dense, f), rtol=0, atol=0,
                                   equal_nan=True, msg=f)


def _tn_case(N2, T_pad, dtype):
    """(sig, tab, N_r) on the card for K7 at width N2: four reads of a
    signal drawn from the rna002 table along random k-mer ids (dwell 9),
    one with N2 - 1 live k-mer positions (N_r = N2), the others ragged."""
    from dynamont_tpu_torch.ops import ntc_batch as nb

    model = load_model_for_pore("rna002")
    rng = np.random.default_rng(N2 * 7 + T_pad)
    N = np.array([N2, N2 // 2 + 1, 2, max(2, N2 - 3)], np.int32)
    kid = rng.integers(0, model.num_kmers, size=(4, N2 - 1)).astype(np.int32)
    kid[np.arange(N2 - 1)[None, :] >= N[:, None] - 1] = 0
    dwell = kid[:, np.minimum(np.arange(T_pad - 1) // 9, N2 - 2)]
    sig = rng.normal(model.means[dwell], model.stdevs[dwell])
    cuda = lambda a: torch.from_numpy(np.asarray(a)).cuda()
    tab = nb.tn_tables(cuda(kid), cuda(model.means), cuda(model.stdevs), dtype)
    return cuda(sig).to(dtype), tab, cuda(N)


@pytest.mark.cuda
@pytest.mark.parametrize("N2", [64, 1000, 2048, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ntc_tn_fwd_matches_plain_on_cuda(card, dtype, N2):
    """K7 (tn_fwd_geometry's contiguous columns: 32, 256, 512 threads of 4
    and 512 of 8) against its plain version on ragged reads, with T_pad - 1
    just below, on and just above the signal stage (TK_CHUNK): the forward
    store bit for bit, one launch each."""
    from dynamont_tpu_torch.ops import ntc_pre_kernels as kn

    for Tm1 in (kn.TK_CHUNK - 1, kn.TK_CHUNK, kn.TK_CHUNK + 1):
        sig, tab, N_r = _tn_case(N2, Tm1 + 1, dtype)
        launches = kn.LAUNCHES["ntc_tn_fwd"]
        got = kn.tn_fwd(sig, tab, N_r, LM, LE)
        assert kn.LAUNCHES["ntc_tn_fwd"] == launches + 1
        want = kn.tn_fwd_plain(sig, tab, N_r, LM, LE)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        assert torch.isfinite(want[Tm1, 1, 0, 1:]).any()  # the full read reaches its last row


def _walk_lattice(dtype, caps):
    """K16's inputs from the engine's lattice on the short reads at caps:
    the plain pre-pass, plan, backward and posterior-Viterbi (lp, choices,
    slots) and the start slots, all on the card."""
    from dynamont_tpu_torch.constants import NTK_TRANSITIONS
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_walk as nw

    sig, kid, N, T, _, _ = _ntc_bucket(dtype)
    model = load_model_for_pore("rna002")
    cuda = lambda a: torch.from_numpy(np.asarray(a, np.float64)).cuda()
    means, c1, c2 = (cuda(a) for a in model.score_params())
    tl = {k: math.log(v) for k, v in NTK_TRANSITIONS["rna002"].items()}
    pn = nb.pre_tn_batch(sig, kid, N, T, means, cuda(model.stdevs), LM, LE, caps[0], dtype)
    pk = nb.pre_tk_batch(sig, T, means, c1, c2, LM, LE, 4, caps[1], dtype)
    plan, dims = nb.build_plan_batch(pn.cand, pn.cnt, pk.cand, pk.cnt, kid, N, 1024, 4, 5,
                                     pn.kn1, pn.kn2)
    prm = kern.tab_gather_plain(nb.gather_index(plan), nb.combined_tables(means, c1, c2, 4,
                                                                          dtype), dims)
    bwd = kern.bwd_plain(plan, dims, prm, sig, tl, N, T)
    lp, ch, slots, apE, _ = kern.pv_plain(plan, dims, prm, sig, bwd,
                                          nb.ntc_zb_batch(plan, bwd[0]), tl, T)
    return (lp, ch, slots, plan, *nw.start_slots(plan, apE, N, T), N, T)


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(8, 120), (16, 240)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ntc_walk_matches_plain_on_cuda(card, dtype, caps):
    """K16 (rows staged in chunks of walk_geometry's C, lp gathered a
    chunk behind) against its plain version, records and fin bit for bit,
    one launch each: on the engine's lattice of the short reads (CK padded
    to 128 or 256: the tensor-copy instance), and on hand-built rows
    (tests/test_torch_ntc_tn_walk_layout.walk_rows: a walk across every
    chunk boundary, I-chains of two steps, a stuck read, an invalid read, a
    read shorter than the bucket, random reads) at 3 and at 40 chunks, at
    the caps (the cp.async instance) and as the engine pads them."""
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from test_torch_ntc_tn_walk_layout import walk_rows

    same = lambda g, w: torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    padded = (caps[0], 128 * -(-caps[1] // 128))
    cases = [(padded, _walk_lattice(dtype, caps), False)]
    for dims in (caps, padded):
        C = kern.walk_geometry(*dims).rows
        cases += [(dims, walk_rows(n * C + 3, *dims, dtype, seed=n, device="cuda"), True)
                  for n in (2, 39)]
    for dims, args, hand_built in cases:
        inst = kern.walk_geometry(*dims).instance
        launches = dict(kern.WALK_LAUNCHES)
        got = kern.walk(*args, 1024, 4, 5, 128)
        assert kern.WALK_LAUNCHES == {k: v + (k == inst) for k, v in launches.items()}
        want = kern.walk_plain(*args, 1024, 4, 5, 128)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            same(g, w)
        if hand_built:
            assert want[1][2, 1] == 1  # the stuck read

"""The PyTorch port's banded kernels (plain versions on the CPU, CUDA
kernels on a card) against the JAX package's scan and Pallas functions.

Tolerances. In fp64 the port is held to the JAX kernel tests' own bounds
(tests/test_pallas_kernels.py): finite band cells within 1e-5 absolute,
Zf/Zb rtol 1e-6, starts identical, medians within 1e-6. The Pallas
kernels compute in fp32 only; there torch's and XLA's CPU exp/log1p differ
in the last bit, so a band cell of magnitude |x| may differ by a few fp32
ulps of |x| (cells reach |x| ~ 6e3 here, where one ulp is 4.9e-4): band
cells are held to 1e-5 + 1e-6*|x| and medians, exp of log posteriors
that carry that error, to 2e-4; Z values and starts keep their bounds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu.ops import nt_banded_batch as jbb
from dynamont_tpu.ops import nt_banded_device as jdv
from dynamont_tpu.ops import nt_banded_pallas as pk
from dynamont_tpu.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops import nt_banded_kernels as kk

from tests.synthetic import make_read

M1, E2 = 0.019889650396799997, 0.9801103496029998
LM, LE = math.log(M1), math.log(E2)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "fp64": (jnp.float64, torch.float64)}


@pytest.fixture(scope="module")
def reads():
    model = load_model_for_pore("rna002")
    items = [make_read(model, n_bases=40 + 10 * s, seed=s) for s in range(3)]
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size)
            for _, r in items]
    return model, [s for s, _ in items], kids


def _batches(reads, name):
    model, sigs, kids = reads
    jdt, tdt = DTYPES[name]
    jb = jbb.prepare_batch(sigs, kids, model.means, model.stdevs, dtype=jdt,
                           t_pad_to=256)
    tb = bb.prepare_batch(sigs, kids, model, device="cpu", dtype=tdt,
                          t_pad_to=256)
    return jb, tb


def _close_band(got, want, T, atol=1e-5, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    for i in range(got.shape[0]):
        x, y = got[i, : int(T[i])], want[i, : int(T[i])]
        assert np.array_equal(np.isneginf(x), np.isneginf(y)), f"read {i}: -inf pattern"
        fin = np.isfinite(y)
        d = np.abs(x[fin] - y[fin])
        assert np.all(d <= atol + rtol * np.abs(y[fin])), \
            f"read {i}: max diff {d.max()}"


@pytest.mark.parametrize("name", ["fp32", "fp64"])
def test_prepare_batch_matches_jax(reads, name):
    jb, tb = _batches(reads, name)
    for f in ("sig", "mu_pad", "c1_pad", "c2_pad", "bstart", "T", "N", "bw"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert (tb.pad, tb.B) == (jb.pad, jb.B)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_logaddexp_neg_inf_pair(dtype):
    """torch.logaddexp, which the plain recurrences call, is -inf for
    (-inf, -inf) like jnp.logaddexp."""
    ninf = float("-inf")
    a = torch.tensor([ninf, ninf, 1.0, -3.0], dtype=dtype)
    b = torch.tensor([ninf, 2.0, ninf, -3.0], dtype=dtype)
    got = torch.logaddexp(a, b)
    want = np.logaddexp(a.numpy(), b.numpy())
    np.testing.assert_array_equal(got.numpy(), want)


def test_backward_matches_scan_fp64(reads):
    jb, tb = _batches(reads, "fp64")
    Mj, Ej = jax.vmap(jbb._backward_single(jb, LM, LE))(
        jb.sig, jb.mu_pad, jb.c1_pad, jb.c2_pad, jb.bstart, jb.bw, jb.N, jb.T)
    Mt, Et = kk.backward(tb, LM, LE)
    T = tb.T.numpy()
    _close_band(Mt.numpy(), Mj, T)
    _close_band(Et.numpy(), Ej, T)


def test_backward_matches_pallas_fp32(reads):
    jb, tb = _batches(reads, "fp32")
    Mp, Ep = pk.backward_pallas(jb, LM, LE, interpret=True)
    before = dict(kk.PLAIN_RUNS)
    Mt, Et = kk.backward(tb, LM, LE)
    assert kk.PLAIN_RUNS["banded_bwd"] == before["banded_bwd"] + 1
    T = tb.T.numpy()
    _close_band(Mt.numpy(), Mp, T, rtol=1e-6)
    _close_band(Et.numpy(), Ep, T, rtol=1e-6)


def test_fwd_vit_matches_scan_fp64(reads):
    """The fused forward + posterior + Viterbi pass against the JAX scan
    pipeline's separate passes: Z values, choice bits, posteriors."""
    jb, tb = _batches(reads, "fp64")
    rj = jbb.banded_batch_run(jb, LM, LE)
    bM, bE = kk.backward(tb, LM, LE)
    Zb = bE[torch.arange(3), 0, tb.bw.long() + 1]
    ch, LPM, LPE, Zf = kk.fwd_vit(tb, bM, bE, Zb, LM, LE)
    np.testing.assert_allclose(Zf.numpy(), np.asarray(rj.Zf), rtol=1e-6)
    np.testing.assert_allclose(Zb.numpy(), np.asarray(rj.Zb), rtol=1e-6)
    T = tb.T.numpy()
    for i in range(3):
        np.testing.assert_array_equal(ch[i, : T[i]].numpy().astype(bool),
                                      np.asarray(rj.choices)[i, : T[i]])
    prob = lambda lp: torch.nan_to_num(lp.exp(), nan=0.0, posinf=0.0).clamp(0, 1)
    _close_band(prob(LPM).numpy(), rj.PM, T, atol=1e-6)
    _close_band(prob(LPE).numpy(), rj.PE, T, atol=1e-6)


def _scan_pipeline(jb):
    """The JAX scan pipeline: banded_batch_run + the device walk."""
    N_max = int(np.asarray(jb.N).max())
    res = jbb.banded_batch_run(jb, LM, LE)
    starts, med = jax.vmap(jdv._walk_single(jb.B, N_max))(
        res.PM, res.PE, res.choices, jb.bstart, jb.T, jb.N, jb.bw)
    return res, N_max, np.asarray(starts), np.asarray(med)


def test_segment_matches_scan_pipeline_fp64(reads):
    jb, tb = _batches(reads, "fp64")
    res, N_max, starts_j, med_j = _scan_pipeline(jb)
    before = dict(kk.PLAIN_RUNS)
    Zf, Zb, starts, med = kk.banded_segment(tb, N_max, LM, LE)
    assert all(kk.PLAIN_RUNS[k] == before[k] + 1 for k in kk.SEGMENT_KERNELS)
    np.testing.assert_allclose(Zf.numpy(), np.asarray(res.Zf), rtol=1e-6)
    np.testing.assert_allclose(Zb.numpy(), np.asarray(res.Zb), rtol=1e-6)
    np.testing.assert_array_equal(starts.numpy(), starts_j)
    np.testing.assert_allclose(med.numpy(), med_j, atol=1e-6)


def test_segment_matches_pallas_fp32(reads):
    jb, tb = _batches(reads, "fp32")
    N_max = int(np.asarray(jb.N).max())
    Zf_p, Zb_p, starts_p, med_p = pk.banded_segment_pallas(
        jb, N_max, LM, LE, interpret=True)
    Zf, Zb, starts, med = kk.banded_segment(tb, N_max, LM, LE)
    np.testing.assert_allclose(Zf.numpy(), np.asarray(Zf_p), rtol=1e-6)
    np.testing.assert_allclose(Zb.numpy(), np.asarray(Zb_p), rtol=1e-6)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(starts_p))
    np.testing.assert_allclose(med.numpy(), np.asarray(med_p), atol=2e-4)


def test_walk_matches_device_walk_fp64(reads):
    """The walk alone, on the JAX pipeline's own posteriors and choices:
    it takes log posteriors, as the Pallas walk does."""
    jb, tb = _batches(reads, "fp64")
    res, N_max, starts_j, med_j = _scan_pipeline(jb)
    with np.errstate(divide="ignore"):
        LPM = torch.from_numpy(np.log(np.asarray(res.PM)))
        LPE = torch.from_numpy(np.log(np.asarray(res.PE)))
    ch = torch.from_numpy(np.asarray(res.choices).astype(np.uint8))
    path_n, prob, close = kk.walk(LPM, LPE, ch, tb, N_max)
    starts, med = bb.path_summaries(path_n, prob, close, N_max)
    np.testing.assert_array_equal(starts.numpy(), starts_j)
    np.testing.assert_allclose(med.numpy(), med_j, atol=1e-12)


def test_fwd_vit_rows_past_T_are_filled(reads):
    _, tb = _batches(reads, "fp32")
    bM, bE = kk.backward(tb, LM, LE)
    Zb = bE[torch.arange(3), 0, tb.bw.long() + 1]
    ch, LPM, LPE, Zf = kk.fwd_vit(tb, bM, bE, Zb, LM, LE)
    for i, T in enumerate(tb.T.tolist()):
        assert torch.all(LPM[i, T:] == float("-inf"))
        assert torch.all(LPE[i, T:] == float("-inf"))
        assert torch.all(ch[i, T:] == 0)
        assert torch.isfinite(LPE[i, T - 1]).any()
    assert torch.isfinite(Zf).all()



@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_staging_fits_shared_memory(dtype):
    """K2's staged chunks fit one block's shared memory at every band width
    the kernel takes (multiples of 32 up to 1024), with at least one row a
    chunk, and K2 takes the most rows that fit (at most FWD_VIT_MAX_ROWS).
    The bytes are csrc/nt_banded.cu's fwd_vit_smem_bytes, written out."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    fwd_vit_bytes = lambda B, C: ((8 * B + 2 * (2 * C * B + 3 * (B + C) + C)) * itemsize
                                  + 2 * (C + 1) * 4)
    for B in range(32, kk.MAX_B + 1, 32):
        st = kk.staging(B, itemsize)
        assert st.fwd_vit_rows >= 1, B
        assert st.fwd_vit_bytes == fwd_vit_bytes(B, st.fwd_vit_rows), B
        assert st.fwd_vit_bytes <= kk.SMEM_LIMIT == 232448, B
        assert st.fwd_vit_rows == kk.FWD_VIT_MAX_ROWS or \
            fwd_vit_bytes(B, st.fwd_vit_rows + 1) > kk.SMEM_LIMIT, B


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bwd_staging_fits_shared_memory(dtype):
    """K1's staged chunks fit one block's shared memory at every band width
    the kernel takes (multiples of 32 up to 1024), and K1 takes the most
    rows that fit, at most BWD_MAX_ROWS: two previous rows, two stages of a
    C + B + 2 window of mu/c1/c2, C samples and C + 1 band starts. The
    bytes are csrc/nt_banded.cu's bwd_smem_bytes, written out."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    bwd_bytes = lambda B, C: ((4 * B + 2 * (3 * (C + B + 2) + C)) * itemsize
                              + 2 * (C + 1) * 4)
    for B in range(32, kk.MAX_B + 1, 32):
        st = kk.staging(B, itemsize)
        assert st.bwd_bytes == bwd_bytes(B, st.bwd_rows), B
        assert st.bwd_bytes <= kk.SMEM_LIMIT == 232448, B
        assert st.bwd_rows == kk.BWD_MAX_ROWS == 256 or \
            bwd_bytes(B, st.bwd_rows + 1) > kk.SMEM_LIMIT, B

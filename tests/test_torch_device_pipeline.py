"""The PyTorch port's device pipeline (wire format, decode, engine, fp64
rung) against the JAX package, on the CPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamont_tpu.models.nt_banded import run_nt_banded as jax_run_nt_banded
from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu.ops import nt_banded_device as jdv
from dynamont_tpu.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.models.batch import BandedBatchEngine, BatchItem
from dynamont_tpu_torch.models.nt_banded import run_nt_banded
from dynamont_tpu_torch.models.params import params_from_numpy
from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops import nt_banded_device as dv
from dynamont_tpu_torch.ops import nt_banded_kernels as kk

from tests.synthetic import make_read

M1, E2 = 0.019889650396799997, 0.9801103496029998


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def _quantized_items(model, n_reads=4, base_len=45):
    """Signals snapped to the int16 wire grid, so the wire is lossless and
    the fp64 paths see the same signal."""
    items = []
    for s in range(n_reads):
        sig, read = make_read(model, n_bases=base_len + 9 * s, seed=100 + s)
        dac, a, b = dv.quantize_signal(sig)
        items.append(BatchItem(signal=dac.astype(np.float64) * a + b, read=read))
    return items


def test_quantize_matches_jax():
    sig = np.random.default_rng(3).normal(0, 1.0, 5000)
    for got, want in zip(dv.quantize_signal(sig), jdv.quantize_signal(sig)):
        np.testing.assert_array_equal(got, want)


def test_wire_and_decode_match_jax(model):
    items = _quantized_items(model, n_reads=3)
    kids = [seq_to_kmer_ids(it.read, model.kmer_size, model.alphabet_size)
            for it in items]
    sigs = [it.signal for it in items]
    jw = jdv.prepare_wire(sigs, kids, t_pad=1024, n_pad_to=128)
    tw = dv.prepare_wire(sigs, kids, device="cpu", t_pad=1024)
    for f in ("dacs", "aff_a", "aff_b", "kmer_ids", "shift_bits", "T", "N", "bw"):
        np.testing.assert_array_equal(getattr(tw, f).numpy(),
                                      np.asarray(getattr(jw, f)), err_msg=f)
    assert (tw.pad, tw.B, tw.N_max, tw.T_pad) == (jw.pad, jw.B, jw.N_max, jw.T_pad)

    means, c1, c2 = model.score_params()
    tables = [jnp.asarray(x, jnp.float32) for x in (means, c1, c2)]
    want = jax.vmap(jdv._decode_single(jw, *tables, jnp.float32, False))(
        jw.dacs, jw.aff_a, jw.aff_b, jw.kmer_ids, jw.shift_bits, jw.T, jw.N,
        jw.bw)
    p = params_from_numpy(model, M1, E2, device="cpu", dtype=torch.float32)
    got = dv.decode(tw, p.means, p.c1, p.c2, torch.float32)
    for name, g, w in zip(("sig", "mu_pad", "c1_pad", "c2_pad", "bstart"),
                          got[:5], want):
        assert g.dtype == (torch.int32 if name == "bstart" else torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_params_from_numpy_matches_score_params(model, dtype):
    p = params_from_numpy(model, M1, E2, device="cpu", dtype=dtype)
    for got, want in zip(p[:3], model.score_params()):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(got.numpy().dtype))
    assert (p.log_m1, p.log_e2) == (np.log(M1), np.log(E2))


def test_engine_fp32_borders_match_jax_fp64(model):
    items = _quantized_items(model, n_reads=3, base_len=60)
    eng = BandedBatchEngine(model, "rna002", device="cpu", dtype=torch.float32)
    outs = eng.run(items)
    assert eng.profile["reads"] == 3 and "z_retries" not in eng.profile
    for it, out in zip(items, outs):
        assert out.error is None, out.error
        ref = jax_run_nt_banded(it.signal, it.read, model, "rna002")
        assert [(s[1], s[2]) for s in out.segments] == [
            (s[1], s[2]) for s in ref.segments]
        for got, want in zip(out.segments, ref.segments):
            assert got[3] == pytest.approx(want[3], abs=2e-3)


def test_fp64_rung_matches_jax_exact(model):
    for it in _quantized_items(model, n_reads=2):
        got = run_nt_banded(it.signal, it.read, model, "rna002", device="cpu")
        ref = jax_run_nt_banded(it.signal, it.read, model, "rna002")
        assert len(got.segments) == len(ref.segments)
        for g, w in zip(got.segments, ref.segments):
            assert g[:3] == w[:3]
            assert g[3] == pytest.approx(w[3], abs=1e-12)
        assert got.Z == pytest.approx(ref.Z, rel=1e-12)


def test_engine_fp64_matches_jax_exact(model):
    items = _quantized_items(model, n_reads=3)
    outs = BandedBatchEngine(model, "rna002", device="cpu",
                             dtype=torch.float64, batch_size=3).run(items)
    for it, out in zip(items, outs):
        assert out.error is None, out.error
        ref = jax_run_nt_banded(it.signal, it.read, model, "rna002")
        assert [s[:3] for s in out.segments] == [s[:3] for s in ref.segments]
        for g, w in zip(out.segments, ref.segments):
            assert g[3] == pytest.approx(w[3], abs=1e-12)
        assert out.Z == pytest.approx(ref.Z, rel=1e-12)


def test_fp32_z_gate_escalates_to_fp64(model, monkeypatch):
    """A read failing the fp32 Z gate re-runs on the exact fp64 rung and
    yields its segments (mirrors the JAX engine's ladder)."""
    items = _quantized_items(model, n_reads=2, base_len=50)
    eng = BandedBatchEngine(model, "rna002", device="cpu", dtype=torch.float32)
    monkeypatch.setattr(
        bb, "check_z_batch",
        lambda Zf, Zb, T, B, dtype: np.zeros(len(np.asarray(Zf)), bool))
    outs = eng.run(items)
    assert eng.profile.get("z_retries", 0) == len(items)
    for it, out in zip(items, outs):
        assert out.error is None, out.error
        ref = jax_run_nt_banded(it.signal, it.read, model, "rna002")
        assert [(s[1], s[2]) for s in out.segments] == [
            (s[1], s[2]) for s in ref.segments]
        assert out.Z == pytest.approx(ref.Z, rel=1e-12)


def test_fp32_z_gate_terminal_without_fallback(model, monkeypatch):
    items = _quantized_items(model, n_reads=1, base_len=50)
    eng = BandedBatchEngine(model, "rna002", device="cpu",
                            dtype=torch.float32, fp64_fallback=False)
    monkeypatch.setattr(
        bb, "check_z_batch",
        lambda Zf, Zb, T, B, dtype: np.zeros(len(np.asarray(Zf)), bool))
    outs = eng.run(items)
    assert outs[0].error is not None
    assert "Z values between matrices" in outs[0].error


def test_engine_invalid_read_reports_reference_exit(model):
    sig, read = make_read(model, n_bases=40, seed=5)
    outs = BandedBatchEngine(model, "rna002", device="cpu").run(
        [BatchItem(sig[:10], read)])
    assert outs[0].error == "input validation failed (reference exit 10)"


def test_engine_cpu_runs_plain_versions_only(model):
    kk.reset_counts()
    BandedBatchEngine(model, "rna002", device="cpu").run(
        _quantized_items(model, n_reads=2))
    assert all(kk.PLAIN_RUNS[k] == 1 for k in kk.SEGMENT_KERNELS)
    assert all(kk.PLAIN_RUNS[k] == 0 for k in kk.TRAIN_KERNELS)
    assert all(kk.LAUNCHES[k] == 0 for k in kk.KERNELS)


def test_port_runs_without_jax():
    """Importing the port and running its engine leaves jax unimported
    (a subprocess: this test process has imported jax)."""
    code = (
        "import sys, numpy as np\n"
        "from dynamont_tpu.models.registry import load_model_for_pore\n"
        "from dynamont_tpu.utils.synthetic import make_read\n"
        "import dynamont_tpu_torch.cli.resquiggle\n"
        "from dynamont_tpu_torch.models.batch import BandedBatchEngine, BatchItem\n"
        "m = load_model_for_pore('rna002')\n"
        "sig, read = make_read(m, n_bases=40, seed=1)\n"
        "out = BandedBatchEngine(m, 'rna002', device='cpu').run([BatchItem(sig, read)])\n"
        "assert out[0].error is None and out[0].segments\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('OK')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")

"""The port's banded Baum-Welch training path against the JAX package, on
the CPU (plain versions of the training kernels).

Bounds. fp64: the plain forward against the per-read scan within 1e-12;
banded_batch_train and the per-read train/calcZ modes at the bounds of
tests/test_train_batch.py (Z rel 1e-12, m1/e2 rel 1e-9, means/stdevs rel
1e-6 abs 1e-9). fp32 against the Pallas kernels in interpret mode: band
cells within 1e-5 + 1e-6*|x| (torch's and XLA's CPU exp/log1p differ in
the last bit, tests/test_torch_banded_kernels.py), the raw transition
numerators rel 1e-5, the estimates at tests/test_train_fast.py's bounds.
"""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamont_tpu.io import readers
from dynamont_tpu.models.nt_banded import run_nt_banded as jax_run_nt_banded
from dynamont_tpu.models.registry import get_model_path, load_model_for_pore
from dynamont_tpu.ops import nt_banded as jnb
from dynamont_tpu.ops import nt_banded_batch as jbb
from dynamont_tpu.ops import nt_banded_pallas as pk
from dynamont_tpu.ops.geometry import band_geometry, effective_bandwidth
from dynamont_tpu.ops.nt_banded_train import (
    backward_transitions_pallas, banded_batch_train_fast,
)
from dynamont_tpu.training.trainer import Trainer as JaxTrainer
from dynamont_tpu.utils.kmer import seq_to_kmer_ids
from dynamont_tpu.utils.pore_model import pore_model_from_dict, read_kmer_models
from dynamont_tpu_torch.cli import train as torch_cli
from dynamont_tpu_torch.models.nt_banded import run_nt_banded
from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops import nt_banded_kernels as kk
from dynamont_tpu_torch.ops.nt_banded_train import banded_batch_train
from dynamont_tpu_torch.training import trainer as torch_trainer

from tests.synthetic import make_read

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M1, E2 = 0.019889650396799997, 0.9801103496029998
LM, LE = math.log(M1), math.log(E2)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "fp64": (jnp.float64, torch.float64)}


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


@pytest.fixture(scope="module")
def reads(model):
    items = [make_read(model, n_bases=40 + 11 * s, seed=s) for s in range(3)]
    kids = [seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size)
            for _, r in items]
    kid_pad = np.zeros((3, max(len(k) for k in kids)), np.int32)
    for i, k in enumerate(kids):
        kid_pad[i, : len(k)] = k
    return items, kids, kid_pad


def _batches(model, reads, name, t_pad_to=256):
    items, kids, _ = reads
    sigs = [s for s, _ in items]
    jdt, tdt = DTYPES[name]
    jb = jbb.prepare_batch(sigs, kids, model.means, model.stdevs, dtype=jdt,
                           t_pad_to=t_pad_to)
    tb = bb.prepare_batch(sigs, kids, model, device="cpu", dtype=tdt,
                          t_pad_to=t_pad_to)
    return jb, tb


def _close_band(got, want, T, atol, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    for i in range(got.shape[0]):
        x, y = got[i, : int(T[i])], want[i, : int(T[i])]
        assert np.array_equal(np.isneginf(x), np.isneginf(y)), f"read {i}: -inf pattern"
        fin = np.isfinite(y)
        d = np.abs(x[fin] - y[fin])
        assert np.all(d <= atol + rtol * np.abs(y[fin])), f"read {i}: max diff {d.max()}"


# ---------------------------------------------------------------------------
# K5 forward and K6 backward + numerators, plain versions
# ---------------------------------------------------------------------------

def test_forward_matches_per_read_scan_fp64(model, reads):
    """Each read's rows < T against the per-read forward of the JAX
    package, whose band is the unpadded 2bw+3 columns; the port's extra
    columns are -inf."""
    items, kids, _ = reads
    _, tb = _batches(model, reads, "fp64")
    before = kk.PLAIN_RUNS["banded_fwd"]
    fM, fE = kk.forward(tb, LM, LE)
    assert kk.PLAIN_RUNS["banded_fwd"] == before + 1
    for i, ((sig, _), kid) in enumerate(zip(items, kids)):
        T, N = len(sig) + 1, len(kid) + 1
        geom = band_geometry(T, N, effective_bandwidth(400, N))
        inp = jnb.make_banded_inputs(sig, kid, model.means, model.stdevs, geom)
        Mj, Ej = jnb.nt_banded_forward(inp, geom, LM, LE)
        for got, want in ((fM, Mj), (fE, Ej)):
            g = got[i, :T].numpy()
            assert np.all(np.isneginf(g[:, geom.B:]))
            _close_band(g[None, :, : geom.B], np.asarray(want)[None], [T], atol=1e-12)
        assert torch.all(torch.isneginf(fM[i, T:])) and torch.all(torch.isneginf(fE[i, T:]))


def test_forward_matches_pallas_fp32(model, reads):
    jb, tb = _batches(model, reads, "fp32")
    Mp, Ep = pk.forward_pallas(jb, LM, LE, interpret=True)
    fM, fE = kk.forward(tb, LM, LE)
    T = tb.T.numpy()
    _close_band(fM.numpy(), Mp, T, atol=1e-5, rtol=1e-6)
    _close_band(fE.numpy(), Ep, T, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("name", ["fp32", "fp64"])
def test_backward_train_rows_equal_backward(model, reads, name):
    """K6's recurrence is K1's, unchanged: its band rows are bit for bit
    the plain backward's."""
    _, tb = _batches(model, reads, name)
    _, fE = kk.forward(tb, LM, LE)
    before = kk.PLAIN_RUNS["banded_bwd_train"]
    bM, bE, rawM1, rawE2 = kk.backward_train(tb, fE, LM, LE)
    assert kk.PLAIN_RUNS["banded_bwd_train"] == before + 1
    M, E = kk.backward(tb, LM, LE)
    assert torch.equal(bM, M) and torch.equal(bE, E)
    assert rawM1.shape == rawE2.shape == (3,)
    assert torch.isfinite(rawM1).all() and torch.isfinite(rawE2).all()


def test_backward_train_numerators_match_pallas_fp32(model, reads):
    jb, tb = _batches(model, reads, "fp32")
    _, forE = pk._forward_t(jb, LM, LE, interpret=True)
    _, _, rawM1_p, rawE2_p = backward_transitions_pallas(jb, forE, LM, LE,
                                                         interpret=True)
    _, fE = kk.forward(tb, LM, LE)
    _, _, rawM1, rawE2 = kk.backward_train(tb, fE, LM, LE)
    np.testing.assert_allclose(rawM1.numpy(), np.asarray(rawM1_p), rtol=1e-5)
    np.testing.assert_allclose(rawE2.numpy(), np.asarray(rawE2_p), rtol=1e-5)


@pytest.mark.parametrize("name", ["fp32", "fp64"])
def test_band_lse_is_a_log_sum(name):
    """The fixed-order band reduction of the numerators equals a log-sum-
    exp of the per-column values, and is -inf for a read without terms."""
    dtype = DTYPES[name][1]
    rng = np.random.default_rng(7)
    m = torch.from_numpy(rng.normal(-300.0, 5.0, (3, 384))).to(dtype)
    s = torch.from_numpy(rng.uniform(0.5, 3.0, (3, 384))).to(dtype)
    m[1, ::2] = float("-inf")
    s[1, ::2] = 0.0
    m[2], s[2] = float("-inf"), 0.0
    got = bb.band_lse(m, s)
    want = torch.logsumexp(torch.where(s > 0, m + torch.log(s), float("-inf")), 1)
    torch.testing.assert_close(got[:2], want[:2], rtol=1e-6 if name == "fp32" else 1e-13,
                               atol=0)
    assert torch.isneginf(got[2])


# ---------------------------------------------------------------------------
# the batched training op
# ---------------------------------------------------------------------------

def _assert_estimates(got, ref, z_rtol, t_rtol, e_rtol, e_atol, s_rtol=None,
                      s_atol=None):
    np.testing.assert_allclose(got.Zf.numpy(), np.asarray(ref.Zf), rtol=z_rtol)
    np.testing.assert_allclose(got.Zb.numpy(), np.asarray(ref.Zb), rtol=z_rtol)
    np.testing.assert_allclose(got.m1.numpy(), np.asarray(ref.m1), rtol=t_rtol)
    np.testing.assert_allclose(got.e2.numpy(), np.asarray(ref.e2), rtol=t_rtol)
    mask = np.asarray(ref.kmer_mask)
    np.testing.assert_array_equal(got.kmer_mask.numpy(), mask)
    np.testing.assert_allclose(got.means.numpy()[mask], np.asarray(ref.means)[mask],
                               rtol=e_rtol, atol=e_atol)
    np.testing.assert_allclose(got.stdevs.numpy()[mask], np.asarray(ref.stdevs)[mask],
                               rtol=s_rtol or e_rtol, atol=s_atol or e_atol)


def test_batch_train_matches_scan_fp64(model, reads):
    jb, tb = _batches(model, reads, "fp64")
    kid_pad = reads[2]
    ref = jbb.banded_batch_train(jb, LM, LE, jnp.asarray(kid_pad), model.num_kmers)
    got = banded_batch_train(tb, LM, LE, kid_pad, model.num_kmers)
    _assert_estimates(got, ref, 1e-12, 1e-9, 1e-6, 1e-9)


def test_batch_train_matches_fast_path_fp32(model, reads):
    jb, tb = _batches(model, reads, "fp32")
    kid_pad = reads[2]
    got = banded_batch_train(tb, LM, LE, kid_pad, model.num_kmers)
    fast = banded_batch_train_fast(jb, LM, LE, jnp.asarray(kid_pad),
                                   model.num_kmers, interpret=True)
    jb64, _ = _batches(model, reads, "fp64")
    scan = jbb.banded_batch_train(jb64, LM, LE, jnp.asarray(kid_pad), model.num_kmers)
    for ref in (fast, scan):  # tests/test_train_fast.py's bounds
        _assert_estimates(got, ref, 1e-5, 1e-4, 1e-4, 1e-5, 5e-4, 1e-4)


def test_batch_train_padded_read_is_benign(model, reads):
    """A degenerate padding read (T = N = 1) yields no NaN anywhere and
    contributes no k-mer."""
    _, tb = _batches(model, reads, "fp32")
    kid_pad = reads[2]
    pad1 = lambda a, v=0: torch.cat([a, torch.full_like(a[:1], v)])
    padded = bb.BandedBatch(
        sig=pad1(tb.sig), mu_pad=pad1(tb.mu_pad), c1_pad=pad1(tb.c1_pad),
        c2_pad=pad1(tb.c2_pad), bstart=pad1(tb.bstart), T=pad1(tb.T, 1),
        N=pad1(tb.N, 1), bw=pad1(tb.bw, 1), pad=tb.pad, B=tb.B)
    kid4 = np.concatenate([kid_pad, np.zeros_like(kid_pad[:1])])
    got = banded_batch_train(padded, LM, LE, kid4, model.num_kmers)
    for leaf in got:
        assert not torch.isnan(leaf.double()).any()
    assert not got.kmer_mask[3].any()
    ref = banded_batch_train(tb, LM, LE, kid_pad, model.num_kmers)
    for a, b in zip(got, ref):
        assert torch.equal(a[:3], b)


def test_batch_train_does_not_depend_on_t_pad(model, reads):
    kid_pad = reads[2]
    _, short = _batches(model, reads, "fp64", t_pad_to=1)
    _, long = _batches(model, reads, "fp64", t_pad_to=2048)
    a = banded_batch_train(short, LM, LE, kid_pad, model.num_kmers)
    b = banded_batch_train(long, LM, LE, kid_pad, model.num_kmers)
    assert short.bstart.shape[1] < 2048 == long.bstart.shape[1]
    for x, y in zip(a, b):
        if x.dtype == torch.bool:
            assert torch.equal(x, y)
        else:
            torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the per-read fp64 rung: calcZ and train modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 4])
def test_rung_train_and_calcz_match_jax(model, seed):
    sig, read = make_read(model, n_bases=45, seed=seed)
    for mode in ("calcZ", "train"):
        want = jax_run_nt_banded(sig, read, model, "rna002", mode=mode)
        got = run_nt_banded(sig, read, model, "rna002", mode=mode, device="cpu")
        assert got.Z == pytest.approx(want.Z, rel=1e-12)
    for p in ("m1", "e2"):
        assert got.trained_transitions[p] == pytest.approx(
            want.trained_transitions[p], rel=1e-9)
    assert got.trained_transitions["e1"] == 1.0
    assert set(got.trained_emissions) == set(want.trained_emissions)
    for kmer, (m, s) in want.trained_emissions.items():
        assert got.trained_emissions[kmer][0] == pytest.approx(m, rel=1e-6)
        assert got.trained_emissions[kmer][1] == pytest.approx(s, rel=1e-6)


def test_rung_rejects_unknown_mode(model):
    sig, read = make_read(model, n_bases=40, seed=0)
    with pytest.raises(ValueError, match="banded mode"):
        run_nt_banded(sig, read, model, "rna002", mode="viterbi", device="cpu")


# ---------------------------------------------------------------------------
# the trainer and its CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tsv(model, tmp_path_factory):
    """Four 30-base reads (the recipe of tests/test_train_fast.py), as a
    TSV the CLIs read: two batches of two."""
    path = tmp_path_factory.mktemp("train") / "train.tsv"
    with open(path, "w") as f:
        for s in range(4):
            sig, read_proc = make_read(model, n_bases=30, seed=80 + s)
            f.write(f"tr{s}\ttr{s}\t{','.join(repr(float(x)) for x in sig)}"
                    f"\t{read_proc[9:][::-1]}\n")
    return path


def _run(trainer, jobs, batches):
    for b in batches:
        trainer.process_batch(jobs[2 * b : 2 * b + 2], epoch=0)
    trainer.close()
    return trainer


def _params(outdir):
    with open(outdir / "params.csv") as f:
        head, *rows = f.read().splitlines()
    return head, [r.split(",") for r in rows]


def _assert_same_run(out_t, out_j, last):
    head_t, rows_t = _params(out_t)
    head_j, rows_j = _params(out_j)
    assert head_t == head_j == "epoch,batch,read,e1,m1,e2,Zchange"
    assert len(rows_t) == len(rows_j)
    for rt, rj in zip(rows_t, rows_j):
        assert rt[:3] == rj[:3]
        for a, b in zip(rt[3:6], rj[3:6]):
            assert float(a) == pytest.approx(float(b), rel=1e-9)
        assert float(rt[6]) == pytest.approx(float(rj[6]), abs=1e-9)
    mt = read_kmer_models(str(out_t / last))
    mj = read_kmer_models(str(out_j / last))
    assert set(mt) == set(mj)
    for kmer, (m, s) in mj.items():
        assert mt[kmer][0] == pytest.approx(m, rel=1e-6)
        assert mt[kmer][1] == pytest.approx(s, rel=1e-6)


def _trainers(tmp_path, tag, **kw):
    path = get_model_path("rna002")
    t = torch_trainer.Trainer("basic", "rna002", str(tmp_path / f"torch{tag}"),
                              path, batch_size=2, precision="fp64",
                              device="cpu", **kw)
    j = JaxTrainer("basic", "rna002", str(tmp_path / f"jax{tag}"), path,
                   batch_size=2, precision="fp64", **kw)
    return t, j


def test_trainer_matches_jax_trainer_fp64(tsv, tmp_path):
    """The slice as a whole, and --resume: the port's Trainer (CPU, fp64)
    and the JAX Trainer (fp64) write the same params.csv and checkpoints,
    in one run of two batches and in a run resumed after batch 1. A
    resumed run restarts the ManagedList windows from the pooled values in
    both packages (as a reference restart via --model_path does), so its
    second row is held to the JAX resume, not to the uninterrupted run."""
    jobs = list(readers.generate_tsv_jobs(str(tsv), rna=True))
    t, j = _trainers(tmp_path, "")
    _run(t, jobs, [0, 1])
    _run(j, jobs, [0, 1])
    assert t.fp64_reads == 0
    _assert_same_run(tmp_path / "torch", tmp_path / "jax", "trained_0_2.model")

    t, j = _trainers(tmp_path, "_resumed")
    _run(t, jobs, [0])
    _run(j, jobs, [0])
    t, j = _trainers(tmp_path, "_resumed", resume=True)
    assert (t.batch_num, t.resume_skip_batches, t.reads_done) == (1, 1, 2)
    _run(t, jobs, [1])
    _run(j, jobs, [1])
    _assert_same_run(tmp_path / "torch_resumed", tmp_path / "jax_resumed",
                     "trained_0_2.model")
    assert _params(tmp_path / "torch_resumed")[1][0] == _params(tmp_path / "torch")[1][0]


def test_trainer_fp32_close_to_fp64(tsv, tmp_path):
    jobs = list(readers.generate_tsv_jobs(str(tsv), rna=True))
    params = {}
    for prec in ("fp64", "fp32"):
        t = torch_trainer.Trainer("basic", "rna002", str(tmp_path / prec),
                                  get_model_path("rna002"), batch_size=4,
                                  precision=prec, device="cpu")
        assert t.process_batch(jobs, epoch=0) is not None
        t.close()
        params[prec] = t.transition_params
    for p in ("m1", "e2"):
        assert params["fp32"][p] == pytest.approx(params["fp64"][p], rel=1e-3)


def test_trainer_auto_precision_follows_device(tmp_path):
    t = torch_trainer.Trainer("basic", "rna002", str(tmp_path), get_model_path("rna002"),
                              device="cpu")
    t.close()
    assert (t.precision, t.dtype) == ("fp64", torch.float64)


def test_kernel_error_is_not_swallowed(tsv, tmp_path, monkeypatch):
    """A failed launch ends the batch: no per-read run hides it."""
    jobs = list(readers.generate_tsv_jobs(str(tsv), rna=True))

    def launch_fails(*a, **k):
        raise RuntimeError("banded_fwd launch failed: cudaGetLastError() = 700")

    monkeypatch.setattr(torch_trainer, "banded_batch_train", launch_fails)
    t = torch_trainer.Trainer("basic", "rna002", str(tmp_path), get_model_path("rna002"),
                              batch_size=2, device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        t.process_batch(jobs[:2], epoch=0)
    t.close()
    assert t.fp64_reads == 0
    assert _params(tmp_path)[1] == []


def test_z_gate_failure_leaves_the_read_out_as_jax(tsv, tmp_path, monkeypatch, capsys):
    """In fp32, a read failing the Z gate is left out of the pool, as the
    JAX Trainer leaves it out: the gate of the first read of a batch is
    forced to fail in both packages (its Zf moved by 1e3 as the batched
    step returns it, in the training and the post-update Z pass), and both
    write the same reads_done, the same "No segmentation calculated" lines
    for it, and params.csv within rel 1e-3 (the fp32 bound above)."""
    jobs = list(readers.generate_tsv_jobs(str(tsv), rna=True))
    real = torch_trainer.banded_batch_train

    def first_read_fails(*a, **k):
        res = real(*a, **k)
        Zf = res.Zf.clone()
        Zf[0] = Zf[0] - 1e3
        return res._replace(Zf=Zf)

    monkeypatch.setattr(torch_trainer, "banded_batch_train", first_read_fails)
    path = get_model_path("rna002")
    t = torch_trainer.Trainer("basic", "rna002", str(tmp_path / "torch"), path,
                              batch_size=2, precision="fp32", device="cpu")
    j = JaxTrainer("basic", "rna002", str(tmp_path / "jax"), path,
                   batch_size=2, precision="fp32")
    real_step = j._run_fast_step

    def jax_first_read_fails(*a, **k):
        res = real_step(*a, **k)
        return res._replace(Zf=jnp.asarray(res.Zf).at[0].add(-1e3))

    j._run_fast_step = jax_first_read_fails
    lines = {}
    for name, trainer in (("torch", t), ("jax", j)):
        capsys.readouterr()
        _run(trainer, jobs, [0])
        lines[name] = [ln.split(":")[0] for ln in capsys.readouterr().err.splitlines()
                       if ln.startswith("No segmentation calculated")]
    assert t.fp64_reads == 0
    assert t.reads_done == j.reads_done == 1
    assert lines["torch"] == lines["jax"] == [
        "No segmentation calculated for tr0 in 0",
        "No segmentation calculated for tr0 in 0 calcZ"]
    head_t, rows_t = _params(tmp_path / "torch")
    head_j, rows_j = _params(tmp_path / "jax")
    assert head_t == head_j and len(rows_t) == len(rows_j) == 1
    assert rows_t[0][:3] == rows_j[0][:3]
    for a, b in zip(rows_t[0][3:], rows_j[0][3:]):
        assert float(a) == pytest.approx(float(b), rel=1e-3)


def test_cli_trains_on_cpu_without_jax(tsv, tmp_path):
    """The CLI on --device cpu writes params.csv and the checkpoints, in a
    process that never imports jax."""
    code = (
        "import sys\n"
        "from dynamont_tpu_torch.cli import train\n"
        "train.main(sys.argv[1:])\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
    )
    out = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run(
        [sys.executable, "-c", code, "--tsv", str(tsv), "-o", str(out), "-p", "rna002",
         "--mode", "basic", "--batch_size", "2", "-q", "0", "--device", "cpu",
         "--max_batches", "1"],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "precision auto -> fp64" in r.stderr
    head, rows = _params(out)
    assert len(rows) == 1 and rows[0][:3] == ["0", "1", "2"]
    assert all(math.isfinite(float(v)) for v in rows[0][3:])
    assert (out / "trained_0_0.model").exists() and (out / "trained_0_1.model").exists()


@pytest.mark.parametrize("flag", [["--mode", "resquiggle", "--distributed"],
                                  ["--mode", "basic", "--distributed"]])
def test_cli_refuses_what_is_not_ported(tsv, tmp_path, capsys, flag):
    with pytest.raises(SystemExit) as e:
        torch_cli.main(["--tsv", str(tsv), "-o", str(tmp_path / "o"), "-p", "rna002",
                        "--device", "cpu", *flag])
    assert e.value.code == 2
    assert "not yet ported" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


def test_cli_without_cuda_fails(tsv, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        torch_cli.main(["--tsv", str(tsv), "-o", str(tmp_path / "o"), "-p", "rna002",
                        "--mode", "basic"])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


def test_trainer_refuses_what_is_not_ported(tmp_path):
    path = get_model_path("rna002")
    for mode in ("basic", "resquiggle"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            torch_trainer.Trainer(mode, "rna002", str(tmp_path), path, device="cpu",
                                  distributed=True)
    assert jax.default_backend() == "cpu"

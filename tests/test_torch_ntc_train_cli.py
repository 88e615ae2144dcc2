"""The port's NTC training engine and `dynamont-train --mode resquiggle`
against JAX's exact path and JAX's CLI, on the CPU.

JAX's CPU engine trains every read on the exact per-read fp64 path (its
batched trainer runs only in its Pallas kernels). So here:

* NTCBatchEngine.train against JAX's NTCBatchEngine(pallas=False).train as
  JAX's `dynamont-train --mode resquiggle` calls it on two reads (seeds
  0-1, 25 bases): fp64 Z, the 13 transitions and the means and stdevs of
  common k-mers within rel 1e-6 (measured: at most 7e-8; the bucket carries
  the signal in fp32 as JAX's engine does, the exact path in fp64). A
  k-mer on one side only must have a stdev below 1e-6 (a k-mer trained on
  one cell: 0 or ~1e-8 by the last bit of its variance; the reference
  keeps only stdev != 0). In fp32, the bounds of JAX's own
  kernel-against-exact test (tests/test_ntc_pallas.py:377-390);
* JAX's CLI on the same TSV (batch 2, one batch, fp64 on both): the same
  params.csv header and epoch/batch/read columns, values within rel 1e-6,
  Zchange within 1e-6 * max |Z|, the same checkpoint k-mers up to the
  one-cell flip, their values within 1e-6.

The port's engines pad with t_pad_to 64 and n_pad_to 16 (the CLI run is
patched to it); padding changes no output. JAX's CLI run, every read on
the exact path, takes most of this file's time; the lattice-level checks
are in tests/test_torch_ntc_train.py.
"""

import functools
import math
import os

import numpy as np
import pytest
import torch

from dynamont_tpu.cli import train as jax_cli
from dynamont_tpu.models import ntc_batch as jax_ntc_batch
from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu_torch.cli import train as torch_cli
from dynamont_tpu_torch.models import ntc_batch as torch_ntc_batch
from dynamont_tpu_torch.models.batch import BatchItem
from dynamont_tpu_torch.training import trainer as torch_trainer
from dynamont_tpu_torch.utils.pore_model import PoreModel, read_kmer_models

from tests.synthetic import make_read

PAD = dict(t_pad_to=64, n_pad_to=16)
DTYPES = {"float64": torch.float64, "float32": torch.float32}
BOUND = 1e-6  # fp64 batched against the exact path
CLI_ARGS = ["--mode", "resquiggle", "-p", "rna002", "--batch_size", "2", "-q", "0",
            "--max_batches", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of tiny torch ops, where intra-op
    threads only contend for the cores (and with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    model = load_model_for_pore("rna002")
    path = tmp_path_factory.mktemp("ntc_train") / "reads.tsv"
    with open(path, "w") as f:
        for i in range(2):
            sig, read = make_read(model, n_bases=25, seed=i)
            f.write(f"read{i}\tread{i}\t{','.join(repr(float(x)) for x in sig)}"
                    f"\t{read[9:][::-1]}\n")  # 5'->3' RNA, no polyA stub
    return path


@pytest.fixture(scope="module")
def jax_run(tsv, tmp_path_factory):
    """JAX's dynamont-train --mode resquiggle on the TSV (fp64 on the CPU,
    every read on the exact path), with the first NTCBatchEngine.train call
    it makes — the batch's training — kept as (model, transitions, items,
    results); the transitions are copied, as the Trainer updates its dict
    in place after the call."""
    out = tmp_path_factory.mktemp("jax_train") / "out"
    kept = []
    train = jax_ntc_batch.NTCBatchEngine.train

    def spy(self, items):
        overrides = dict(self.overrides)
        res = train(self, items)
        kept.append((self.model, overrides, items, res))
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DYNAMONT_NO_COMPILE_CACHE", "1")
        mp.setattr(jax_ntc_batch.NTCBatchEngine, "train", spy)
        jax_cli.main(["--tsv", str(tsv), "-o", str(out), *CLI_ARGS])
    return out, kept[0]


def _assert_trained(got, want, z_rel, t_rel, t_abs, common_share, m_rel, m_abs,
                    s_rel, s_abs, flip_sd):
    """One read's (transitions, emissions, Z) against the exact path's."""
    tg, eg, zg = got
    tw, ew, zw = want
    assert abs(zg - zw) <= z_rel * abs(zw), (zg, zw)
    assert tg.keys() == tw.keys()
    for k, v in tw.items():
        assert tg[k] == pytest.approx(v, rel=t_rel, abs=t_abs), k
    common = set(eg) & set(ew)
    assert len(common) >= common_share * max(len(eg), len(ew))
    for kmer in common:
        assert eg[kmer][0] == pytest.approx(ew[kmer][0], rel=m_rel, abs=m_abs), kmer
        assert eg[kmer][1] == pytest.approx(ew[kmer][1], rel=s_rel, abs=s_abs), kmer
    for kmer in set(eg) ^ set(ew):
        assert (eg.get(kmer) or ew.get(kmer))[1] < flip_sd, kmer


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_engine_train_matches_jax_exact(jax_run, dtype):
    jm, overrides, items, want = jax_run[1]
    m = PoreModel(np.asarray(jm.means), np.asarray(jm.stdevs), jm.alphabet_size,
                  jm.kmer_size, jm.rna)
    eng = torch_ntc_batch.NTCBatchEngine(m, "rna002", device="cpu",
                                         transition_overrides=overrides,
                                         dtype=DTYPES[dtype], **PAD)
    outs = eng.train([BatchItem(it.signal, it.read) for it in items])
    assert eng.profile["exact_retries"] == 0
    for got, w in zip(outs, want):
        assert not isinstance(got, Exception) and not isinstance(w, Exception), (got, w)
        if dtype == "float64":
            _assert_trained(got, w, BOUND, BOUND, 0.0, 0.95, BOUND, 0.0, BOUND,
                            0.0, BOUND)
        else:
            _assert_trained(got, w, 2e-2 / abs(w[2]), 2e-3, 1e-6, 0.95, 1e-4, 1e-3,
                            5e-3, 1e-3, math.inf)


def _params(outdir):
    with open(os.path.join(outdir, "params.csv")) as f:
        lines = f.read().strip().split("\n")
    return lines[0], [ln.split(",") for ln in lines[1:]]


def test_cli_train_resquiggle_matches_jax(tsv, jax_run, tmp_path, monkeypatch):
    out_j = jax_run[0]
    out_t = tmp_path / "torch"
    monkeypatch.setattr(torch_trainer, "NTCBatchEngine", functools.partial(
        torch_ntc_batch.NTCBatchEngine, **PAD))
    kept = []
    batch = torch_trainer.Trainer._train_batch_ntc
    monkeypatch.setattr(torch_trainer.Trainer, "_train_batch_ntc",
                        lambda self, *a: kept.append(batch(self, *a)) or kept[-1])
    trainer = torch_cli.main(["--tsv", str(tsv), "-o", str(out_t), "--device", "cpu",
                              *CLI_ARGS])
    assert trainer.precision == "fp64" and trainer.fp64_reads == 0
    head_t, rows_t = _params(out_t)
    head_j, rows_j = _params(out_j)
    assert head_t == head_j
    assert len(rows_t) == len(rows_j) == 1
    assert rows_t[0][:3] == rows_j[0][:3] == ["0", "1", "2"]
    got, want = (np.array(r[0][3:-1], float) for r in (rows_t, rows_j))
    np.testing.assert_allclose(got, want, rtol=BOUND, atol=0)
    z = max(abs(x[2]) for x in jax_run[1][3])
    assert abs(float(rows_t[0][-1]) - float(rows_j[0][-1])) <= BOUND * z
    # a k-mer trained on one cell may be reported on one side only (see
    # the module docstring); its pooled checkpoint values then differ
    flips = set()
    for res_t, res_j in zip(kept[0], jax_run[1][3]):
        et, ej = res_t[1], res_j[1]
        flips |= set(et) ^ set(ej)
        flips |= {k for e in (et, ej) for k, (_, sd) in e.items() if sd < BOUND}
    for name in ("trained_0_0.model", "trained_0_1.model"):
        kt = read_kmer_models(str(out_t / name))
        kj = read_kmer_models(str(out_j / name))
        assert kt.keys() == kj.keys()
        for kmer in set(kt) - flips:
            np.testing.assert_allclose(kt[kmer], kj[kmer], rtol=BOUND, atol=0,
                                       err_msg=kmer)


def test_cli_train_resquiggle_without_cuda_fails(tsv, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        torch_cli.main(["--tsv", str(tsv), "-o", str(tmp_path / "o"), "--device", "cuda",
                        *CLI_ARGS])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()

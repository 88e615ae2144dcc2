"""Native big-K NTC (`--ntc-native-9mer`) in the port against dynamont_tpu,
on the CPU, with a seeded synthetic 7-mer table (K = 16384 > 4096: the
TK pre-pass takes pre_tk_batch_ckpt and its big-K sums, as at K = 4^9;
the real 9-mer tables are not in the repository).

* NTCBatchEngine(native_kmer=True) against JAX's (scan path, caps (8, 120),
  t_pad_to 64, n_pad_to 16) on two short reads in fp64: the model is not
  reduced, states, borders and polish k-mers (native 7-mers) identical,
  probabilities within 1e-9, Z within rel 1e-12 (the fp64 contract);
* the CLI, --mode resquiggle --ntc-native-9mer with the table as
  --model_path, against JAX's CLI on the same TSV (both fp32): every CSV
  column identical but the probability, which agrees within 2e-3 (the
  repo's fp32 bound); no error line.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard as zstd

from dynamont_tpu.cli import resquiggle as jax_cli
from dynamont_tpu.models import ntc_batch as jax_ntc_batch
from dynamont_tpu.models.batch import BatchItem as JaxItem
from dynamont_tpu.models.registry import load_model_for_pore as jax_load
from dynamont_tpu_torch.cli import resquiggle as torch_cli
from dynamont_tpu_torch.models import ntc_batch as torch_ntc_batch
from dynamont_tpu_torch.models.batch import BatchItem
from dynamont_tpu_torch.models.registry import load_model_for_pore

from tests.synthetic import make_read

PAD = dict(t_pad_to=64, n_pad_to=16)
K7 = 4 ** 7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run thousands of tiny torch ops, where intra-op
    threads only contend for the cores (and with the other test workers):
    one thread is 2-30x faster here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def table7(tmp_path_factory):
    """A seeded 7-mer table (means U(-2, 2), stdevs U(0.15, 0.4), as
    tests/test_9mer.py builds its 9-mer ones) as an .npz model file."""
    rng = np.random.default_rng(11)
    path = str(tmp_path_factory.mktemp("m7") / "rna7.npz")
    np.savez(path, means=rng.uniform(-2.0, 2.0, K7),
             stdevs=rng.uniform(0.15, 0.4, K7), alphabet_size=4, kmer_size=7)
    return path


@pytest.fixture(scope="module")
def reads(table7):
    model = jax_load("rna004", table7)
    return [make_read(model, n_bases=n, seed=s) for s, n in ((3, 14), (4, 11))]


def test_native_engine_matches_jax(table7, reads):
    jeng = jax_ntc_batch.NTCBatchEngine(jax_load("rna004", table7), "rna004",
                                        dtype=jnp.float64, native_kmer=True,
                                        pallas=False, cap_n=8, cap_k=120, **PAD)
    want = jeng.run([JaxItem(s, r) for s, r in reads])
    eng = torch_ntc_batch.NTCBatchEngine(load_model_for_pore("rna004", table7),
                                         "rna004", device="cpu",
                                         dtype=torch.float64, native_kmer=True,
                                         **PAD)
    got = eng.run([BatchItem(s, r) for s, r in reads])
    assert eng.model.kmer_size == 7 and eng.model.num_kmers == K7
    assert eng.profile["wide_retries"] == eng.profile["exact_retries"] == 0
    for g, w in zip(got, want):
        assert g.error is None and w.error is None, (g.error, w.error)
        assert abs(g.Z - w.Z) <= 1e-12 * abs(w.Z)
        assert len(g.segments) == len(w.segments) > 0
        assert [s[:3] + s[4:] for s in g.segments] == [s[:3] + s[4:] for s in w.segments]
        assert all(len(s[4]) == 7 for s in g.segments)
        assert max(abs(a[3] - b[3]) for a, b in zip(g.segments, w.segments)) <= 1e-9


def _rows(path):
    with open(path, "rb") as f:
        data = zstd.ZstdDecompressor().stream_reader(
            f, read_across_frames=True).read()
    lines = data.decode().strip().split("\n")
    return lines[0], [ln.split(",") for ln in lines[1:]]


def test_cli_native_matches_jax(table7, reads, tmp_path, monkeypatch):
    tsv = tmp_path / "reads.tsv"
    with open(tsv, "w") as f:
        for i, (sig, read) in enumerate(reads):
            f.write(f"read{i}\tread{i}\t{','.join(repr(float(x)) for x in sig)}"
                    f"\t{read[9:][::-1]}\n")  # 5'->3' RNA, no polyA stub
    monkeypatch.setattr(jax_ntc_batch, "NTCBatchEngine", functools.partial(
        jax_ntc_batch.NTCBatchEngine, cap_k=120, **PAD))
    monkeypatch.setattr(torch_ntc_batch, "NTCBatchEngine", functools.partial(
        torch_ntc_batch.NTCBatchEngine, **PAD))
    out_j, out_t = tmp_path / "jax.csv.zst", tmp_path / "torch.csv.zst"
    args = ["--tsv", str(tsv), "--mode", "resquiggle", "-p", "rna004",
            "--model_path", table7, "--ntc-native-9mer"]
    jax_cli.main(args + ["-o", str(out_j)])
    eng = torch_cli.main(args + ["-o", str(out_t), "--device", "cpu"])
    assert eng.model.num_kmers == K7
    head_j, rows_j = _rows(out_j)
    head_t, rows_t = _rows(out_t)
    assert head_t == head_j
    assert len(rows_t) == len(rows_j) > 0
    assert {r[0] for r in rows_t} == {"read0", "read1"}
    keep = [i for i in range(len(rows_j[0])) if i != 8]
    for rt, rj in zip(rows_t, rows_j):
        assert [rt[i] for i in keep] == [rj[i] for i in keep]
    diff = np.abs(np.array([float(r[8]) for r in rows_t])
                  - np.array([float(r[8]) for r in rows_j]))
    assert diff.max() <= 2e-3, diff.max()
    assert not (tmp_path / "jax.errors").exists()
    assert not (tmp_path / "torch.errors").exists()

"""The port's batched NTC engine and its `dynamont-resquiggle --mode
resquiggle` against dynamont_tpu's, on the CPU (the plain versions of
K7-K11, K13, K15, K16).

* NTCBatchEngine against JAX's NTCBatchEngine(pallas=False, cap_n=8,
  cap_k=120) on three ragged reads: fp64 states, borders and polish k-mers
  identical, probabilities within 1e-9, Z within rel 1e-12; fp32 borders
  identical, probabilities within 2e-3 (the repo's fp32-against-fp64
  bound), Z within rel 1e-5.
* The escalation ladder: tiny caps without the wide rung send a read to
  the exact per-read path, whose result it then is exactly; with the wide
  rung every read is repaired at (16, 240) and none reaches the exact path.
* The CLI in resquiggle mode against JAX's on one TSV; --device cuda
  without a card exits 2; a native 9-mer engine keeps its K and refuses
  training, which runs at K <= 4096 only.

Both packages pad buckets with t_pad_to 64 and n_pad_to 16 here (the CLI
runs are patched to it) so that the CPU runs stay short; padding changes no
output.
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
from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu_torch.cli import resquiggle as torch_cli
from dynamont_tpu_torch.models import ntc_batch as torch_ntc_batch
from dynamont_tpu_torch.models.batch import BatchItem
from dynamont_tpu_torch.models.ntc import run_ntc
from dynamont_tpu_torch.utils.pore_model import PoreModel

from tests.synthetic import make_read

PAD = dict(t_pad_to=64, n_pad_to=16)
DTYPES = {"float64": (torch.float64, jnp.float64),
          "float32": (torch.float32, jnp.float32)}


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
def model():
    return load_model_for_pore("rna002")


@pytest.fixture(scope="module")
def reads(model):
    return [make_read(model, n_bases=n, seed=s)
            for s, n in ((0, 25), (1, 31), (2, 18))]


@pytest.fixture(scope="module")
def jax_outs(model, reads):
    out = {}
    for name, (_, jdt) in DTYPES.items():
        eng = jax_ntc_batch.NTCBatchEngine(model, "rna002", dtype=jdt,
                                           pallas=False, cap_n=8, cap_k=120,
                                           **PAD)
        out[name] = eng.run([JaxItem(s, r) for s, r in reads])
    return out


@pytest.fixture(scope="module")
def exact(model, reads):
    return [run_ntc(s, r, model, "rna002", device="cpu") for s, r in reads]


def _engine(model, dtype, **kw):
    return torch_ntc_batch.NTCBatchEngine(model, "rna002", device="cpu",
                                          dtype=dtype, **PAD, **kw)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_engine_matches_jax(model, reads, jax_outs, dtype):
    eng = _engine(model, DTYPES[dtype][0])
    outs = eng.run([BatchItem(s, r) for s, r in reads])
    assert eng.profile["wide_retries"] == eng.profile["exact_retries"] == 0
    fp64 = dtype == "float64"
    for got, want in zip(outs, jax_outs[dtype]):
        assert got.error is None and want.error is None, (got.error, want.error)
        assert abs(got.Z - want.Z) <= (1e-12 if fp64 else 1e-5) * abs(want.Z)
        assert len(got.segments) == len(want.segments) > 0
        key = (lambda s: s[:3] + s[4:]) if fp64 else (lambda s: s[1:3])
        assert [key(s) for s in got.segments] == [key(s) for s in want.segments]
        dp = max(abs(g[3] - w[3]) for g, w in zip(got.segments, want.segments))
        assert dp <= (1e-9 if fp64 else 2e-3), dp


def test_overflow_falls_back_to_exact(model, reads, exact):
    """Tiny caps overflow; without the wide rung the read takes the exact
    per-read path, so its result is that path's exactly."""
    eng = _engine(model, torch.float64, cap_n=2, cap_k=2, wide_retry=False)
    outs = eng.run([BatchItem(*reads[0])])
    assert eng.profile["exact_retries"] == 1 and eng.profile["wide_retries"] == 0
    assert outs[0].error is None
    assert outs[0].segments == exact[0].segments
    assert outs[0].Z == exact[0].Z


def test_wide_rung_repairs_overflow(model, reads, exact):
    """Tiny caps overflow; the wide rung at (16, 240) repairs every read in
    one bucket and none reaches the exact path."""
    eng = _engine(model, torch.float64, cap_n=2, cap_k=2)
    outs = eng.run([BatchItem(s, r) for s, r in reads])
    assert eng.profile["wide_retries"] == len(reads)
    assert eng.profile["exact_retries"] == 0
    for got, want in zip(outs, exact):
        assert got.error is None, got.error
        assert abs(got.Z - want.Z) <= 1e-6 * abs(want.Z)
        assert [s[:3] + s[4:] for s in got.segments] == [s[:3] + s[4:] for s in want.segments]
        assert max(abs(g[3] - w[3]) for g, w in zip(got.segments, want.segments)) <= 1e-6


def test_bucket_program_keeps_kernel_inputs(model, reads):
    """`keep` hands out each lattice kernel's inputs and outputs (the smoke
    run holds the kernels to their plain versions on them) without
    changing the bucket's results; the kept store is the backward store
    from before lp was written over it."""
    eng = _engine(model, torch.float64)
    gidx = list(range(len(reads)))
    items = [BatchItem(s, r) for s, r in reads]
    keep = {}
    with_keep = eng._dispatch(gidx, items, 8, 120, keep=keep)[3]
    without = eng._dispatch(gidx, items, 8, 120)[3]
    assert with_keep.keys() == without.keys()
    for name in without:
        assert torch.equal(with_keep[name], without[name]), name
    kern = torch_ntc_batch.kern
    plan, dims, prm, sig = keep["plan"], keep["dims"], keep["prm"], keep["sig"]
    tl, N_r, T_r = keep["trans_log"], keep["N_r"], keep["T_r"]
    for got, want in zip(prm, kern.tab_gather_plain(keep["ks"], keep["table"], dims)):
        assert torch.equal(got, want)
    assert torch.equal(keep["bwd"], kern.bwd_plain(plan, dims, prm, sig, tl, N_r, T_r))
    pv = kern.pv_plain(plan, dims, prm, sig, keep["bwd"], keep["Zb"], tl, T_r)
    for name, want in zip(("lp", "choices", "slots", "apEf", "fwdEf"), pv):
        assert torch.equal(keep[name], want), name
    rec, fin = kern.walk_plain(keep["lp"], keep["choices"], keep["slots"], plan,
                               *keep["start"], N_r, T_r, *keep["walk_dims"])
    assert torch.equal(keep["rec"], rec) and torch.equal(keep["fin"], fin)


def test_engine_refuses_what_is_not_ported(model):
    """Native 9-mer NTC segmentation is ported (tests/test_torch_ntc_native.py):
    a 9-mer model with native_kmer=True keeps its K = 4^9 and gets the big-K
    wide caps. NTC training at that K is not (the JAX package trains no
    native big-K model either): train() refuses it. No 9-mer table is in
    the repo, so a synthetic one stands in (seeded means, one stdev)."""
    K = 4 ** 9
    nine = PoreModel(np.random.default_rng(0).normal(90.0, 10.0, K),
                     np.full(K, 2.0), 4, 9, True)
    eng = torch_ntc_batch.NTCBatchEngine(nine, "rna002", device="cpu",
                                         native_kmer=True)
    assert eng.model.num_kmers == K
    assert eng.wide_caps == torch_ntc_batch.BIGK_WIDE_CAPS
    with pytest.raises(NotImplementedError, match="K <= 4096"):
        eng.train([BatchItem(np.zeros(100), "A" * 20)])
    assert torch_ntc_batch.NTCBatchEngine(model, "rna002", device="cpu").wide_caps \
        == torch_ntc_batch.WIDE_CAPS


def _rows(path):
    with open(path, "rb") as f:
        data = zstd.ZstdDecompressor().stream_reader(
            f, read_across_frames=True).read()
    lines = data.decode().strip().split("\n")
    return lines[0], [ln.split(",") for ln in lines[1:]]


@pytest.fixture(scope="module")
def tsv(tmp_path_factory, reads):
    path = tmp_path_factory.mktemp("ntc_cli") / "reads.tsv"
    with open(path, "w") as f:
        for i, (sig, read) in enumerate(reads):
            f.write(f"read{i}\tread{i}\t{','.join(repr(float(x)) for x in sig)}"
                    f"\t{read[9:][::-1]}\n")  # 5'->3' RNA, no polyA stub
    return path


def test_cli_resquiggle_matches_jax(tsv, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_ntc_batch, "NTCBatchEngine", functools.partial(
        jax_ntc_batch.NTCBatchEngine, cap_k=120, **PAD))
    monkeypatch.setattr(torch_ntc_batch, "NTCBatchEngine", functools.partial(
        torch_ntc_batch.NTCBatchEngine, **PAD))
    out_j, out_t = tmp_path / "jax.csv.zst", tmp_path / "torch.csv.zst"
    args = ["--tsv", str(tsv), "--mode", "resquiggle", "-p", "rna002"]
    jax_cli.main(args + ["-o", str(out_j)])
    torch_cli.main(args + ["-o", str(out_t), "--device", "cpu"])
    head_j, rows_j = _rows(out_j)
    head_t, rows_t = _rows(out_t)
    assert head_t == head_j
    assert len(rows_t) == len(rows_j) > 0
    assert {r[0] for r in rows_t} == {"read0", "read1", "read2"}
    keep = [i for i in range(len(rows_j[0])) if i != 8]
    for rt, rj in zip(rows_t, rows_j):
        assert [rt[i] for i in keep] == [rj[i] for i in keep]
    diff = np.abs(np.array([float(r[8]) for r in rows_t])
                  - np.array([float(r[8]) for r in rows_j]))
    assert diff.max() <= 2e-3, diff.max()
    assert not (tmp_path / "jax.errors").exists()
    assert not (tmp_path / "torch.errors").exists()


def test_cli_resquiggle_without_cuda_fails(tsv, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        torch_cli.main(["--tsv", str(tsv), "-o", str(tmp_path / "o.csv.zst"),
                        "--mode", "resquiggle", "-p", "rna002",
                        "--device", "cuda"])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "o.csv.zst").exists()

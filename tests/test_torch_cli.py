"""The port's dynamont-resquiggle --mode basic against dynamont_tpu's, on
the same TSV: columns 0-7 and 9 byte-identical, probabilities within 2e-3
(the fp32-against-fp64 bound of tests/test_device_pipeline.py; the two
runs are fp32 engines of different frameworks). A read that crashes the
engine leaves the same sidecar line and repro dump as in dynamont_tpu;
--ntc-native-9mer runs; the native big-K exact rung refuses a long read."""

import functools

import numpy as np
import pytest
import zstandard as zstd

from dynamont_tpu.cli import resquiggle as jax_cli
from dynamont_tpu.models.batch import BandedBatchEngine as JaxBandedEngine
from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu_torch.cli import resquiggle as torch_cli
from dynamont_tpu_torch.models import ntc_batch as torch_ntc_batch
from dynamont_tpu_torch.models.batch import BandedBatchEngine, BatchItem
from dynamont_tpu_torch.utils.pore_model import PoreModel

from tests.synthetic import make_read


def _write_tsv(path, items):
    with open(path, "w") as f:
        for rid, sig, read in items:
            f.write(f"{rid}\t{rid}\t{','.join(repr(float(x)) for x in sig)}"
                    f"\t{read}\n")


def _rows(path):
    with open(path, "rb") as f:
        data = zstd.ZstdDecompressor().stream_reader(
            f, read_across_frames=True).read()
    lines = data.decode().strip().split("\n")
    return lines[0], [ln.split(",") for ln in lines[1:]]


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    model = load_model_for_pore("rna002")
    items = []
    for s in range(3):
        sig, read_proc = make_read(model, n_bases=40 + 10 * s, seed=140 + s)
        items.append((f"read{s}", sig, read_proc[9:][::-1]))  # 5'->3' RNA
    path = tmp_path_factory.mktemp("cli") / "reads.tsv"
    _write_tsv(path, items)
    return path


def test_port_cli_matches_jax_cli(tsv, tmp_path):
    out_j = tmp_path / "jax.csv.zst"
    out_t = tmp_path / "torch.csv.zst"
    args = ["--tsv", str(tsv), "--mode", "basic", "-p", "rna002"]
    jax_cli.main(args + ["-o", str(out_j)])
    torch_cli.main(args + ["-o", str(out_t), "--device", "cpu"])
    head_j, rows_j = _rows(out_j)
    head_t, rows_t = _rows(out_t)
    assert head_t == head_j
    assert len(rows_t) == len(rows_j) > 0
    assert {r[0] for r in rows_t} == {"read0", "read1", "read2"}
    keep = [0, 1, 2, 3, 4, 5, 6, 7, 9]
    for rt, rj in zip(rows_t, rows_j):
        assert [rt[i] for i in keep] == [rj[i] for i in keep]
    diff = np.abs(np.array([float(r[8]) for r in rows_t])
                  - np.array([float(r[8]) for r in rows_j]))
    assert diff.max() <= 2e-3, diff.max()
    assert not (tmp_path / "jax.errors").exists()
    assert not (tmp_path / "torch.errors").exists()


def _record_chunks(monkeypatch, engine, events):
    """Append "d" to events for each dispatch() and "c" for each collect()."""
    orig_dispatch, orig_collect = engine.dispatch, engine.collect

    def dispatch(self, items):
        events.append("d")
        return orig_dispatch(self, items)

    def collect(self, handle):
        events.append("c")
        return orig_collect(self, handle)

    monkeypatch.setattr(engine, "dispatch", dispatch)
    monkeypatch.setattr(engine, "collect", collect)


def test_multi_chunk_run_keeps_three_chunks_in_flight(tmp_path, monkeypatch):
    """13 reads at --batch_size 1 are four chunks of up to 4 reads: both
    CLIs dispatch the first four before collecting the first (3 in flight
    ahead of collection) and write the same CSV (as
    test_port_cli_matches_jax_cli) and the same error sidecar for a read
    that fails validation."""
    model = load_model_for_pore("rna002")
    items = []
    for s in range(12):
        sig, read_proc = make_read(model, n_bases=30 + 2 * s, seed=160 + s)
        items.append((f"read{s}", sig, read_proc[9:][::-1]))
    items.insert(5, ("short", np.full(8, 0.5), "ACGTACGTACGTACGT"))
    tsv = tmp_path / "reads.tsv"
    _write_tsv(tsv, items)
    args = ["--tsv", str(tsv), "--mode", "basic", "-p", "rna002",
            "--batch_size", "1"]
    events = {"jax": [], "torch": []}
    _record_chunks(monkeypatch, JaxBandedEngine, events["jax"])
    _record_chunks(monkeypatch, BandedBatchEngine, events["torch"])
    jax_cli.main(args + ["-o", str(tmp_path / "jax.csv.zst")])
    torch_cli.main(args + ["-o", str(tmp_path / "torch.csv.zst"), "--device", "cpu"])
    assert torch_cli.INFLIGHT == 3
    assert events["torch"] == events["jax"] == list("ddddcccc")
    head_j, rows_j = _rows(tmp_path / "jax.csv.zst")
    head_t, rows_t = _rows(tmp_path / "torch.csv.zst")
    assert head_t == head_j
    assert len(rows_t) == len(rows_j) > 0
    assert len({r[0] for r in rows_t}) == 12
    keep = [0, 1, 2, 3, 4, 5, 6, 7, 9]
    for rt, rj in zip(rows_t, rows_j):
        assert [rt[i] for i in keep] == [rj[i] for i in keep]
        assert abs(float(rt[8]) - float(rj[8])) <= 2e-3
    err = (tmp_path / "torch.errors").read_bytes()
    assert b"Rid: short" in err
    assert err == (tmp_path / "jax.errors").read_bytes()


class _StubNTCEngine:
    """Stands in for both packages' NTCBatchEngine: records the bucket
    size it is built with and the size of every dispatched chunk, and
    gives each read segments made from that read alone (one per base,
    evenly spaced), so that the CSV depends on the reads and not on how
    they were chunked."""

    built: list = []
    chunks: list = []

    def __init__(self, model, pore, batch_size=None, **kwargs):
        self.model = model
        self.built.append(batch_size)

    def dispatch(self, items):
        self.chunks.append(len(items))
        return items

    def collect(self, items):
        from types import SimpleNamespace

        outs = []
        for it in items:
            L, T = len(it.read), len(it.signal)
            segs = [("M", b, b * (T // L), 0.5 + b / 1000.0) for b in range(L)]
            outs.append(SimpleNamespace(item=it, segments=segs, summaries=None,
                                        error=None))
        return outs

    def run(self, items):
        return self.collect(self.dispatch(items))


def test_resquiggle_chunk_is_jax_chunk(tmp_path, monkeypatch):
    """Resquiggle mode without --batch_size: 130 reads go out as a
    128-read chunk ((batch_size or 32) * 4, as dynamont_tpu's CLI cuts
    them) and a 2-read one, into 16-read buckets, in both CLIs; with
    --batch_size 16 the port cuts 64-read chunks, and its CSV is the same
    bytes."""
    from dynamont_tpu.models import ntc_batch as jax_ntc_batch

    monkeypatch.setattr(torch_ntc_batch, "NTCBatchEngine", _StubNTCEngine)
    monkeypatch.setattr(jax_ntc_batch, "NTCBatchEngine", _StubNTCEngine)
    model = load_model_for_pore("rna002")
    items = []
    for s in range(130):
        sig, read_proc = make_read(model, n_bases=20, seed=300 + s)
        items.append((f"read{s}", sig, read_proc[9:][::-1]))
    tsv = tmp_path / "reads.tsv"
    _write_tsv(tsv, items)
    args = ["--tsv", str(tsv), "--mode", "resquiggle", "-p", "rna002"]
    runs = {"jax": [], "torch": [], "torch16": ["--batch_size", "16"]}
    got = {}
    for name, extra in runs.items():
        _StubNTCEngine.built, _StubNTCEngine.chunks = [], []
        out = tmp_path / f"{name}.csv.zst"
        if name == "jax":
            jax_cli.main(args + ["-o", str(out)])
        else:
            torch_cli.main(args + extra + ["-o", str(out), "--device", "cpu"])
        got[name] = (_StubNTCEngine.built, _StubNTCEngine.chunks, _rows(out))
    assert got["jax"][:2] == got["torch"][:2] == ([16], [128, 2])
    assert got["torch16"][:2] == ([16], [64, 64, 2])
    head, rows = got["torch"][2]
    assert len({r[0] for r in rows}) == 130
    assert got["torch16"][2] == got["jax"][2] == (head, rows)


def test_port_cli_refuses_native_9mer(tsv, tmp_path, monkeypatch):
    """--ntc-native-9mer is no longer refused: it runs resquiggle mode (with
    rna002's 5-mer table it changes nothing, as in dynamont_tpu; the native
    big-K path is tests/test_torch_ntc_native.py's)."""
    monkeypatch.setattr(torch_ntc_batch, "NTCBatchEngine", functools.partial(
        torch_ntc_batch.NTCBatchEngine, t_pad_to=64, n_pad_to=16))
    out = tmp_path / "o.csv.zst"
    eng = torch_cli.main(["--tsv", str(tsv), "-o", str(out), "--mode",
                          "resquiggle", "-p", "rna002", "--ntc-native-9mer",
                          "--device", "cpu"])
    assert eng.model.kmer_size == 5
    _, rows = _rows(out)
    assert {r[0] for r in rows} == {"read0", "read1", "read2"}
    assert not (tmp_path / "o.errors").exists()


def _crash(monkeypatch, engine):
    """collect() raises for multi-read chunks; the per-read isolation then
    goes through run(), where only readid "read1" keeps crashing."""
    orig_collect, orig_run = engine.collect, engine.run

    def crashing_collect(self, handle):
        if len(handle[0]) > 1:
            raise RuntimeError("synthetic chunk crash")
        return orig_collect(self, handle)

    def crashing_run(self, batch_items):
        if any(getattr(it.meta, "readid", None) == "read1" for it in batch_items):
            raise RuntimeError("synthetic per-read crash")
        return orig_run(self, batch_items)

    monkeypatch.setattr(engine, "collect", crashing_collect)
    monkeypatch.setattr(engine, "run", crashing_run)


def test_engine_crash_leaves_repro_dump_as_jax(tsv, tmp_path, monkeypatch):
    """The case of tests/test_cli_robustness.py on both CLIs: the healthy
    reads are segmented, the crashing one gets failed_input_read1.txt in
    the working directory and a `dump:` field on its sidecar line; both
    byte for byte dynamont_tpu's."""
    _crash(monkeypatch, JaxBandedEngine)
    _crash(monkeypatch, BandedBatchEngine)
    args = ["--tsv", str(tsv), "--mode", "basic", "-p", "rna002"]
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("torch", torch_cli.main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)  # the dump lands in cwd
        main(args + ["-o", str(tmp_path / name / "out.csv.zst")] + extra)
        _, rows = _rows(tmp_path / name / "out.csv.zst")
        assert {r[0] for r in rows} == {"read0", "read2"}
    read = lambda name, f: (tmp_path / name / f).read_bytes()
    err = read("torch", "out.errors").decode()
    assert "engine exception" in err and "read1" in err
    assert "\tdump: failed_input_read1.txt" in err
    assert read("torch", "out.errors") == read("jax", "out.errors")
    assert read("torch", "failed_input_read1.txt") == read("jax", "failed_input_read1.txt")
    sig_line, read_line = read("torch", "failed_input_read1.txt").decode().strip().split("\n")
    assert len(sig_line.split(",")) > 0 and set(read_line) <= set("ACGTU")


def test_native_9mer_exact_path_refuses_long_reads():
    """The exact per-read fp64 rung at K = 4^9 would allocate ~4 T*K fp64
    matrices (~70 GB at production T): the engine refuses the read with
    dynamont_tpu's error instead (tests/test_9mer.py's case; a synthetic
    seeded 9-mer table stands in for the real one)."""
    K = 4 ** 9
    rng = np.random.default_rng(11)
    nine = PoreModel(rng.uniform(-2.0, 2.0, K), rng.uniform(0.15, 0.4, K), 4, 9, True)
    eng = torch_ntc_batch.NTCBatchEngine(nine, "rna004", device="cpu",
                                         native_kmer=True)
    assert eng.model.num_kmers == K  # not reduced
    out = eng._run_exact(BatchItem(np.zeros(4096), "A" * 500))
    assert out.error is not None and "too long" in out.error
    # reads under ~1k samples at K = 4^9 stay eligible for the exact path
    assert (1000 + 1) * K * 8 < 2**31


def test_port_cli_without_cuda_fails(tsv, tmp_path, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        torch_cli.main(["--tsv", str(tsv), "-o", str(tmp_path / "o.csv.zst"),
                        "--mode", "basic", "-p", "rna002"])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "o.csv.zst").exists()

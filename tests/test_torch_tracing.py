"""The port's tracer (dynamont_tpu_torch/tracing.py) in its engines, on the
CPU (the kernels' plain versions), and the benchmark's readers of it.

* Off (the default): an engine run counts nothing, enters no
  record_function, and gives the outputs of a traced run.
* On under torch.profiler: the chrome trace holds the engine's spans nested
  as the tracer saw them; each bucket span's reads, samples and padded
  samples are those of a bucket the packer made, and add up to the
  profile's deltas; a span's self time is its time less its children's;
  the totals are cleared when tracing next turns on from off. The same for
  the NTC engine, its rungs included, and for the banded matrix route's
  buckets. With `tracing.enable()` alone no record_function is entered.
* --profile prints a line per span name and the fill of the buckets.
* The three readers of the totals and the trace on hand-made ones, and
  the two readers that were there before read the same with the program's
  spans in the trace as without them.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dynamont_tpu_torch import tracing
from dynamont_tpu_torch.cli import resquiggle as cli
from dynamont_tpu_torch.models import ntc_batch
from dynamont_tpu_torch.models.batch import T_PAD_TO, BandedBatchEngine, BatchItem
from dynamont_tpu_torch.models.packing import round_up, t_pad_ladder
from dynamont_tpu_torch.models.registry import load_model_for_pore
from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.utils.synthetic import make_read

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each span's parents (the matrix route's bucket is under its collect)
BANDED_TREE = {"banded.pack": ("banded.dispatch",),
               "banded.bucket": ("banded.dispatch", "banded.collect"),
               "banded.kmers": ("banded.bucket",), "banded.wire": ("banded.bucket",),
               "banded.launch": ("banded.bucket",), "banded.to_host": ("banded.bucket",),
               "banded.wait": ("banded.collect",), "banded.gate": ("banded.collect",),
               "banded.fp64_rung": ("banded.gate",)}
NTC_TREE = {"ntc.bucket": ("ntc.dispatch", "ntc.wide_rung"),
            "ntc.pad": ("ntc.bucket",), "ntc.prepass": ("ntc.bucket",),
            "ntc.plan": ("ntc.bucket",), "ntc.lattice": ("ntc.bucket",),
            "ntc.walk": ("ntc.bucket",), "ntc.gate": ("ntc.collect", "ntc.wide_rung"),
            "ntc.wide_rung": ("ntc.collect",), "ntc.exact_rung": ("ntc.collect",)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tracing_off():
    yield
    tracing.disable()


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


@pytest.fixture(scope="module")
def items(model):
    """Five reads of 150-450 samples: three buckets of at most two."""
    return [BatchItem(*make_read(model, n_bases=16 + 8 * s, seed=40 + s))
            for s in range(5)]


def _engine(model, **kw):
    return BandedBatchEngine(model, "rna002", device="cpu", dtype=torch.float64,
                             batch_size=2, **kw)


def _chunks(eng, items):
    """Two chunks in flight, as the CLI's window runs them."""
    a, b = eng.dispatch(items[:3]), eng.dispatch(items[3:])
    return eng.collect(a) + eng.collect(b)


def _spy(mp) -> list:
    """Every span the tracer closes from now on, as (name, its parent's
    name, its counts), in the order closed."""
    got = []
    close = tracing._Span.__exit__

    def spy(self, *exc):
        got.append((self.name, self.parent.name if self.parent else None,
                    dict(self.counts)))
        return close(self, *exc)

    mp.setattr(tracing._Span, "__exit__", spy)
    return got


def _traced(run, tmp_path):
    """(result, the spans closed, the chrome trace's program spans) of run()
    under torch.profiler; without tmp_path, of run() after
    tracing.enable(), which must enter no record_function."""
    with pytest.MonkeyPatch.context() as mp:
        spans = _spy(mp)
        if tmp_path is None:
            def refuse(name):
                raise AssertionError(f"record_function({name!r}) without a profiler")

            mp.setattr(torch.profiler, "record_function", refuse)
            tracing.enable()
            return run(), spans, None
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            result = run()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return result, spans, events


def _trace_parents(events) -> dict:
    """Each span of the chrome trace -> the innermost span enclosing it."""
    out = {}
    for e in events:
        outer = [o for o in events if o is not e and o["ts"] <= e["ts"]
                 and e["ts"] + e["dur"] <= o["ts"] + o["dur"] and o["dur"] >= e["dur"]]
        out[id(e)] = min(outer, key=lambda o: o["dur"])["name"] if outer else None
    return out


def _check_nesting(spans, events, tree):
    """Every span under a parent that `tree` allows; the chrome trace holds
    the same spans under the same parents; the totals count them all, each
    name's time less its self time being its children's time."""
    for name, parent, _ in spans:
        assert parent in tree.get(name, (None,)), (name, parent)
    assert not tracing._stack
    tot = tracing.totals()
    assert {n: t.n for n, t in tot.items()} == {
        n: [s[0] for s in spans].count(n) for n in {s[0] for s in spans}}
    for name, t in tot.items():
        kids = {s[0] for s in spans if s[1] == name}
        assert 0 <= t.self_ns <= t.ns
        if kids and all({s[1] for s in spans if s[0] == k} == {name} for k in kids):
            assert t.ns - t.self_ns == sum(tot[k].ns for k in kids), name
    if events is None:
        return
    parents = _trace_parents(events)
    by_trace = sorted((e["name"], parents[id(e)] or "") for e in events)
    assert by_trace == sorted((n, p or "") for n, p, _ in spans)


def _same(outs_a, outs_b):
    for a, b in zip(outs_a, outs_b, strict=True):
        assert a.error is None and b.error is None, (a.error, b.error)
        assert a.Z == b.Z and a.segments == b.segments


def _fill(spans, name):
    return [(c["reads"], c["samples"], c["padded_samples"])
            for n, _, c in spans if n == name]


@pytest.fixture(scope="module")
def banded_traced(model, items, tmp_path_factory):
    """Two chunks through the banded engine under torch.profiler: the
    engine, outputs, spans closed, the trace's spans, the profile's deltas
    and the totals."""
    eng = _engine(model)
    before = dict(eng.profile)
    outs, spans, events = _traced(lambda: _chunks(eng, items),
                                  tmp_path_factory.mktemp("banded"))
    delta = {k: eng.profile[k] - before[k] for k in ("reads", "buckets")}
    return eng, outs, spans, events, delta, tracing.totals()


def test_off_counts_nothing_and_enters_no_span(model, items, banded_traced,
                                               monkeypatch):
    eng = _engine(model)
    before = {n: (t.n, t.ns) for n, t in tracing.totals().items()}
    assert not tracing._enabled and not torch.autograd.profiler._is_profiler_enabled

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    spans = _spy(monkeypatch)
    outs = _chunks(eng, items)
    assert {n: (t.n, t.ns) for n, t in tracing.totals().items()} == before
    assert spans == [] and not tracing.on()
    assert tracing.span("banded.bucket") is tracing.NULL
    _same(outs, banded_traced[1])


def test_banded_spans_under_the_profiler(items, banded_traced):
    eng, _, spans, events, delta, tot = banded_traced
    _check_nesting(spans, events, BANDED_TREE)
    assert [s[0] for s in spans if s[1] is None] == [
        "banded.dispatch", "banded.dispatch", "banded.collect", "banded.collect"]
    # the packer's buckets, chunk by chunk
    want = []
    for part in (items[:3], items[3:]):
        for group in eng._buckets(part):
            T = [len(part[g].signal) + 1 for g in group]
            want.append((len(T), sum(T), len(T) * t_pad_ladder(max(T), T_PAD_TO)))
    assert _fill(spans, "banded.bucket") == want
    assert all(c["h2d_bytes"] > 0 and c["d2h_bytes"] > 0
               for n, _, c in spans if n == "banded.bucket")
    b = tot["banded.bucket"]
    assert delta["reads"] == b.counts["reads"] == len(items)
    assert delta["buckets"] == b.n == len(want)
    assert b.counts["samples"] == sum(w[1] for w in want)
    assert b.counts["padded_samples"] == sum(w[2] for w in want)
    assert all(not c for n, _, c in spans if n != "banded.bucket")


def test_totals_clear_when_tracing_turns_on_again(model, items, tmp_path):
    eng = _engine(model)
    _traced(lambda: eng.run(items[:1]), tmp_path)
    first = {n: (t.n, t.ns) for n, t in tracing.totals().items()}
    eng.run(items[:1])  # untraced: tracing observed off
    assert {n: (t.n, t.ns) for n, t in tracing.totals().items()} == first
    _traced(lambda: eng.run(items[1:3]), tmp_path)
    assert tracing.totals()["banded.bucket"].counts["reads"] == 2
    assert tracing.totals()["banded.dispatch"].n == 1


def test_fp64_rung_one_span_a_read(model, items, monkeypatch):
    eng = BandedBatchEngine(model, "rna002", device="cpu", dtype=torch.float32)
    monkeypatch.setattr(bb, "check_z_batch",
                        lambda Zf, Zb, T, B, dtype: np.arange(len(T)) % 2 == 1)
    _, spans, _ = _traced(lambda: eng.run(items[:3]), None)
    _check_nesting(spans, None, BANDED_TREE)
    rung = [s for s in spans if s[0] == "banded.fp64_rung"]
    assert len(rung) == eng.profile["z_retries"] == tracing.totals()[
        "banded.fp64_rung"].n == 2


def test_matrix_route_buckets_carry_the_counts(model, items):
    eng = _engine(model, device_pipeline=False)
    _, spans, _ = _traced(lambda: eng.run(items), None)
    _check_nesting(spans, None, BANDED_TREE)
    assert {s[0] for s in spans} == {"banded.dispatch", "banded.pack",
                                     "banded.collect", "banded.bucket"}
    want = []
    for group in eng._buckets(items):
        T = [len(items[g].signal) + 1 for g in group]
        want.append((len(T), sum(T), len(T) * round_up(max(T), T_PAD_TO)))
    assert _fill(spans, "banded.bucket") == want
    assert all(s[1] == "banded.collect" for s in spans if s[0] == "banded.bucket")
    assert all(c["h2d_bytes"] > 0 and c["d2h_bytes"] > 0
               for n, _, c in spans if n == "banded.bucket")


@pytest.mark.parametrize("case", ["profiler", "wide_rung", "exact_rung"])
def test_ntc_spans(model, tmp_path, case):
    """A bucket under torch.profiler (whose cost on the plain lattice's
    many small ops is most of the test), and each rung with
    tracing.enable()."""
    reads = [make_read(model, n_bases=n, seed=s) for s, n in ((2, 18), (0, 25))]
    kw = {"profiler": dict(batch_size=1), "wide_rung": dict(cap_n=2, cap_k=2),
          "exact_rung": dict(cap_n=2, cap_k=2, wide_retry=False)}[case]
    eng = ntc_batch.NTCBatchEngine(model, "rna002", device="cpu", dtype=torch.float64,
                                   t_pad_to=64, n_pad_to=16, **kw)
    its = [BatchItem(s, r) for s, r in (reads[:1] if case == "profiler" else reads[1:])]
    before = dict(eng.profile)
    outs, spans, events = _traced(lambda: eng.run(its),
                                  tmp_path if case == "profiler" else None)
    assert all(o.error is None for o in outs)
    _check_nesting(spans, events, NTC_TREE)
    main = [c for n, p, c in spans if n == "ntc.bucket" and p == "ntc.dispatch"]
    assert sum(c["reads"] for c in main) == eng.profile["reads"] - before["reads"]
    assert len(main) == eng.profile["buckets"] - before["buckets"]
    # the wide rung runs its read again, in a bucket of its own
    T = len(its[0].signal) + 1
    runs = 1 + (case == "wide_rung")
    assert _fill(spans, "ntc.bucket") == [(1, T, t_pad_ladder(T, 64))] * runs
    assert all(c["h2d_bytes"] > 0 and c["d2h_bytes"] > 0
               for n, _, c in spans if n == "ntc.bucket")
    tot = tracing.totals()
    for step in ("ntc.pad", "ntc.prepass", "ntc.plan", "ntc.lattice", "ntc.walk"):
        assert tot[step].n == runs
    assert tot.get("ntc.wide_rung", tracing.Total()).n == (case == "wide_rung")
    assert tot.get("ntc.exact_rung", tracing.Total()).n == eng.profile[
        "exact_retries"] == (case == "exact_rung")
    assert [s[0] for s in spans if s[1] is None] == ["ntc.dispatch", "ntc.collect"]


def test_profile_flag_prints_spans_and_fill(model, tmp_path, capsys):
    tsv = tmp_path / "reads.tsv"
    T = []
    with open(tsv, "w") as f:
        for s in range(3):
            sig, read = make_read(model, n_bases=40 + 10 * s, seed=140 + s)
            T.append(len(sig) + 1)
            f.write(f"r{s}\tr{s}\t{','.join(repr(float(x)) for x in sig)}"
                    f"\t{read[9:][::-1]}\n")
    eng = cli.main(["--tsv", str(tsv), "-o", str(tmp_path / "o.csv.zst"), "--mode",
                    "basic", "-p", "rna002", "--device", "cpu", "--batch_size", "2",
                    "--profile"])
    assert not tracing._enabled
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("profile: ")]
    spans = {ln.split()[1]: ln.split() for ln in lines[:-1]}
    assert set(spans) == {"banded.dispatch", "banded.pack", "banded.bucket",
                          "banded.kmers", "banded.wire", "banded.launch",
                          "banded.to_host", "banded.collect", "banded.gate"}
    for name, w in spans.items():
        assert w[3] == "spans" and w[5:7] == ["s", "self"] and w[8] == "s"
        assert 0 <= float(w[7]) <= float(w[4])
    b = spans["banded.bucket"]
    assert b[2] == str(eng.profile["buckets"]) == "2"
    counts = dict(zip(b[9::2], map(int, b[10::2]), strict=True))
    assert set(counts) == {"reads", "samples", "padded_samples", "h2d_bytes",
                           "d2h_bytes"}
    assert counts["reads"] == 3 and counts["samples"] == sum(T)
    share = 100.0 * (1.0 - sum(T) / counts["padded_samples"])
    assert lines[-1] == (f"profile: 3 reads in 2 buckets, 1.500 reads a bucket, "
                         f"padded samples {share:.3f} %, z_retries 0")


# -- the benchmark's readers ------------------------------------------------

def _reader(name):
    from benchmark.harness.main import load_file

    return load_file(os.path.join(ROOT, "benchmark", "metrics", f"{name}.py"),
                     "reader_" + name.replace(".", "_"))


def test_fill_readers_on_hand_made_totals():
    fill = _reader("engine.reads_per_bucket.basic")
    padded = _reader("engine.padded_sample_share.basic")
    tracing.enable()
    for counts in ([(3, 900, 1024), (1, 500, 512)], [(4, 1000, 1024)]):
        with tracing.entry("banded.dispatch"):
            for r, s, p in counts:
                with tracing.span("banded.bucket", reads=r, samples=s, padded_samples=p):
                    pass
            with tracing.span("ntc.bucket", reads=9, samples=1, padded_samples=10**6):
                pass
    assert fill.read({}) == 8 / 3
    assert padded.read({}) == pytest.approx(100 * (1 - 2400 / 2560), abs=1e-12)
    tracing.disable()
    with tracing.entry("banded.dispatch"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.entry("ntc.dispatch"):
            pass
    assert fill.read({}) is None and padded.read({}) is None


def _X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_host_self_reader_leaves_out_cuda_calls_and_waits():
    reader = _reader("engine.host_self_ms_per_read.basic")
    events = [_X("user_annotation", "bench.dispatch", 0, 120),
              _X("user_annotation", "banded.dispatch", 5, 100),
              _X("user_annotation", "banded.bucket", 10, 60),
              _X("user_annotation", "banded.collect", 200, 100),
              _X("user_annotation", "banded.wait", 210, 30),
              _X("cuda_runtime", "cudaEventSynchronize", 212, 26),
              _X("cuda_runtime", "cudaLaunchKernel", 20, 20),
              _X("cuda_driver", "cuLaunchKernel", 25, 10),
              _X("cuda_runtime", "cudaMemcpyAsync", 290, 40),
              _X("cuda_runtime", "cudaMemsetAsync", 150, 10),
              _X("gpu_user_annotation", "banded.collect", 200, 100),
              _X("cpu_op", "aten::copy_", 40, 30)]
    # 100 + 100 us of spans, less 20 of launches, 30 of the wait and the 10
    # of the copy inside the collect
    assert reader.read({"events": events, "reads": 2}) == (200 - 20 - 30 - 10) / 1e3 / 2
    assert reader.read({"events": events, "reads": 0}) is None
    assert reader.read({"events": events[:1], "reads": 2}) is None


def test_readers_that_were_there_read_the_same_with_program_spans():
    """engine.host_ms_per_read.basic and device.idle_share.basic select
    their events by name and category: the program's spans on the host and
    on the device's timeline change neither."""
    from benchmark.harness import trace as tr

    base = [_X("user_annotation", tr.SPAN, 1000, 400),
            _X("user_annotation", "bench.dispatch", 1010, 150),
            _X("user_annotation", "bench.collect", 1200, 150),
            _X("kernel", "void banded_bwd_kernel<double>(Args)", 1050, 100),
            _X("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1160, 10),
            _X("kernel", "void banded_fwd_vit_kernel<double>(Args)", 1250, 120),
            _X("cuda_runtime", "cudaLaunchKernel", 1040, 12),
            _X("cuda_runtime", "cudaEventSynchronize", 1210, 60),
            _X("cpu_op", "aten::copy_", 1100, 30)]
    program = [_X("user_annotation", "banded.dispatch", 1012, 140),
               _X("user_annotation", "banded.bucket", 1015, 120),
               _X("user_annotation", "banded.wire", 1016, 20),
               _X("user_annotation", "banded.collect", 1202, 140),
               _X("user_annotation", "banded.wait", 1205, 70),
               _X("gpu_user_annotation", "banded.bucket", 1050, 300)]
    host = _reader("engine.host_ms_per_read.basic")
    idle = _reader("device.idle_share.basic")
    got = []
    for events in (base, base + program):
        trace = {"traceEvents": events}
        s = tr.trace_summary(trace, 10)
        run = {"events": events, "reads": 3,
               "trace": {"window_s": s["wall_ms"] / 1e3, "busy_s": s["busy_ms"] / 1e3}}
        got.append((host.read(run), idle.read(run), tr.breakdown(trace, s)))
    assert got[0] == got[1]
    assert got[0][0] > 0 and 0 < got[0][1] < 100

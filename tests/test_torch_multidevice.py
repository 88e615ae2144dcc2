"""The port's engines over a device list, the device guard of the kernel
wrappers, and the device Hampel, on the CPU (counterpart of
tests/test_multidevice.py and of the device-Hampel parts of
tests/test_device_pipeline.py).

* BandedBatchEngine and NTCBatchEngine on ["cpu", "cpu"] send buckets
  round-robin and give outputs identical to one device; a bucket's fp64,
  wide and exact retries run on the bucket's own device (told apart here
  as "cpu" and "cpu:0", which torch keeps as two devices).
* Every ctypes entry of the five wrapper modules is called inside
  `with on_device(<device>)` for the device of the stream it is given.
* hampel3 is bit for bit JAX's hampel3_device in fp32 and fp64, the
  L - 2 edge included; the engine with hampel_on_device=True matches
  JAX's engine with the same flag.
"""

import ast
import contextlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamont_tpu.models.batch import BandedBatchEngine as JaxBandedEngine
from dynamont_tpu.models.batch import BatchItem as JaxItem
from dynamont_tpu.models.registry import load_model_for_pore
from dynamont_tpu.ops import nt_banded_device as jdv
from dynamont_tpu_torch.models import batch as batch_mod
from dynamont_tpu_torch.models import ntc_batch as ntc_mod
from dynamont_tpu_torch.models.batch import BandedBatchEngine, BatchItem
from dynamont_tpu_torch.ops import nt_banded_device as dv
from dynamont_tpu_torch.parallel.mesh import on_device

from tests.synthetic import make_read

ROOT = Path(__file__).resolve().parents[1]
PAD = dict(t_pad_to=64, n_pad_to=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def _items(model, n_reads, base_len=40):
    return [BatchItem(*make_read(model, n_bases=base_len + 3 * (s % 5), seed=500 + s))
            for s in range(n_reads)]


def _out_key(out):
    return (out.error, None if out.segments is None else tuple(
        tuple(seg) for seg in out.segments), out.Z)


@pytest.mark.parametrize("route", ["device", "matrix"])
def test_banded_round_robin_matches_single_device(model, route):
    items = _items(model, 6)
    kw = dict(batch_size=2, device_pipeline=route == "device")
    eng = BandedBatchEngine(model, "rna002", devices=["cpu", "cpu"], **kw)
    outs = eng.run(items)
    assert eng.profile["device_buckets"] == [2, 1]
    single = BandedBatchEngine(model, "rna002", device="cpu", **kw)
    souts = single.run(items)
    assert single.profile["device_buckets"] == [3]
    for got, want in zip(outs, souts):
        assert got.error is None
        assert _out_key(got) == _out_key(want)


def test_banded_z_retry_on_its_bucket_device(model, monkeypatch):
    """A read failing the fp32 gate re-runs on the fp64 rung on its own
    bucket's device."""
    seen = []
    rung = batch_mod.run_nt_banded

    def recording(*a, device, **kw):
        seen.append(torch.device(device))
        return rung(*a, device=device, **kw)

    monkeypatch.setattr(batch_mod, "run_nt_banded", recording)
    monkeypatch.setattr(batch_mod.bb, "check_z_batch",
                        lambda Zf, *a: np.zeros(len(Zf), bool))
    devs = [torch.device("cpu"), torch.device("cpu", 0)]
    eng = BandedBatchEngine(model, "rna002", devices=devs, batch_size=1)
    outs = eng.run(_items(model, 3, base_len=30))
    assert all(o.error is None for o in outs)
    assert seen == [devs[0], devs[1], devs[0]]


def test_engine_device_arguments(model):
    with pytest.raises(TypeError):
        BandedBatchEngine(model, "rna002")
    with pytest.raises(TypeError):
        BandedBatchEngine(model, "rna002", device="cpu", devices=["cpu"])
    with pytest.raises(ValueError):
        ntc_mod.NTCBatchEngine(model, "rna002", devices=[])
    eng = ntc_mod.NTCBatchEngine(model, "rna002", devices=["cpu", "cpu:0"], **PAD)
    assert eng.device == torch.device("cpu") and len(eng._tensors) == 2
    assert eng.tensors is eng._tensors[torch.device("cpu")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ntc_round_robin_matches_single_device(model, dtype):
    """Segmentation in fp32, training in fp64: one bucket a device."""
    items = _items(model, 2, base_len=16)
    kw = dict(dtype=dtype, batch_size=1, fallback=False, **PAD)
    eng = ntc_mod.NTCBatchEngine(model, "rna002", devices=["cpu", "cpu"], **kw)
    single = ntc_mod.NTCBatchEngine(model, "rna002", device="cpu", **kw)
    if dtype == torch.float32:
        outs, souts = eng.run(items), single.run(items)
        for got, want in zip(outs, souts):
            assert got.error is None
            assert _out_key(got) == _out_key(want)
    else:
        got, want = eng.train(items), single.train(items)
        assert all(isinstance(g, tuple) for g in got)
        assert got == want
    assert eng.profile["device_buckets"] == [1, 1]


def test_ntc_retries_on_their_bucket_device(model, monkeypatch):
    """Reads that overflow tiny caps go to the wide rung, and from there
    (a stand-in that repairs none) to the exact rung, each on the device
    its main bucket ran on."""
    devs = [torch.device("cpu"), torch.device("cpu", 0)]
    items = _items(model, 2, base_len=16)
    calls = []
    eng = ntc_mod.NTCBatchEngine(model, "rna002", devices=devs, batch_size=1,
                                 cap_n=2, cap_k=2, **PAD)
    monkeypatch.setattr(eng, "_run_wide", lambda idxs, items, outputs, dev:
                        calls.append(("wide", idxs, dev)) or idxs)
    exact = eng._run_exact
    monkeypatch.setattr(eng, "_run_exact", lambda it, dev:
                        calls.append(("exact", it.read, dev)) or exact(it, dev))
    outs = eng.run(items)
    assert all(o.error is None for o in outs)
    assert calls == [("wide", [0], devs[0]), ("wide", [1], devs[1]),
                     ("exact", items[0].read, devs[0]),
                     ("exact", items[1].read, devs[1])]


def _entry_calls(tree):
    """(stream device, guard device or None) of every `_entry(...)(...)`
    call that passes `_stream(x)`."""
    found = []

    def visit(node, guard):
        if isinstance(node, ast.With):
            for item in node.items:
                e = item.context_expr
                if isinstance(e, ast.Call) and getattr(e.func, "id", "") == "on_device":
                    guard = ast.dump(e.args[0])
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Call)
                and getattr(node.func.func, "id", "") == "_entry"):
            streams = [a for a in node.args if isinstance(a, ast.Call)
                       and getattr(a.func, "id", "") == "_stream"]
            if streams:
                found.append((ast.dump(streams[0].args[0]), guard))
        for child in ast.iter_child_nodes(node):
            visit(child, guard)

    visit(tree, None)
    return found


def test_every_kernel_entry_runs_under_its_device():
    """The CUDA runtime inside the library launches on the current device:
    each entry must run with its tensors' device current."""
    total = 0
    for mod in ("nt_banded_kernels", "ntc_kernels", "ntc_pre_kernels",
                "ntc_train_kernels", "ntc_probe_kernels"):
        path = ROOT / "dynamont_tpu_torch" / "ops" / f"{mod}.py"
        calls = _entry_calls(ast.parse(path.read_text()))
        assert calls, mod
        for stream_dev, guard_dev in calls:
            assert guard_dev == stream_dev, (mod, stream_dev, guard_dev)
        total += len(calls)
    assert total == 24
    assert isinstance(on_device(torch.device("cpu")), contextlib.nullcontext)
    guard = on_device(torch.device("cuda", 1))
    assert isinstance(guard, torch.cuda.device) and guard.idx == 1


@pytest.mark.parametrize("dtype", [(torch.float32, jnp.float32),
                                   (torch.float64, jnp.float64)])
def test_hampel3_bitwise_jax(dtype):
    tdt, jdt = dtype
    rng = np.random.default_rng(11)
    n = 48
    cases = []
    for L in (n, n - 1, 33, 6, 5, 4, 3):
        x = rng.normal(0, 1, n)
        x[rng.integers(0, n, 5)] = 25.0   # outliers
        x[L - 3] = -30.0                 # the last position filtered, i = L - 3
        if L >= 3:
            x[L - 2] = 30.0              # i = L - 2: outside the range, kept
        x[10:13] = 0.5                   # ties
        cases.append((x, L))
    got = dv.hampel3(torch.tensor(np.stack([c for c, _ in cases]), dtype=tdt),
                     torch.tensor([L for _, L in cases]))
    changed = 0
    for row, (x, L) in zip(got.numpy(), cases):
        want = np.asarray(jdv.hampel3_device(jnp.asarray(x, jdt), jnp.asarray(L)))
        assert row.dtype == want.dtype
        np.testing.assert_array_equal(row.view(np.uint8), want.view(np.uint8))
        if L - 2 < n:
            assert row[L - 2] == np.asarray(x, want.dtype)[L - 2]
        changed += int((row != np.asarray(x, want.dtype)).sum())
    assert changed > 10


def _spiky_items(model, n_reads=3):
    items = []
    for s in range(n_reads):
        sig, read = make_read(model, n_bases=40 + 7 * s, seed=700 + s)
        sig = sig.copy()
        sig[5 + 11 * s] += 12.0
        sig[len(sig) // 2] -= 12.0
        items.append((sig, read))
    return items


def test_engine_hampel_on_device_matches_jax(model):
    items = _spiky_items(model)
    outs = {}
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        got = BandedBatchEngine(model, "rna002", device="cpu", dtype=dt,
                                hampel_on_device=True).run(
            [BatchItem(s, r) for s, r in items])
        want = JaxBandedEngine(model, "rna002", dtype=jdt, hampel_on_device=True).run(
            [JaxItem(s, r) for s, r in items])
        for g, w in zip(got, want):
            assert g.error is None and w.error is None
            assert [s[:3] for s in g.segments] == [s[:3] for s in w.segments]
            for a, b in zip(g.segments, w.segments):
                assert a[3] == pytest.approx(b[3], abs=1e-12 if dt == torch.float64 else 2e-3)
            if dt == torch.float64:
                assert g.Z == pytest.approx(w.Z, rel=1e-12)
        outs[dt] = got
    plain = BandedBatchEngine(model, "rna002", device="cpu", dtype=torch.float64).run(
        [BatchItem(s, r) for s, r in items])
    assert any(_out_key(a) != _out_key(b) for a, b in zip(plain, outs[torch.float64]))

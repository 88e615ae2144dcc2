"""The banded engine's device-route packing (models/batch.pack_card_buckets):
a bucket costs the card its longest read's padded rows, under a byte budget
on its band matrices.

* Every read lands in exactly one bucket, no bucket holds more than
  batch_size reads, and every bucket of more than one read keeps its band
  matrices within the budget at its own B and itemsize, the budget raised
  to the largest bucket of pack_buckets(group=1) where that is larger.
* It never costs more rows, nor a larger bucket's bytes above the budget,
  than pack_buckets' split.
* The DP's cost is the least over every split of the sorted reads into
  contiguous buckets (brute force, small random length lists).
* On the 1,024 quantile lengths of benchmark/traffic/ragged.json, chunk by
  chunk: at least 10 reads a bucket, at most 0.6 of the longest-read rows
  of pack_buckets(group=1), and the largest bucket within 3.5 GiB.
* A bucket's make-up does not change a read's output: the engine's plain
  path with the new buckets and with batch_size=1 gives the same Z,
  summaries and gate, as the device route gates each read at its own band
  width. The matrix route and the NTC engine keep pack_buckets.
"""

import itertools
import json
import math
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamont_tpu_torch.models.batch import (BAND_BYTES_BUDGET, MAX_BATCH_SAMPLES,
                                             T_PAD_TO, BandedBatchEngine, BatchItem,
                                             pack_card_buckets)
from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine
from dynamont_tpu_torch.models.packing import pack_buckets, t_pad_ladder
from dynamont_tpu_torch.models.registry import load_model_for_pore
from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops.nt_banded_device import band_width
from dynamont_tpu_torch.ops.nt_banded_kernels import band_bytes
from dynamont_tpu_torch.utils.synthetic import make_read

ROOT = Path(__file__).resolve().parents[1]
OVERHEAD = 512


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def _bucket_cost(lengths, bucket):
    return t_pad_ladder(max(lengths[i] for i in bucket) + 1, T_PAD_TO) + OVERHEAD


def _bucket_bytes(lengths, N, bucket, band, itemsize):
    t_pad = t_pad_ladder(max(lengths[i] for i in bucket) + 1, T_PAD_TO)
    B = max(band_width(band, N[i]) for i in bucket)
    return band_bytes(len(bucket), t_pad, B, itemsize)


def _old_buckets(lengths, batch_size):
    return pack_buckets(lengths, batch_size=batch_size, max_batch_samples=MAX_BATCH_SAMPLES,
                        t_pad_to=T_PAD_TO, group=1)


def _budget(lengths, N, batch_size, band, itemsize, budget):
    """The budget the DP keeps: `budget`, or pack_buckets' largest bucket."""
    return max([budget] + [_bucket_bytes(lengths, N, b, band, itemsize)
                           for b in _old_buckets(lengths, batch_size)])


def _random_case(seed, n):
    rng = np.random.default_rng(seed)
    lengths = [int(x) for x in rng.integers(300, 20_000, n)]
    N = [max(2, int(x / rng.uniform(5, 60))) for x in lengths]
    return lengths, N


def _check_valid(buckets, lengths, N, batch_size, band, itemsize, budget):
    assert sorted(i for b in buckets for i in b) == list(range(len(lengths)))
    for b in buckets:
        assert 1 <= len(b) <= batch_size
        assert [lengths[i] for i in b] == sorted(lengths[i] for i in b)
        if len(b) > 1:
            assert _bucket_bytes(lengths, N, b, band, itemsize) <= budget


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("itemsize", [4, 8])
def test_every_read_once_within_size_and_budget(seed, itemsize):
    lengths, N = _random_case(seed, 200)
    # a budget that binds: a few reads of 20k at B 512
    budget = 6 * 20_480 * 512 * (4 * itemsize + 1)
    kw = dict(batch_size=24, band=400, itemsize=itemsize, budget=budget)
    buckets = pack_card_buckets(lengths, N, **kw)
    _check_valid(buckets, lengths, N, 24, 400, itemsize,
                 _budget(lengths, N, 24, 400, itemsize, budget))
    assert any(len(b) > 1 for b in buckets)
    # a read alone always fits, whatever the budget: reads too long for
    # pack_buckets to pair, at a budget of one byte
    long = [3_000_000 + 1_000 * i for i in (2, 0, 1)]
    assert pack_card_buckets(long, [70_000] * 3, **{**kw, "budget": 1}) == [[1], [2], [0]]
    assert pack_card_buckets([], [], **kw) == []


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("budget", [1, 2**30, BAND_BYTES_BUDGET])
def test_never_dearer_than_pack_buckets(seed, budget):
    """pack_buckets' split is one the DP weighs: no more rows, and no
    bucket's bytes above both the budget and pack_buckets' largest."""
    lengths, N = _random_case(50 + seed, 300)
    lengths = [x * 4 for x in lengths]
    new = pack_card_buckets(lengths, N, batch_size=32, band=400, itemsize=8, budget=budget)
    old = _old_buckets(lengths, 32)
    assert sum(_bucket_cost(lengths, b) for b in new) <= sum(
        _bucket_cost(lengths, b) for b in old)
    largest = max(_bucket_bytes(lengths, N, b, 400, 8) for b in new)
    assert largest <= max(budget, *(_bucket_bytes(lengths, N, b, 400, 8) for b in old))


def _brute_force(lengths, N, batch_size, band, itemsize, budget):
    """The least cost over every split of the sorted reads into contiguous
    buckets that keep the size and budget limits."""
    budget = _budget(lengths, N, batch_size, band, itemsize, budget)
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    best = math.inf
    for cuts in itertools.product((0, 1), repeat=len(order) - 1):
        buckets, cur = [], [order[0]]
        for c, i in zip(cuts, order[1:]):
            if c:
                buckets.append(cur)
                cur = []
            cur.append(i)
        buckets.append(cur)
        if any(len(b) > batch_size or (len(b) > 1 and _bucket_bytes(
                lengths, N, b, band, itemsize) > budget) for b in buckets):
            continue
        best = min(best, sum(_bucket_cost(lengths, b) for b in buckets))
    return best


@pytest.mark.parametrize("seed", range(8))
def test_dp_cost_is_the_brute_force_minimum(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(2, 11))
    lengths, N = _random_case(seed, n)
    kw = dict(batch_size=int(rng.integers(2, 6)), band=int(rng.choice([100, 400])),
              itemsize=int(rng.choice([4, 8])),
              budget=int(rng.integers(1, 8)) * 10_000 * 256 * 17)
    buckets = pack_card_buckets(lengths, N, **kw)
    _check_valid(buckets, lengths, N, kw["batch_size"], kw["band"], kw["itemsize"],
                 _budget(lengths, N, **kw))
    got = sum(_bucket_cost(lengths, b) for b in buckets)
    assert got == _brute_force(lengths, N, **kw)


def _ragged_chunks():
    """The 1,024 quantile lengths of the benchmark's ragged traffic, in
    eight stratified chunks of 128 (chunk c takes the c-th of every eight
    sorted lengths), with 43 samples a base."""
    with open(ROOT / "benchmark" / "traffic" / "ragged.json") as f:
        spec = json.load(f)["signal_length"]
    n = 1024
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    L = np.rint(np.clip(spec["median"] * np.exp(spec["sigma"] * z),
                        spec["min"], spec["max"])).astype(np.int64)
    return [[int(x) for x in L[c::8]] for c in range(8)]


def test_ragged_traffic_fills_buckets_within_the_budget():
    reads = buckets = rows = old_rows = 0
    for lengths in _ragged_chunks():
        N = [round(T / 43) + 1 for T in lengths]
        new = pack_card_buckets(lengths, N, batch_size=32, band=400, itemsize=8)
        budget = _budget(lengths, N, 32, 400, 8, BAND_BYTES_BUDGET)
        _check_valid(new, lengths, N, 32, 400, 8, budget)
        old = _old_buckets(lengths, 32)
        reads += len(lengths)
        buckets += len(new)
        rows += sum(_bucket_cost(lengths, b) - OVERHEAD for b in new)
        old_rows += sum(_bucket_cost(lengths, b) - OVERHEAD for b in old)
        # pack_buckets' buckets stay under the budget in these chunks
        assert max(_bucket_bytes(lengths, N, b, 400, 8) for b in new) <= 3.5 * 2**30
    assert reads / buckets >= 10
    assert rows <= 0.6 * old_rows


# -- the engines ---------------------------------------------------------------

def _mixed_items(model):
    """Reads of 80-1,000 samples whose N gives B 128 to 384."""
    sizes = [20, 150, 40, 270, 90, 60, 300, 30]
    return [BatchItem(*make_read(model, n_bases=n, mean_dwell=3.0, seed=700 + s))
            for s, n in enumerate(sizes)]


def _key(out):
    N = out.summaries[2]
    return out.Z, N, out.summaries[0][:N].tolist(), out.summaries[1][:N].tolist()


def _out_key(out):
    if out.summaries is None:
        return out.Z, out.error, out.segments
    return _key(out)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bucket_make_up_leaves_each_read_alone(model, dtype, monkeypatch):
    items = _mixed_items(model)
    eng = BandedBatchEngine(model, "rna002", device="cpu", dtype=dtype, batch_size=4)
    groups = eng._buckets(items)
    widths = {band_width(400, len(items[i].read) - 3) for g in groups for i in g}
    assert len(groups) == 2 and all(len(g) == 4 for g in groups) and len(widths) > 1
    gate = bb.check_z_batch
    seen = []

    def recording(Zf, Zb, T, B, dtype):
        seen.append(np.asarray(B).tolist())
        return gate(Zf, Zb, T, B, dtype)

    monkeypatch.setattr(bb, "check_z_batch", recording)
    packed = eng.run(items)
    # the gate sees each read's own band width, not the bucket's
    assert seen == [[band_width(400, len(items[i].read) - 3) for i in g] for g in groups]
    single = BandedBatchEngine(model, "rna002", device="cpu", dtype=dtype,
                               batch_size=1).run(items)
    if dtype == torch.float64:
        assert all(a.summaries is not None for a in packed)
    assert [_out_key(a) for a in packed] == [_out_key(b) for b in single]


def test_matrix_route_and_ntc_keep_pack_buckets(model):
    items = _mixed_items(model)
    lengths = [len(it.signal) for it in items]
    eng = BandedBatchEngine(model, "rna002", device="cpu", batch_size=3,
                            device_pipeline=False)
    assert eng._buckets(items) == pack_buckets(
        lengths, batch_size=3, max_batch_samples=MAX_BATCH_SAMPLES, t_pad_to=T_PAD_TO,
        group=1)
    ntc = NTCBatchEngine(model, "rna002", device="cpu", batch_size=3)
    assert list(ntc._buckets(range(len(items)), items, 3)) == pack_buckets(
        lengths, batch_size=3, max_batch_samples=ntc.max_batch_samples,
        t_pad_to=ntc.t_pad_to, group=1)

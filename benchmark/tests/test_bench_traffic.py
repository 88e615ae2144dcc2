"""The ragged traffic's lengths and the vectorised read generator."""

import json
import os

import numpy as np
import pytest

from conftest import ROOT

from benchmark.harness import traffic as tf
from benchmark.reference.table import load_table

TABLE = os.path.join(ROOT, "dynamont_tpu_torch", "models_data", "rna002_5mer.npz")


@pytest.fixture(scope="module")
def table():
    return load_table(TABLE, rna=True)


def _ragged():
    with open(os.path.join(ROOT, "benchmark", "traffic", "ragged.json")) as f:
        return json.load(f)


def test_ragged_lengths_are_the_quantiles():
    spec = _ragged()["signal_length"]
    L = tf.signal_lengths(spec, 1024)
    assert L.min() == 8000 and L.max() == 64000
    assert abs(np.median(L) - 16000) <= 10
    assert np.all(np.diff(L) >= 0)
    assert 18000 < L.mean() < 18500


def test_every_chunk_holds_the_same_work():
    """Stratified order: chunk c takes one length of every run of 8 sorted
    lengths, so the chunks' sums of samples differ by little, and each is a
    permutation of the pool's indices exactly once."""
    traffic = _ragged()
    n, chunk = traffic["pool_reads"], 128
    order = tf.pool_order(n, chunk, traffic["order_seed"])
    assert sorted(order) == list(range(n))
    L = tf.signal_lengths(traffic["signal_length"], n)[order].reshape(-1, chunk)
    runs = order.reshape(-1, chunk) // (n // chunk)
    assert all(sorted(r) == list(range(chunk)) for r in runs)
    sums = L.sum(1)
    assert sums.max() / sums.min() < 1.03
    with pytest.raises(ValueError):
        tf.pool_order(n + 1, chunk, 1)


def test_lengths_equal_across_seeds_and_content_differs(table):
    traffic = _ragged()
    traffic["pool_reads"] = 16
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cfg = json.load(f)["configs"][0]["file"]
    with open(os.path.join(ROOT, cfg)) as f:
        config = json.load(f)
    config["engine"]["chunk_reads"] = 4
    a = tf.make_pool(traffic, config, table, 7)
    b = tf.make_pool(traffic, config, table, 2**31 + 11)
    again = tf.make_pool(traffic, config, table, 7)
    # the same lengths in the same order: every chunk holds the same work
    assert [len(s) for s, _ in a] == [len(s) for s, _ in b]
    assert [len(r) for _, r in a] == [len(r) for _, r in b]
    assert sorted(len(s) for s, _ in a) == list(tf.signal_lengths(traffic["signal_length"], 16))
    assert [r for _, r in a] != [r for _, r in b]
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1] for x, y in zip(a, again))


def test_fitted_dwells_keep_the_floor(table):
    rng = np.random.default_rng(3)
    reads = tf.make_reads(table, rng, mean_dwell=43.0, min_dwell=2,
                          polya_prefix="AAAAAAAAA", lengths=[8000, 8001, 12345])
    for (sig, read), L in zip(reads, (8000, 8001, 12345)):
        assert len(sig) == L
        assert read.startswith("AAAAAAAAA")
        assert len(table.kmer_ids(read)) == round(L / 43.0)


def test_generator_matches_make_read(table):
    """At make_read's own parameters (60 bases, mean dwell 9) both draw the
    same law: a 9-A stub in front of uniform bases, dwells Poisson(9)
    floored at 2, samples from each k-mer's Gaussian; so the reads' lengths
    and the pooled samples agree in distribution."""
    from dynamont_tpu_torch.models.registry import load_model_for_pore
    from dynamont_tpu_torch.utils.synthetic import make_read

    model = load_model_for_pore("rna002")
    assert np.array_equal(model.means, table.means)
    assert np.array_equal(model.stdevs, table.stdevs)
    n = 400
    ref = [make_read(model, n_bases=60, mean_dwell=9.0, seed=s) for s in range(n)]
    nk = [len(table.kmer_ids(r)) for _, r in ref]
    ours = tf.make_reads(table, np.random.default_rng(11), mean_dwell=9.0,
                         min_dwell=2, polya_prefix="AAAAAAAAA", n_kmers=nk)
    assert [len(r) for _, r in ours] == [len(r) for _, r in ref]
    assert all(r.startswith("AAAAAAAAA") for _, r in ours)
    comp = lambda reads: np.array([sum(r[9:].count(b) for _, r in reads)
                                   for b in "ACGT"]) / (n * 60)
    assert np.abs(comp(ours) - comp(ref)).max() < 0.01
    lens = lambda reads: np.array([len(s) for s, _ in reads], float)
    a, b = lens(ref), lens(ours)
    # Poisson(9) floored at 2: mean ~9.0 a k-mer, variance ~8.9
    assert abs(a.mean() - b.mean()) < 3 * np.sqrt(2 * 65 * 9 / n)
    assert abs(a.std() / b.std() - 1) < 0.15
    pooled = lambda reads: np.concatenate([s for s, _ in reads])
    qa = np.quantile(pooled(ref), np.linspace(0.05, 0.95, 10))
    qb = np.quantile(pooled(ours), np.linspace(0.05, 0.95, 10))
    spread = qa[-1] - qa[0]
    assert np.abs(qa - qb).max() < 0.03 * spread

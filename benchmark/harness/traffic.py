"""The benchmark's one read generator: a traffic file's lengths and a
configuration's chemistry in, a pool of (signal, read) pairs out.

The read generator is a vectorised copy of the port's
`dynamont_tpu_torch/utils/synthetic.make_read` (bases drawn uniformly, a
polyA stub in front for RNA, one dwell a k-mer drawn from a Poisson law
floored at `min_dwell`, each sample drawn from its k-mer's Gaussian in the
pore table), with no loop over bases. With `lengths` given, single samples
are moved between k-mers so that every read has exactly its length, and the
number of k-mers is fixed by the length alone. The pool's order of lengths
is fixed by the traffic file (`order_seed`) and stratified: chunk c of the
window takes the c-th length of every run of `pool_reads / chunks` sorted
lengths, so every chunk holds about the same work and the number of chunks a
window reaches does not change the rate. The seed decides the bases, the
dwells and the noise, but never the work or its order.
"""

from __future__ import annotations

import statistics

import numpy as np

from benchmark.reference.table import PoreTable

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def signal_lengths(spec: dict, n: int) -> np.ndarray:
    """(n,) int64 signal lengths, sorted ascending, from a traffic file's
    `signal_length` entry (`lognormal_quantiles`): the n quantiles
    (i + 0.5) / n of a log-normal law with the given median and sigma,
    clipped to [min, max] and rounded."""
    law = spec["law"]
    if law != "lognormal_quantiles":
        raise ValueError(f"unknown signal_length law {law!r}")
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n)
                  for i in range(n)])
    L = spec["median"] * np.exp(spec["sigma"] * z)
    return np.rint(np.clip(L, spec["min"], spec["max"])).astype(np.int64)


def _fit_dwells(d: np.ndarray, length: int, min_dwell: int, rng) -> np.ndarray:
    """Move single samples between k-mers until the dwells sum to `length`,
    no dwell falling under `min_dwell`."""
    diff = length - int(d.sum())
    while diff > 0:
        np.add.at(d, rng.integers(0, len(d), diff), 1)
        diff = length - int(d.sum())
    while diff < 0:
        room = np.flatnonzero(d > min_dwell)
        take = rng.choice(room, size=min(-diff, len(room)), replace=False)
        d[take] -= 1
        diff = length - int(d.sum())
    return d


def make_reads(table: PoreTable, rng, *, mean_dwell: float, min_dwell: int,
               polya_prefix: str, lengths=None, n_kmers=None) -> list:
    """[(signal float64, read str in processing orientation)], one pair per
    entry of `lengths` (signal samples; the k-mer count is
    round(length / mean_dwell)) or of `n_kmers` (free Poisson lengths, as
    make_read draws them)."""
    k = table.kmer_size
    prefix = polya_prefix if table.rna else ""
    if lengths is not None:
        lengths = np.asarray(lengths, np.int64)
        nk = np.maximum(1, np.rint(lengths / mean_dwell)).astype(np.int64)
    else:
        nk = np.asarray(n_kmers, np.int64)
    R = len(nk)
    n_rand = nk + k - 1 - len(prefix)
    if (n_rand < 0).any():
        raise ValueError("a read shorter than its polyA stub")
    # every read's random bases in one draw
    codes = BASES[rng.integers(0, 4, int(n_rand.sum()))]
    pre = np.frombuffer(prefix.encode(), np.uint8)
    out_reads, kmer_lists, dwells = [], [], []
    at = 0
    for i in range(R):
        seq = np.concatenate([pre, codes[at:at + n_rand[i]]])
        at += n_rand[i]
        read = seq.tobytes().decode()
        ids = table.kmer_ids(read)
        d = np.maximum(min_dwell, rng.poisson(mean_dwell, len(ids)))
        if lengths is not None:
            d = _fit_dwells(d, int(lengths[i]), min_dwell, rng)
        out_reads.append(read)
        kmer_lists.append(ids)
        dwells.append(d)
    # every sample of every read in one draw
    kid = np.concatenate([np.repeat(ids, d) for ids, d in zip(kmer_lists, dwells)])
    z = rng.standard_normal(len(kid))
    sig = table.means[kid] + table.stdevs[kid] * z
    cuts = np.cumsum([int(d.sum()) for d in dwells])[:-1]
    return list(zip(np.split(sig, cuts), out_reads))


def pool_order(n: int, chunk_reads: int, order_seed: int) -> np.ndarray:
    """Indices into n sorted lengths, stratified over the n / chunk_reads
    chunks of a pass: each run of that many consecutive sorted lengths gives
    one length to every chunk, in an order drawn from `order_seed`; the
    reads inside a chunk are shuffled likewise."""
    n_chunks = n // chunk_reads
    if n_chunks * chunk_reads != n:
        raise ValueError(f"pool_reads {n} is not a whole number of chunks of "
                         f"{chunk_reads}")
    rng = np.random.default_rng(order_seed)
    # strata[j, c]: the sorted index that run j gives to chunk c
    strata = np.arange(n).reshape(chunk_reads, n_chunks)
    strata = rng.permuted(strata, axis=1)
    chunks = strata.T
    return rng.permuted(chunks, axis=1).reshape(-1)


def make_pool(traffic: dict, config: dict, table: PoreTable, seed: int):
    """The cell's pool: [(signal, read)]. The lengths and their order come
    from the traffic and the configuration's chunk alone; everything else
    from the seed."""
    rng = np.random.default_rng([abs(int(seed)), 0x5EED])
    n = traffic["pool_reads"]
    L = signal_lengths(traffic["signal_length"], n)
    L = L[pool_order(n, config["engine"]["chunk_reads"], traffic["order_seed"])]
    cap = config.get("max_signal_length")
    if cap is not None and L.max() > cap:
        raise ValueError(f"traffic lengths exceed the config's cap {cap}")
    chem = config["chemistry"]
    reads = make_reads(table, rng, mean_dwell=chem["mean_dwell"],
                       min_dwell=chem["min_dwell"],
                       polya_prefix=chem["polya_prefix"], lengths=L)
    return reads

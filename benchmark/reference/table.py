"""A pore table read straight from its `.npz` file, in the orientation the
DP uses: the benchmark's own reading, shared by the read generator and the
plain references, and independent of the program's loader.

The file holds `means`, `stdevs`, `alphabet_size` and `kmer_size` in
5'->3' k-mer order (the first base the most significant digit). RNA is
processed 3'->5', so for an RNA pore every k-mer id is mapped to the id of
its reversed string.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LOG_2PI = 1.8378770664093453
BASE_ID = np.full(256, -1, np.int64)
for _i, _b in enumerate(b"ACGT"):
    BASE_ID[_b] = _i
BASE_ID[ord("U")] = 3


@dataclass(frozen=True)
class PoreTable:
    means: np.ndarray    # (K,) float64
    stdevs: np.ndarray   # (K,) float64
    alphabet_size: int
    kmer_size: int
    rna: bool

    def kmer_ids(self, read: str) -> np.ndarray:
        """The read's rolling k-mer ids (len(read) - k + 1 of them)."""
        ids = BASE_ID[np.frombuffer(read.encode(), np.uint8)]
        if (ids < 0).any():
            raise ValueError("a base outside ACGTU")
        k, A = self.kmer_size, self.alphabet_size
        w = A ** np.arange(k - 1, -1, -1, dtype=np.int64)
        return np.lib.stride_tricks.sliding_window_view(ids, k) @ w

    def score_params(self):
        """(mean, c1, c2) a k-mer: log N(x) = c1 - c2 (x - mean)^2."""
        c1 = -0.5 * LOG_2PI - np.log(self.stdevs)
        c2 = 0.5 / (self.stdevs * self.stdevs)
        return self.means, c1, c2


def load_table(path: str, rna: bool) -> PoreTable:
    with np.load(path) as z:
        means = z["means"].astype(np.float64)
        stdevs = z["stdevs"].astype(np.float64)
        A, k = int(z["alphabet_size"]), int(z["kmer_size"])
    if rna:
        ids = np.arange(A ** k)
        rev = np.zeros_like(ids)
        q = ids.copy()
        for _ in range(k):
            rev = rev * A + q % A
            q //= A
        means, stdevs = means[rev], stdevs[rev]
    return PoreTable(means, stdevs, A, k, rna)

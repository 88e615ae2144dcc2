"""Band geometry for the banded NT DP (ref: NT_banded.cpp:269-287).

Band-relative layout: column j of band row t corresponds to sequence index
n = bstart[t] + j - 1, with j=0 and j=B-1 permanent -inf guard cells and
B = 2*bandwidth + 3. The band midpoint tracks the main diagonal:
midpoint(t) = floor(t * N / T) computed through a float64 product exactly
like the reference's `t * NTRATIO` truncation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BandGeometry:
    T: int
    N: int
    bandwidth: int
    B: int
    bstart: np.ndarray  # (T,) int64, signed band start (midpoint - bandwidth)
    shift: np.ndarray  # (T,) bool, shift[t] = bstart[t] != bstart[t-1]; shift[0]=False
    n_start: np.ndarray  # (T,) clamped lower n bound
    n_end: np.ndarray  # (T,) exclusive upper n bound

    @property
    def z_index(self) -> int:
        """Band column of the terminal cell (n = N-1 at t = T-1) and of the
        initial cell (n = 0 at t = 0): bandwidth + 1."""
        return self.bandwidth + 1


def effective_bandwidth(band: int, N: int) -> int:
    """BANDWIDTH = min(band/2, N/2) (ref: NT_banded_main.cpp:128)."""
    return min(band // 2, N // 2)


def band_geometry(T: int, N: int, bandwidth: int) -> BandGeometry:
    nt_ratio = np.float64(N) / np.float64(T)
    t = np.arange(T, dtype=np.float64)
    midpoint = (t * nt_ratio).astype(np.int64)  # truncation like (size_t)(t*NTRATIO)
    bstart = midpoint - bandwidth
    shift = np.zeros(T, dtype=bool)
    shift[1:] = bstart[1:] != bstart[:-1]
    n_start = np.maximum(midpoint - bandwidth, 0)
    n_end = np.minimum(midpoint + bandwidth + 1, N)
    return BandGeometry(
        T=T,
        N=N,
        bandwidth=bandwidth,
        B=2 * bandwidth + 3,
        bstart=bstart,
        shift=shift,
        n_start=n_start,
        n_end=n_end,
    )

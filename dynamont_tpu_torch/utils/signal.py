"""Raw-signal preprocessing: normalization and Hampel outlier filtering.

The Hampel filter reproduces the reference's exact sliding semantics
(ref: FileIO.py:17-43) but vectorized: decisions are made against the
*original* signal with a rolling window of the original values, replacing
outliers by the window median in place. Note the reference loop runs
i in [W//2, len-W//2-1), i.e. it excludes the final centered position —
we keep that quirk for output parity.
"""

from __future__ import annotations

import numpy as np

MAD_K = 1.4826  # MAD -> stdev conversion


def hampel_filter(signal: np.ndarray, window: int = 3, n_sigmas: float = 3.0) -> np.ndarray:
    """In-place Hampel filter; returns the (modified) input array.

    For even window sizes the reference's incremental rebuild appends
    original[i + W//2 + 1] while only dropping one element, so original[W]
    never enters any window; we replicate that by deleting it from the
    stream the windows slide over.
    """
    L = len(signal)
    half = window // 2
    n = L - 2 * half - 1  # number of processed positions
    if n <= 0 or L < window:
        return signal
    original = np.asarray(signal).copy()
    if window % 2 == 0:
        stream = np.concatenate([original[:window], original[window + 1 :]])
    else:
        stream = original
    windows = np.lib.stride_tricks.sliding_window_view(stream, window)
    windows = windows[:n]  # window for position i = half + j is windows[j]
    medians = np.median(windows, axis=1)
    mads = MAD_K * np.median(np.abs(windows - medians[:, None]), axis=1)
    center = np.asarray(signal[half : half + n])
    mask = np.abs(center - medians) > n_sigmas * mads
    signal[half : half + n][mask] = medians[mask]
    return signal


def normalize_signal(signal: np.ndarray, shift: float, scale: float) -> np.ndarray:
    """Standardize: (signal - shift) / scale, as float64 (DP runs in log space
    seeded from these values, ref: segment.py:171-173)."""
    return (np.asarray(signal, dtype=np.float64) - shift) / scale


def prepare_read_sequence(seq: str, rna: bool, polya_prefix: str = "AAAAAAAAA") -> str:
    """Orient the read for processing and ensure the RNA polyA anchor.

    RNA reads are reversed 5'->3' to 3'->5' and prefixed with a 9-A polyA
    stub when absent (ref: segment.py:176-179).
    """
    if rna:
        seq = seq[::-1]
        if not seq.startswith(polya_prefix):
            seq = polya_prefix + seq
    return seq

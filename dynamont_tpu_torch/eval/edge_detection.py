"""Wavelet-based ground-truth changepoint generation (ref: src/python/misc/
edgeDetection.py).

The reference uses pywt's gaus1 continuous wavelet transform at scale 10;
pywt is optional here — the gaus1 CWT is a convolution with a scaled,
L2-normalized first-derivative-of-Gaussian kernel, implemented directly in
numpy (numerically equivalent up to boundary handling).
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser

import numpy as np


def _gaus1_kernel(scale: float, n_points: int = 1024):
    """Sampled gaus1 wavelet psi(x) = C * (-2x) exp(-x^2), L2-normalized,
    on pywt's default support [-5, 5], stretched by `scale`."""
    x = np.linspace(-5, 5, n_points)
    psi = -2 * x * np.exp(-(x ** 2))
    psi /= np.sqrt(np.sum(psi ** 2) * (x[1] - x[0]))
    # resample at integer positions of the scaled wavelet
    width = int(np.floor(10 * scale)) + 1
    xi = (np.arange(width) - width // 2) / scale
    k = np.interp(xi, x, psi)
    return k / np.sqrt(scale)


def cwt_gaus1(signal: np.ndarray, scale: float = 10.0) -> np.ndarray:
    """|CWT| row at one scale (matches pywt.cwt(signal, [scale], 'gaus1')
    up to normalization conventions)."""
    k = _gaus1_kernel(scale)
    return np.convolve(signal, k[::-1], mode="same")


def wavelet_peaks(signal: np.ndarray, threshold: float) -> np.ndarray:
    """Changepoint candidates from CWT peaks (ref: edgeDetection.py:28-59):
    find_peaks(height=threshold, distance=3, width=1) + local-stdev filter."""
    from scipy.signal import find_peaks

    half = threshold / 2
    coef = np.abs(cwt_gaus1(signal, 10.0))
    peaks, _ = find_peaks(coef, height=threshold, distance=3, width=1)
    final = []
    for peak in peaks:
        window = coef[max(0, peak - 3): peak + 3]
        if np.std(window) < half:
            final.append(peak)
    return np.asarray(final)


def window_edges(signal: np.ndarray, threshold: float, window_size: int = 6) -> np.ndarray:
    """Adjacent-window scaled mean difference detector
    (ref: edgeDetection.py:61-92; the reference's find_peaks call has a
    `widht` typo — fixed here)."""
    from scipy.signal import find_peaks

    n = len(signal)
    diff = np.zeros(n, dtype=float)
    for i in range(window_size, n - window_size):
        left = signal[i - window_size: i]
        right = signal[i: i + window_size]
        diff[i] = abs(np.mean(left) - np.mean(right)) / (
            np.std(left) + np.std(right) + 2e-8
        )
    return find_peaks(diff, threshold, distance=3, width=1)[0]


def write_changepoints_h5(path: str, per_read: dict) -> None:
    """HDF5 layout consumed by compare_tools: one dataset per readid."""
    import h5py

    with h5py.File(path, "w") as h5:
        for rid, cps in per_read.items():
            h5.create_dataset(rid, data=np.asarray(cps, dtype=np.int64))


def main(argv=None) -> None:
    p = ArgumentParser(prog="dynamont-edge-detection")
    p.add_argument("--tsv", required=True, help="TSV read source")
    p.add_argument("--threshold", type=float, default=1.0)
    p.add_argument("-o", "--output", required=True, help="HDF5 changepoints")
    p.add_argument("--rna", action="store_true")
    args = p.parse_args(argv)

    from dynamont_tpu_torch.io.readers import generate_tsv_jobs

    per_read = {}
    for job in generate_tsv_jobs(args.tsv, args.rna):
        per_read[job.readid] = wavelet_peaks(job.signal, args.threshold)
    write_changepoints_h5(args.output, per_read)
    print(f"wrote changepoints for {len(per_read)} reads", file=sys.stderr)


if __name__ == "__main__":
    main()

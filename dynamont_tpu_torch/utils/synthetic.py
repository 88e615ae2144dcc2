"""Synthetic nanopore read generator for tests and benchmarks.

Samples a random sequence, draws per-base segment lengths, and emits signal
values from the pore model's k-mer Gaussians — producing (signal, read)
pairs on which the HMM assumptions hold exactly.
"""

from __future__ import annotations

import numpy as np

from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids
from dynamont_tpu_torch.utils.pore_model import PoreModel

BASES = "ACGT"


def make_read(
    model: PoreModel,
    n_bases: int = 60,
    mean_dwell: float = 9.0,
    seed: int = 0,
    noise_scale: float = 1.0,
    polya_prefix: bool = True,
):
    """Returns (signal float64 array, read str in processing orientation).

    The read is generated directly in processing orientation (for RNA that
    means 3'->5' with a leading polyA stub, matching what the pipeline feeds
    the DP after prepare_read_sequence).
    """
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list(BASES), size=n_bases))
    if polya_prefix and model.rna:
        seq = "AAAAAAAAA" + seq
    kmer_ids = seq_to_kmer_ids(seq, model.kmer_size, model.alphabet_size)
    dwells = np.maximum(2, rng.poisson(mean_dwell, size=len(kmer_ids)))
    sig = []
    for k, d in zip(kmer_ids, dwells):
        mu, sd = model.means[k], model.stdevs[k] * noise_scale
        sig.append(rng.normal(mu, sd, size=d))
    signal = np.concatenate(sig)
    # round like text round-trip through the reference CLI (repr of float64
    # is exact, so no rounding needed; keep full precision)
    return signal, seq


def signal_to_text(signal: np.ndarray) -> str:
    return ",".join(repr(float(x)) for x in signal)

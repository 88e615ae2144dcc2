"""Per-read result type, input contract, Z error and trained-emission
report of the NT pipelines (the JAX-free parts of
dynamont_tpu/models/nt.py)."""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

from dynamont_tpu_torch.utils.kmer import int2kmer


class ZConsistencyError(RuntimeError):
    """Forward and backward partition functions disagree (reference exit 3)."""

    exit_code = 3


@dataclass
class NTResult:
    segments: list | None = None
    Z: float = math.nan
    trained_transitions: dict | None = None
    trained_emissions: dict | None = None


def _validate(signal_len: int, read_len: int, kmer_size: int) -> None:
    """Input contract with reference exit codes (ref: utils.cpp:530-552)."""

    def die(code, msg):
        print(msg, file=sys.stderr)
        raise SystemExit(code)

    if signal_len < 1:
        die(8, f"Signal: {signal_len} smaller than 1")
    if read_len < 1:
        die(9, f"Read: {read_len} smaller than 1")
    if signal_len + 1 < 2 * read_len:
        die(10, f"Signal: {signal_len + 1} smaller than read: {read_len}")
    if read_len < kmer_size:
        die(11, f"Read: {read_len} smaller than kmerSize of the pore type: {kmer_size}")


def _emissions_to_dict(means, stdevs, model) -> dict:
    """Only k-mers with nonzero trained stdev are reported (ref:
    NT.cpp:355-361)."""
    out = {}
    for k in range(model.num_kmers):
        if stdevs[k] != 0.0:
            kmer = int2kmer(k, model.alphabet_size, model.kmer_size, model.rna)
            out[kmer] = (float(means[k]), float(stdevs[k]))
    return out

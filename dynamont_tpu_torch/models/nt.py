"""Per-read result type, input contract and Z error of the NT pipelines
(the JAX-free parts of dynamont_tpu/models/nt.py)."""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass


class ZConsistencyError(RuntimeError):
    """Forward and backward partition functions disagree (reference exit 3)."""

    exit_code = 3


@dataclass
class NTResult:
    segments: list | None = None
    Z: float = math.nan


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

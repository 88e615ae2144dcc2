"""k-mer <-> integer codec, vectorized for batch pipelines.

Behavioral contract (matches ref: utils.cpp:196-245, utils.hpp:163-181):
  * kmer2int interprets the string as a base-`alphabet_size` number with the
    FIRST character as the most significant digit.
  * int2kmer ("itoa") emits the digits least-significant-first and reverses
    them for DNA only, so that RNA k-mers (which the pipeline holds in 3'->5'
    orientation) are printed in 5'->3' direction.
  * successing/precessing kmer step the rolling window by one nucleotide.
"""

from __future__ import annotations

import numpy as np

from dynamont_tpu_torch.constants import BASE2ID, ID2BASE

_LUT = np.full(256, -1, dtype=np.int32)
for _b, _i in BASE2ID.items():
    _LUT[ord(_b)] = _i


def kmer2int(kmer: str, alphabet_size: int) -> int:
    """Integer representation of a k-mer string (first char most significant)."""
    val = 0
    for c in kmer:
        val = val * alphabet_size + BASE2ID[c]
    return val


def int2kmer(value: int, alphabet_size: int, kmer_size: int, rna: bool) -> str:
    """Inverse of kmer2int, with reference 'itoa' orientation semantics.

    Digits are produced least-significant-first; for DNA the buffer is
    reversed (most-significant first). For RNA it is NOT reversed, which
    converts the internal 3'->5' k-mer back to 5'->3' for output.
    """
    digits = []
    q = int(value)
    while True:
        digits.append(ID2BASE[q % alphabet_size])
        q //= alphabet_size
        if not q:
            break
    while len(digits) < kmer_size:
        digits.append(ID2BASE[0])
    if not rna:
        digits.reverse()
    return "".join(digits)


_ID2BASE_CODES = np.frombuffer(b"ACGTN", dtype=np.uint8)


def int2kmers_batch(values, alphabet_size: int, kmer_size: int,
                    rna: bool) -> list[str]:
    """Vectorized int2kmer over an array of k-mer ids (same orientation
    semantics); one ascii-decode slice per k-mer instead of a digit loop."""
    v = np.asarray(values, np.int64).reshape(-1)
    powers = alphabet_size ** np.arange(kmer_size, dtype=np.int64)
    d = (v[:, None] // powers) % alphabet_size  # LSB-first digits
    if not rna:
        d = d[:, ::-1]
    flat = np.ascontiguousarray(_ID2BASE_CODES[d]).tobytes()
    S = kmer_size
    return [flat[i * S:(i + 1) * S].decode("ascii") for i in range(len(v))]


def seq_to_base_ids(seq: str) -> np.ndarray:
    """Vectorized base -> token array. Raises on non-IUPAC characters."""
    arr = _LUT[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
    if (arr < 0).any():
        bad = sorted(set(seq) - set(BASE2ID))
        raise ValueError(f"invalid nucleotide characters in read: {bad}")
    return arr


def seq_to_kmer_ids(seq: str, kmer_size: int, alphabet_size: int) -> np.ndarray:
    """All rolling-window k-mer ids of a read, vectorized.

    Equivalent to [kmer2int(seq[n:n+kmer_size]) for n in range(len(seq)-kmer_size+1)]
    (ref: NT_main.cpp:113-117) but O(len) with a rolling update.
    """
    ids = seq_to_base_ids(seq).astype(np.int64)
    n_kmers = len(seq) - kmer_size + 1
    if n_kmers <= 0:
        return np.empty(0, dtype=np.int64)
    # polynomial evaluation via cumulative rolling window
    weights = alphabet_size ** np.arange(kmer_size - 1, -1, -1, dtype=np.int64)
    windows = np.lib.stride_tricks.sliding_window_view(ids, kmer_size)
    return windows @ weights


def successing_kmer(kmer: int, next_nt: int, step_size: int, alphabet_size: int) -> int:
    """k_{i+1} = (k_i mod step) * base + next  (ref: utils.hpp:163-166)."""
    return (kmer % step_size) * alphabet_size + next_nt


def precessing_kmer(kmer: int, prior_nt: int, step_size: int, alphabet_size: int) -> int:
    """k_{i-1} = k_i / base + prior * step  (ref: utils.hpp:178-181)."""
    return (kmer // alphabet_size) + prior_nt * step_size


def hamming_distance_ids(kmer_a: int, kmer_b: int, alphabet_size: int, kmer_size: int) -> int:
    """Hamming distance between two k-mers in integer representation."""
    d = 0
    a, b = int(kmer_a), int(kmer_b)
    for _ in range(kmer_size):
        d += (a % alphabet_size) != (b % alphabet_size)
        a //= alphabet_size
        b //= alphabet_size
    return d


def hamming_table(alphabet_size: int, kmer_size: int) -> np.ndarray:
    """(K, K) int8 table of pairwise k-mer Hamming distances, built vectorized.

    Used by the NTC emission score -2*HD(kmerN, kmerK) (ref: NTC.hpp:51-76).
    Only sensible for K = alphabet_size**kmer_size up to ~4^5=1024 (1 MB).
    """
    K = alphabet_size ** kmer_size
    ks = np.arange(K)
    digits = np.empty((kmer_size, K), dtype=np.int8)
    q = ks.copy()
    for i in range(kmer_size):
        digits[i] = q % alphabet_size
        q //= alphabet_size
    # (K, K) sum over digit mismatches
    hd = np.zeros((K, K), dtype=np.int8)
    for i in range(kmer_size):
        hd += digits[i][:, None] != digits[i][None, :]
    return hd

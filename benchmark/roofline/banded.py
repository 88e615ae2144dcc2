"""Operations and bytes of the banded segmentation kernels K1 `banded_bwd`,
K2 `banded_fwd_vit` and K3 `banded_walk` for one read, from the read's own
sizes and the recurrences of `benchmark/reference/banded.py`, never from the
padded buckets or the buffers the program allocates.

Cells: T rows (samples + 1) by the read's own band, 2 min(band/2, N/2) + 3
columns (N = k-mers + 1). Operations a cell, an exp, log1p, max or compare
counting one each, a logaddexp five (max, difference, exp, log1p, add):
- K1, backward: two emission scores (4 each: difference, two products,
  difference), M from E (1), the extension M + score + log_m1 (2), E + score
  + log_e2 (2) and their logaddexp (5): 18;
- K2, forward, posteriors and Viterbi: one emission score (4), M (2), the
  two E terms (1 + 2) and their logaddexp (5), the two log posteriors
  fwd + bwd - Zb (4), the Viterbi step (M 1, max and add 2, choice 1): 22.
K3 walks one cell a row: 16 operations a row (masks, the selected log
posterior, its exp, the position updates).
Bytes: the signal read once in the working precision, the mean, c1 and c2
of each k-mer position, and each base's start and median written once, with
the read's two Z values.
"""

KERNELS = ("banded_bwd_kernel", "banded_fwd_vit_kernel", "banded_walk_kernel")
OPS_PER_CELL = 18 + 22
OPS_PER_ROW = 16


def counts(T: int, N: int, band: int = 400, itemsize: int = 4):
    """(operations, bytes) of one read of T - 1 samples and N - 1 k-mers."""
    bw = min(band // 2, N // 2)
    cells = T * (2 * bw + 3)
    ops = OPS_PER_CELL * cells + OPS_PER_ROW * T
    nbytes = (T - 1) * itemsize + 3 * (N - 1) * itemsize + 2 * N * 4 + 2 * itemsize
    return ops, nbytes

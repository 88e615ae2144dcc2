"""Operations and bytes of the NTC resquiggle kernels K7-K16 for one read,
from the read's own sizes and the recurrences of `benchmark/reference/
ntc.py`, never from the padded buckets, the candidate caps or the buffers
the program allocates.

Cells: the TN pre-pass T rows by N columns (N = k-mers + 1), the TK
pre-pass T rows by K columns (every k-mer), and of the sparse lattice one
cell a row, the read's own k-mer at its base: every allowed set holds it,
so the lattice's true work is at least this and the share is at most the
true one. Operations a cell, an exp, log, max or compare counting one
each, a logaddexp five (max, difference, exp, log1p, add), a logsumexp of
m terms 4m - 1 (m - 1 maxima, m exps, m - 1 adds, a log, an add):
- K7, TN forward: the emission score -0.5 (log 2 pi + 2 log sd + d d), d =
  (x - mean) / sd (6), M (2), E's two terms (3) and their logaddexp (5): 16;
- K8, TN backward and the column's posterior: the score (6), M (1), the
  extension (2), E's second term (2) and logaddexp (5), then fM + bM, fE +
  bE and their logaddexp (7): 23;
- K9, TK backward: the score c1 - c2 (x - mean)^2 (4), M (1), the
  successor terms (2) and a quarter of their logsumexp over A = 4 (15 / 4,
  taken as 4), E's second term (2) and logaddexp (5): 18;
- K10, TK forward and the posterior: the score (4), a quarter of the
  predecessors' logsumexp (4), M (2), E (3 + 5), the posterior (7): 25;
- K11, K13-K16, the lattice cell: its score (three Gaussians and the
  Hamming term, 15), the forward A (8 terms: 8 adds, 31, 1), P (12
  terms: 12, 47, 1), S (3 + 11 + 1), E (3 + 15 + 1), I (8), the backward
  (as many again and the successor scores: 150), the posterior (10), the
  Viterbi (33) and the walk's row (16): 340.
Bytes: the signal read once in the working precision, the k-mer ids, the
table's mean, c1 and c2 of every k-mer, and each base's segment (state,
position, start, polish k-mer, median) written once.
"""

KERNELS = ("tn_fwd_kernel", "tn_bwd_u_kernel", "tn_sel_kernel", "tk_bwd_kernel",
           "tk_fwd_u_kernel", "tab_gather_kernel", "bwd_kernel", "bwd_shared_kernel",
           "bwd_ckpt_kernel", "bwd_ckpt_cluster_kernel", "pv_kernel",
           "pv_shared_kernel", "pv_ckpt_cluster_kernel", "walk_kernel")
OPS_PER_TN_CELL = 16 + 23
OPS_PER_TK_CELL = 18 + 25
OPS_PER_LATTICE_ROW = 340


def counts(T: int, N: int, K: int = 1024, itemsize: int = 8):
    """(operations, bytes) of one read of T - 1 samples and N - 1 k-mers
    against a table of K k-mers."""
    ops = T * (OPS_PER_TN_CELL * N + OPS_PER_TK_CELL * K + OPS_PER_LATTICE_ROW)
    nbytes = (T - 1) * itemsize + (N - 1) * 4 + 3 * K * itemsize \
        + N * (4 * 4 + itemsize)
    return ops, nbytes

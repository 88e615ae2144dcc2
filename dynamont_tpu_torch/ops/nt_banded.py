"""Exact per-read banded NT segmentation (counterpart of
dynamont_tpu/ops/nt_banded.py, segment mode).

The JAX package runs a separate per-read scan here. The port runs the
same three kernels as the batched path, one read per launch, on the
unpadded float64 signal (T_pad = T): the batched pipeline already equals
the per-read DP to 1e-12 in fp64, and one set of kernels serves both.
"""

from __future__ import annotations

import torch

from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops import nt_banded_kernels as kk


def banded_segment_read(signal, kmer_ids, model, band: int,
                        log_m1: float, log_e2: float, *, device,
                        dtype=torch.float64):
    """One read -> (Zf, Zb, starts, medians) as host values: Zf/Zb floats,
    starts (N,) int32 and medians (N,) numpy arrays, N = len(kmer_ids)+1."""
    batch = bb.prepare_batch([signal], [kmer_ids], model, band,
                             device=device, dtype=dtype, t_pad_to=1)
    N = len(kmer_ids) + 1
    Zf, Zb, starts, medians = kk.banded_segment(batch, N, log_m1, log_e2)
    return (float(Zf[0]), float(Zb[0]), starts[0].cpu().numpy(),
            medians[0].cpu().numpy())

"""Exact per-read banded NT DP (counterpart of dynamont_tpu/ops/nt_banded.py):
segmentation, the per-t border log-probabilities of dynamont-NT-banded -p,
and the Baum-Welch estimates of the train and calcZ modes.

The JAX package runs a separate per-read scan here. The port runs the
same kernels as the batched paths, one read per launch, on the unpadded
float64 signal (T_pad = T): the batched pipelines already equal the
per-read DP to 1e-12 in fp64, and one set of kernels serves both.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops import nt_banded_kernels as kk
from dynamont_tpu_torch.ops import nt_banded_train
from dynamont_tpu_torch.utils.logmath import logsumexp


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


def banded_per_t_logprob(signal, kmer_ids, model, band: int, log_m1: float,
                         log_e2: float, *, device, dtype=torch.float64):
    """(T,) numpy logsumexp of each LPM row of one read (ref:
    NT_banded_main.cpp -p): the read through the matrix route's kernels
    (K5, K1, K4), the only ones that keep LPM read-major. The band is
    round_up(2*bw+3, 128) wide where the JAX package's is 2*bw+3; the extra
    columns are -inf and add nothing."""
    batch = bb.prepare_batch([signal], [kmer_ids], model, band,
                             device=device, dtype=dtype, t_pad_to=1)
    LPM = bb.log_posteriors(batch, log_m1, log_e2)[3]
    return logsumexp(LPM[0], dim=1).cpu().numpy()


def banded_train_read(signal, kmer_ids, model, band: int, log_m1: float,
                      log_e2: float, *, device, dtype=torch.float64):
    """One read through the training kernels (K5, K6) -> (Zf, Zb, m1, e2,
    means, stdevs) as host values: floats, then (K,) numpy arrays. The
    emission statistics divide by each position's weight unconditionally,
    as the JAX per-read path does (ops/nt_banded.py:321, 334)."""
    batch = bb.prepare_batch([signal], [kmer_ids], model, band,
                             device=device, dtype=dtype, t_pad_to=1)
    res = nt_banded_train.banded_batch_train(
        batch, log_m1, log_e2, np.asarray(kmer_ids)[None],
        model.num_kmers, guard=False)
    return (float(res.Zf[0]), float(res.Zb[0]), float(res.m1[0]),
            float(res.e2[0]), res.means[0].cpu().numpy(),
            res.stdevs[0].cpu().numpy())

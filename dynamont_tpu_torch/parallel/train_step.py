"""Sharded banded Baum-Welch step: data-parallel over a list of devices
(counterpart of dynamont_tpu/parallel/train_step.py).

Each device runs ops/nt_banded_train.banded_batch_train (K5 -> K6 on the
card) on its contiguous share of a prepared batch; the batch-pooled
statistics are formed per device under the Z gate of JAX's shard_fn and
added across devices in device order, on the first device, where JAX
sums them with psum. This replaces the reference's per-read C++ child
processes + host-side ManagedList pooling (ref: train.py:211,236-247).

Shares may differ in size by a read, and a device with no read is left
out: the kernels take any read count, so no T = N = 1 padding rows are
needed, where JAX pads the reads axis to a multiple of the mesh size.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops.nt_banded_train import banded_batch_train
from dynamont_tpu_torch.parallel.mesh import on_device


class PooledStats(NamedTuple):
    """Batch-pooled training statistics (on the first device)."""

    m1_sum: torch.Tensor      # scalar: sum of per-read m1 estimates over valid reads
    e2_sum: torch.Tensor
    n_valid: torch.Tensor     # scalar: number of reads passing the Z invariant
    mean_sum: torch.Tensor    # (K,) sum over contributing reads of per-read kmer mean
    stdev_sum: torch.Tensor   # (K,) same for stdevs
    kmer_count: torch.Tensor  # (K,) number of contributing reads per kmer
    z_sum: torch.Tensor       # scalar: sum of per-read Z over valid reads


class ShardedTrainOut(NamedTuple):
    per_read: bb.BandedTrainResult  # gathered along reads, on the first device
    pooled: PooledStats


class Shard(NamedTuple):
    """One device's contiguous share of a batch (reads lo:hi)."""

    device: torch.device
    batch: bb.BandedBatch
    kmer_ids_pad: np.ndarray
    lo: int
    hi: int


def shard_batch(batch: bb.BandedBatch, kmer_ids_pad, devices) -> list[Shard]:
    """Split a prepared batch into contiguous shares, one per device (as
    np.array_split, the first shares a read longer), each moved to its
    device; a device whose share is empty gets none. Every share keeps the
    batch's T_pad, pad and B, so a read meets the same padded problem as
    in the whole batch (counterpart of shard_batch_for_mesh)."""
    devices = [torch.device(d) for d in devices]
    kid = (kmer_ids_pad.cpu().numpy() if isinstance(kmer_ids_pad, torch.Tensor)
           else np.asarray(kmer_ids_pad))
    R = batch.sig.shape[0]
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(R), len(devices))])
    shards = []
    for dev, lo, hi in zip(devices, bounds[:-1], bounds[1:]):
        if hi == lo:
            continue
        # copies: a share starts at an allocation, as the kernels' staged
        # copies want, also where the batch is on the share's device
        part = bb.BandedBatch(*(x[lo:hi].to(dev, copy=True) for x in batch[:8]),
                              pad=batch.pad, B=batch.B)
        shards.append(Shard(dev, part, kid[lo:hi], int(lo), int(hi)))
    return shards


def make_sharded_train_step(devices, m1: float, e2: float, num_kmers: int,
                            pad: int, B: int, dtype=torch.float32):
    """Build the data-parallel training step for batches of band geometry
    (pad, B) in `dtype` over `devices`. Returns step(shards, m1_cur=None,
    e2_cur=None) -> ShardedTrainOut; m1_cur/e2_cur override the
    construction-time transitions."""
    devices = [torch.device(d) for d in devices]
    log_m1_0, log_e2_0 = math.log(m1), math.log(e2)
    eps = bb.z_epsilon(dtype)

    def shard_fn(sh: Shard, log_m1: float, log_e2: float):
        b = sh.batch
        res = banded_batch_train(b, log_m1, log_e2, sh.kmer_ids_pad, num_kmers)
        cells = b.T.to(res.Zf.dtype) * B
        ok = (torch.isfinite(res.Zf) & torch.isfinite(res.Zb)
              & ((res.Zf - res.Zb).abs() / cells <= eps)
              & (b.T > 1))  # degenerate rows are padding, not data
        okf = ok.to(res.m1.dtype)
        cf = (res.kmer_mask & ok[:, None]).to(res.means.dtype)
        sums = PooledStats(
            m1_sum=(res.m1 * okf).sum(), e2_sum=(res.e2 * okf).sum(),
            n_valid=okf.sum(), mean_sum=(res.means * cf).sum(0),
            stdev_sum=(res.stdevs * cf).sum(0), kmer_count=cf.sum(0),
            z_sum=torch.where(ok, res.Zb, 0.0).sum())
        return res, sums

    def step(shards: list[Shard], m1_cur: float | None = None,
             e2_cur: float | None = None) -> ShardedTrainOut:
        lm = log_m1_0 if m1_cur is None else math.log(m1_cur)
        le = log_e2_0 if e2_cur is None else math.log(e2_cur)
        outs = []
        for sh in shards:
            if sh.device not in devices:
                raise ValueError(f"shard on {sh.device}, not one of {devices}")
            if (sh.batch.pad, sh.batch.B, sh.batch.sig.dtype) != (pad, B, dtype):
                raise ValueError("shard geometry differs from the step's")
            with on_device(sh.device):
                outs.append(shard_fn(sh, lm, le))
        # the pooled sums added in device order on the first device (psum)
        first = devices[0]
        pooled = None
        for _, sums in outs:
            moved = PooledStats(*(x.to(first) for x in sums))
            pooled = moved if pooled is None else PooledStats(
                *(a + b for a, b in zip(pooled, moved)))
        per_read = bb.BandedTrainResult(
            *(torch.cat([r[i].to(first) for r, _ in outs])
              for i in range(len(bb.BandedTrainResult._fields))))
        return ShardedTrainOut(per_read, pooled)

    return step


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pool_params(pooled: PooledStats):
    """Batch-mean parameter update from pooled stats (host-side; equivalent of
    setting each param to the ManagedList window mean, ref: train.py:236-247)."""
    n = float(_host(pooled.n_valid))
    if n == 0:
        return None
    out = {
        "m1": float(_host(pooled.m1_sum)) / n,
        "e1": 1.0,
        "e2": float(_host(pooled.e2_sum)) / n,
        "Z": float(_host(pooled.z_sum)) / n,
    }
    count = _host(pooled.kmer_count).astype(np.float64)
    safe = np.where(count > 0, count, 1.0)
    out["kmer_means"] = _host(pooled.mean_sum).astype(np.float64) / safe
    out["kmer_stdevs"] = _host(pooled.stdev_sum).astype(np.float64) / safe
    out["kmer_seen"] = count > 0
    return out

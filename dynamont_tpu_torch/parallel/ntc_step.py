"""NTC (resquiggle-mode) Baum-Welch sharded over a list of devices
(counterpart of dynamont_tpu/parallel/ntc_step.py).

Each device runs the NTC training bucket program
(models/ntc_batch.ntc_train_bucket_program: pre-pass K7-K10, plan, K11,
K17 forward store, K18 train) on its share of at most R_SHARD reads; the
13 transition-term statistics and the emission moment sums are formed per
device and added across devices in device order, on the first device,
where JAX sums them with psum (ref semantics: NTC.cpp:923-1130 + the
driver-host pooling of train.py:236-247).

The port's bucket program takes any read count, so shares are contiguous
and may differ by a read, with no read-0 replicas or `real` flags: JAX
pads every device to the Mosaic geometry's 16 reads.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dynamont_tpu_torch.constants import (
    EPSILON, NT_TRANSITIONS, NTK_TRANSITIONS, resolve_transitions,
)
from dynamont_tpu_torch.models.ntc_batch import (
    FP32_EPSILON, model_tensors, ntc_train_bucket_program,
)
from dynamont_tpu_torch.models.packing import round_up, t_pad_ladder
from dynamont_tpu_torch.ops.ntc_batch import TERMS
from dynamont_tpu_torch.ops.ntc_train import TRAIN_THRESHOLD
from dynamont_tpu_torch.parallel.mesh import on_device
from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids

R_SHARD = 16  # reads per device at most (JAX: the Mosaic kernel geometry)


class NTCPart(NamedTuple):
    """One device's contiguous share (reads lo:hi), on that device."""

    device: torch.device
    sig: torch.Tensor  # (r, T_pad-1) float32
    kid: torch.Tensor  # (r, N2-1) int32
    T: torch.Tensor    # (r,) int32
    N: torch.Tensor    # (r,) int32
    lo: int
    hi: int


class NTCShard(NamedTuple):
    """A read batch laid out over the devices."""

    parts: list        # NTCPart per device with reads
    T: np.ndarray      # (R,) int32 true T of every read
    N: np.ndarray      # (R,) int32 true N
    n_real: int


class NTCPooled(NamedTuple):
    """Batch statistics summed over the devices (on the first device)."""

    trans_sum: torch.Tensor   # (13,) sum over valid reads of per-read prob
    n_valid: torch.Tensor     # scalar
    mean_sum: torch.Tensor    # (K,) sum of per-read kmer mean estimates
    stdev_sum: torch.Tensor   # (K,)
    kmer_count: torch.Tensor  # (K,) contributing reads per kmer
    z_sum: torch.Tensor       # scalar sum of per-read Z over valid reads


def prepare_ntc_shard(items, model, devices, t_pad_to: int = 2048,
                      n_pad_to: int = 256) -> NTCShard:
    """Pad reads to one bucket shape (as NTCBatchEngine pads a bucket:
    T on the t_pad_ladder, N2 a multiple of n_pad_to, the signal in fp32)
    and split them into contiguous shares of at most R_SHARD reads, one
    per device, each placed on its device.

    items: list of (signal, read) pairs or BatchItem-likes with .signal /
    .read attributes."""
    devices = [torch.device(d) for d in devices]
    pairs = [(it.signal, it.read) if hasattr(it, "signal") else it for it in items]
    if not pairs:
        raise ValueError("prepare_ntc_shard: empty batch")
    if len(pairs) > len(devices) * R_SHARD:
        raise ValueError(f"{len(pairs)} reads > {len(devices) * R_SHARD} slots "
                         f"on {len(devices)} devices")
    kids = [np.asarray(seq_to_kmer_ids(r, model.kmer_size, model.alphabet_size),
                       np.int32) for _, r in pairs]
    T_arr = np.array([len(s) + 1 for s, _ in pairs], np.int32)
    N_arr = np.array([len(k) + 1 for k in kids], np.int32)
    T_pad = t_pad_ladder(int(T_arr.max()), t_pad_to)
    N2 = round_up(int(N_arr.max()), n_pad_to)
    R = len(pairs)
    sig = np.zeros((R, T_pad - 1), np.float32)
    kid = np.zeros((R, N2 - 1), np.int32)
    for j, ((s, _), k) in enumerate(zip(pairs, kids)):
        sig[j, : T_arr[j] - 1] = s
        kid[j, : N_arr[j] - 1] = k
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(R), len(devices))])
    parts = []
    for dev, lo, hi in zip(devices, bounds[:-1], bounds[1:]):
        if hi > lo:
            put = lambda a: torch.from_numpy(a[lo:hi].copy()).to(dev)
            parts.append(NTCPart(dev, put(sig), put(kid), put(T_arr), put(N_arr),
                                 int(lo), int(hi)))
    return NTCShard(parts, T_arr, N_arr, R)


# TERMS-indexed normalization groups (ref: NTC.cpp:1003-1030)
_GROUPS = (("a1", "s2", "e4", "i1", "p2"), ("e3", "p1"),
           ("e2", "s1"), ("a2", "i2", "p3", "s3"))


def _trans_probs_device(term_lse):
    """(13, R) raw term logsumexps -> (13, R) normalized probabilities
    (vectorized trans_from_terms; groups per NTC.cpp:1003-1030)."""
    idx = {k: i for i, k in enumerate(TERMS)}
    out = term_lse.clone()
    for group in _GROUPS:
        rows = torch.tensor([idx[k] for k in group], device=term_lse.device)
        vals = term_lse[rows]                       # (g, R)
        m = vals.amax(0)
        fin = torch.isfinite(m)
        safe = torch.where(fin, m, 0.0)
        g_lse = torch.log(torch.exp(vals - safe).sum(0)) + safe
        g_lse = torch.where(fin, g_lse, -math.inf)
        out[rows] = torch.where(torch.isfinite(g_lse), vals - g_lse, vals)
    return torch.exp(out)


def _emission_estimates_device(em, model_means):
    """(R, 3, K) centered moment sums -> per-read (means, stdevs, contrib)
    (vectorized emissions_from_moments; ref: NTC.cpp:1059-1130)."""
    norm, s1, s2 = em[:, 0], em[:, 1], em[:, 2]
    nz = norm != 0
    safe = torch.where(nz, norm, 1.0)
    d = s1 / safe
    keep = norm >= TRAIN_THRESHOLD
    var = torch.where(keep & nz, torch.clamp(s2 / safe - d * d, min=0.0), 0.0)
    means = torch.where(nz, model_means[None, :] + d, 0.0)
    stdevs = torch.sqrt(var)
    return means, stdevs, stdevs > 0.0


def _gate(res, T, N, K: int, caps, eps: float):
    """Per-read pass of the training bucket's gates, in fp64 on the
    device: no cap overflow, and the NTCBatchEngine's three Z checks
    (an infinite Z, or |Zf - Zb| per cell above eps, fails)."""
    cap_n, cap_k = caps
    Tf, Nf = T.double(), N.double()
    ok = ~res["ovf_tn"] & ~res["ovf_tk"]
    for zf, zb, cells in ((res["Zf_tn"], res["Zb_tn"], Tf * Nf),
                          (res["Zf_tk"], res["Zb_tk"], Tf * K),
                          (res["Zf"], res["Zb"], Tf * (5 * cap_n * (cap_k + cap_n)))):
        zf, zb = zf.double(), zb.double()
        bad = torch.isinf(zf) | torch.isinf(zb) | ((zf - zb).abs() / cells > eps)
        ok = ok & ~bad
    return ok


def bucket_sums(res: dict, T, N, model_means, caps, dtype):
    """(ok, NTCPooled) of one training bucket's results `res` (as
    ntc_train_bucket_program returns them) for reads of true T and N: the
    gate, and the sums over the reads that pass it of the normalized
    transitions, the k-mer estimates and Zf."""
    eps = EPSILON if dtype == torch.float64 else FP32_EPSILON
    ok = _gate(res, T, N, model_means.shape[0], caps, eps)
    okf = ok.to(dtype)
    probs = _trans_probs_device(res["term_lse"])          # (13, r)
    e_means, e_stdevs, contrib = _emission_estimates_device(res["em"], model_means)
    cf = (contrib & ok[:, None]).to(dtype)
    return ok, NTCPooled(
        trans_sum=(probs * okf[None, :]).sum(1), n_valid=okf.sum(),
        mean_sum=(e_means * cf).sum(0), stdev_sum=(e_stdevs * cf).sum(0),
        kmer_count=cf.sum(0), z_sum=torch.where(ok, res["Zf"].to(dtype), 0.0).sum())


def make_ntc_sharded_train_step(devices, model, pore: str,
                                transition_overrides: dict | None = None,
                                cap_n: int = 8, cap_k: int = 120,
                                dtype=torch.float32):
    """Build the data-parallel NTC training step over `devices` at the
    engine's caps. Returns step(shard, tl_overrides=None, model_now=None)
    -> dict with per-read ok, Zf, Zb, term_lse (13, R), em (R, 3, K)
    gathered on the first device, and `pooled` (NTCPooled); tl_overrides
    are the current transitions and model_now the current emission tables
    (the build-time ones by default)."""
    devices = [torch.device(d) for d in devices]
    ntk = resolve_transitions(NTK_TRANSITIONS[pore], transition_overrides)
    nt = NT_TRANSITIONS[pore]
    log_ppm, log_ppe = math.log(nt["m1"]), math.log(nt["e2"])
    A, S = model.alphabet_size, model.kmer_size

    def shard_fn(part: NTCPart, tensors: dict, trans_log: dict):
        res = ntc_train_bucket_program(
            part.sig.to(dtype), part.kid, part.N, part.T, tensors, A=A, S=S,
            log_ppm=log_ppm, log_ppe=log_ppe, trans_log=trans_log, CN=cap_n,
            CK0=cap_k, dtype=dtype)
        ok, sums = bucket_sums(res, part.T, part.N, tensors["means"],
                               (cap_n, cap_k), dtype)
        return dict(ok=ok, Zf=res["Zf"], Zb=res["Zb"],
                    term_lse=res["term_lse"], em=res["em"]), sums

    def step(shard: NTCShard, tl_overrides: dict | None = None,
             model_now=None) -> dict:
        trans = ntk if tl_overrides is None else resolve_transitions(ntk, tl_overrides)
        trans_log = {k: math.log(v) for k, v in trans.items()}
        m = model if model_now is None else model_now
        outs = []
        for part in shard.parts:
            if part.device not in devices:
                raise ValueError(f"shard on {part.device}, not one of {devices}")
            with on_device(part.device):
                outs.append(shard_fn(part, model_tensors(m, part.device, dtype),
                                     trans_log))
        first = devices[0]
        pooled = None
        for _, sums in outs:
            moved = NTCPooled(*(x.to(first) for x in sums))
            pooled = moved if pooled is None else NTCPooled(
                *(a + b for a, b in zip(pooled, moved)))
        cat = lambda k, dim=0: torch.cat([o[k].to(first) for o, _ in outs], dim)
        return dict(ok=cat("ok"), Zf=cat("Zf"), Zb=cat("Zb"),
                    term_lse=cat("term_lse", 1), em=cat("em"), pooled=pooled)

    return step


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pool_ntc_params(pooled: NTCPooled):
    """Batch-mean 14-param + emission update from pooled stats (host-side;
    the device sum replaces per-read driver-host pooling, ref:
    train.py:236-247)."""
    n = float(_host(pooled.n_valid))
    if n == 0:
        return None
    trans = _host(pooled.trans_sum).astype(np.float64) / n
    out = {k: float(v) for k, v in zip(TERMS, trans)}
    out["e1"] = 1.0
    out["Z"] = float(_host(pooled.z_sum)) / n
    count = _host(pooled.kmer_count).astype(np.float64)
    safe = np.where(count > 0, count, 1.0)
    out["kmer_means"] = _host(pooled.mean_sum).astype(np.float64) / safe
    out["kmer_stdevs"] = _host(pooled.stdev_sum).astype(np.float64) / safe
    out["kmer_seen"] = count > 0
    return out

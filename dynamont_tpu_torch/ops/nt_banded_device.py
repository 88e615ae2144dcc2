"""Device-resident banded segmentation: compact wire format in, per-base
segment summaries out (counterpart of dynamont_tpu/ops/nt_banded_device.py).

    int16 samples --> affine normalize --> band starts by cumsum -->
    mu/c1/c2 gathers --> banded_bwd --> banded_fwd_vit --> banded_walk -->
    grouped medians --> per-base (start, median posterior)

Only the wire crosses host -> device (int16 samples, k-mer ids, bit-packed
band shifts, per-read scalars: ~2.3 bytes/sample) and only the summaries
come back (starts, medians, Zf, Zb). The decode is plain torch on the
device, as it is XLA (not Pallas) in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from dynamont_tpu_torch.ops.geometry import band_geometry, effective_bandwidth
from dynamont_tpu_torch.ops import nt_banded_batch as bb
from dynamont_tpu_torch.ops import nt_banded_kernels as kk

# N_max quantum: the JAX engine pads every bucket's N_max to a multiple of
# 128 (dynamont_tpu/models/batch.py), so buckets share few shapes
N_PAD_TO = 128


class WireBatch(NamedTuple):
    """Minimal host->device payload for a padded batch of reads."""

    dacs: torch.Tensor        # (R, T_pad-1) int16 raw/quantized samples
    aff_a: torch.Tensor       # (R,) float32: sig = dacs * a + b
    aff_b: torch.Tensor       # (R,)
    kmer_ids: torch.Tensor    # (R, N_max-1) int32, 0-padded
    shift_bits: torch.Tensor  # (R, ceil(T_pad/8)) uint8, little-endian bits
                              # of shift[t] = (bstart[t] != bstart[t-1])
    T: torch.Tensor           # (R,) int32 true T
    N: torch.Tensor           # (R,) int32 true N
    bw: torch.Tensor          # (R,) int32 effective bandwidth
    pad: int                  # left padding of position arrays
    B: int                    # band width
    N_max: int                # max N in bucket
    T_pad: int                # padded T


class DeviceSegResult(NamedTuple):
    Zf: torch.Tensor       # (R,)
    Zb: torch.Tensor       # (R,)
    starts: torch.Tensor   # (R, N_max) int32 segment start per base, -1 = none
    medians: torch.Tensor  # (R, N_max) median posterior prob per base


def quantize_signal(sig: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Lossy-but-tiny (<=1e-4 absolute) int16 encoding of an already
    normalized float signal; the affine is snapped to float32, the wire
    dtype, so host-side reconstruction is bit-identical to the device's."""
    m = float(np.max(np.abs(sig))) if len(sig) else 1.0
    a = float(np.float32(max(m, 1e-12) / 32000.0))
    dac = np.clip(np.rint(sig / a), -32768, 32767).astype(np.int16)
    return dac, a, 0.0


def prepare_wire(signals, kmer_ids_list, band: int = 400, *, device,
                 t_pad: int) -> WireBatch:
    """Pack float `signals` (int16-quantized here) into the wire format on
    `device`, padded to `t_pad` rows (engines pass t_pad_ladder points) and
    N_max rounded up to N_PAD_TO. The arrays are packed in numpy exactly as
    the JAX engine packs them, then copied from pinned host memory with one
    non-blocking copy each."""
    R = len(signals)
    T_arr = np.array([len(s) + 1 for s in signals], dtype=np.int32)
    N_arr = np.array([len(k) + 1 for k in kmer_ids_list], dtype=np.int32)
    bw_arr = np.array([effective_bandwidth(band, int(n)) for n in N_arr], np.int32)
    max_bw = int(bw_arr.max())
    B = bb.round_up(2 * max_bw + 3, 128)
    pad = max_bw + 3
    if t_pad < int(T_arr.max()):
        raise ValueError(f"t_pad={t_pad} is shorter than the longest read")
    N_max = bb.round_up(int(N_arr.max()), N_PAD_TO)

    dac_arr = np.zeros((R, t_pad - 1), dtype=np.int16)
    kid_arr = np.zeros((R, N_max - 1), dtype=np.int32)
    bits = np.zeros((R, (t_pad + 7) // 8), dtype=np.uint8)
    a_arr = np.zeros(R, np.float32)
    b_arr = np.zeros(R, np.float32)
    for i in range(R):
        T, N, bw = int(T_arr[i]), int(N_arr[i]), int(bw_arr[i])
        dac_arr[i, : T - 1], a_arr[i], b_arr[i] = quantize_signal(signals[i])
        kid_arr[i, : N - 1] = kmer_ids_list[i]
        geom = band_geometry(T, N, bw)  # float64 midpoint parity on host
        shift = np.zeros(t_pad, dtype=np.uint8)
        shift[1:T] = geom.shift[1:].astype(np.uint8)
        bits[i] = np.packbits(shift, bitorder="little")
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(a):
        t = torch.from_numpy(a)
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    return WireBatch(
        dacs=put(dac_arr), aff_a=put(a_arr), aff_b=put(b_arr),
        kmer_ids=put(kid_arr), shift_bits=put(bits), T=put(T_arr),
        N=put(N_arr), bw=put(bw_arr),
        pad=pad, B=B, N_max=N_max, T_pad=t_pad,
    )


def _unpack_shift_bits(bits, T_pad: int):
    """(R, n_bytes) uint8 -> (R, T_pad) int32 of 0/1 shift flags."""
    sh = torch.arange(8, dtype=torch.uint8, device=bits.device)
    b = (bits[:, :, None] >> sh) & 1
    return b.reshape(bits.shape[0], -1)[:, :T_pad].to(torch.int32)


def decode(wire: WireBatch, means_t, c1_t, c2_t, dtype) -> bb.BandedBatch:
    """Wire fields -> the padded batch the kernels read, on the wire's
    device: sig = dac * a + b in `dtype`, band starts as the cumsum of
    the shift bits minus bw, and per-position mu/c1/c2 gathered from the
    k-mer tables, padded by (pad, pad + B)."""
    sig = wire.dacs.to(dtype) * wire.aff_a[:, None].to(dtype) \
        + wire.aff_b[:, None].to(dtype)
    shift = _unpack_shift_bits(wire.shift_bits, wire.T_pad)
    bstart = (torch.cumsum(shift, dim=1) - wire.bw[:, None]).to(torch.int32)
    live = torch.arange(wire.N_max - 1, device=sig.device) < (wire.N[:, None] - 1)
    kid = torch.where(live, wire.kmer_ids, 0).long()
    zero = torch.zeros((), dtype=dtype, device=sig.device)
    gathered = [torch.where(live, tbl[kid], zero) for tbl in (means_t, c1_t, c2_t)]
    mu, c1, c2 = (F.pad(x, (wire.pad, wire.pad + wire.B)) for x in gathered)
    return bb.BandedBatch(sig, mu, c1, c2, bstart, wire.T, wire.N, wire.bw,
                          pad=wire.pad, B=wire.B)


def banded_batch_run_device(wire: WireBatch, means_t, c1_t, c2_t,
                            log_m1: float, log_e2: float,
                            dtype=torch.float32) -> DeviceSegResult:
    """Whole-pipeline device program for one padded bucket."""
    batch = decode(wire, means_t, c1_t, c2_t, dtype)
    Zf, Zb, starts, medians = kk.banded_segment(batch, wire.N_max, log_m1,
                                                log_e2)
    return DeviceSegResult(Zf=Zf, Zb=Zb, starts=starts, medians=medians)


def make_device_fn(means_t, c1_t, c2_t, log_m1: float, log_e2: float):
    """wire -> summaries entry over k-mer tables already resident on the
    device (models/params.params_from_numpy); computes in their dtype."""

    def run(wire: WireBatch) -> DeviceSegResult:
        return banded_batch_run_device(wire, means_t, c1_t, c2_t, log_m1,
                                       log_e2, means_t.dtype)

    return run


def summaries_to_segments(starts_row: np.ndarray, medians_row: np.ndarray,
                          N: int, kmer_size: int):
    """Host formatting: (N_max,) summaries -> reference-ordered segment list
    [(state, basepos, start_t, median_prob)]."""
    half = kmer_size // 2
    idx = np.nonzero(np.asarray(starts_row[1:N]) >= 0)[0] + 1
    sts = np.asarray(starts_row)[idx].tolist()
    probs = np.asarray(medians_row)[idx].tolist()
    bps = (idx - 1 + half).tolist()
    return [("M", bp, st, p) for bp, st, p in zip(bps, sts, probs)]

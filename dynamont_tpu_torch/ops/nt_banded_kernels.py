"""Wrappers of the banded CUDA kernels (counterpart of
dynamont_tpu/ops/nt_banded_pallas.py and the Pallas kernel of
dynamont_tpu/ops/nt_banded_train.py).

Each wrapper sits beside its plain-torch version; the kernels are numbered
as PERF.md's table of the TPU kernels numbers them:

  backward  / backward_plain    K1 banded_bwd        replaces _bwd_kernel
  fwd_vit   / fwd_vit_plain     K2 banded_fwd_vit    replaces _fwd_vit_kernel
  walk      / walk_plain        K3 banded_walk       replaces _walk_kernel
  viterbi_post / viterbi_post_plain
                                K4 banded_vit        replaces _vit_kernel
  forward   / forward_plain     K5 banded_fwd        replaces _fwd_kernel
  backward_train / backward_train_plain
                                K6 banded_bwd_train  replaces _bwd_train_kernel

K1-K4 are in csrc/nt_banded.cu, K5-K6 in csrc/nt_banded_train.cu.

A wrapper runs its plain version for tensors on the CPU, launches its
kernel for CUDA tensors, and raises for anything else
or when the launch fails: there is no fallback from a kernel to its plain
version. LAUNCHES counts kernel launches and PLAIN_RUNS counts plain-
version runs, one per call, so a run can show which route it took.

`banded_segment` is the fused entry the engine calls (bwd -> fwd_vit ->
walk -> grouped medians), returning (Zf, Zb, starts, medians) like
banded_segment_pallas. The matrix route (K5 -> K1 -> K4, the host walk)
is ops/nt_banded_batch.banded_batch_run.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dynamont_tpu_torch import _build
from dynamont_tpu_torch.ops import nt_banded_batch as bb

SEGMENT_KERNELS = ("banded_bwd", "banded_fwd_vit", "banded_walk")
TRAIN_KERNELS = ("banded_fwd", "banded_bwd_train")
MATRIX_KERNELS = ("banded_fwd", "banded_bwd", "banded_vit")
KERNELS = SEGMENT_KERNELS + TRAIN_KERNELS + ("banded_vit",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_RUNS = dict.fromkeys(KERNELS, 0)
MAX_B = 1024  # one thread per band column
SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)
FWD_VIT_MAX_ROWS = 32  # rows per staged chunk of banded_fwd_vit, at most
BWD_MAX_ROWS = 256  # rows per staged chunk of banded_bwd, at most
FWD_MAX_ROWS = 256  # rows per staged chunk of banded_fwd, at most
BWD_TRAIN_MAX_ROWS = 64  # rows per staged chunk of banded_bwd_train, at most
VIT_MAX_ROWS = 32  # rows per staged chunk of banded_vit, at most


class Staging(NamedTuple):
    """Chunks of banded_fwd_vit (K2), banded_bwd (K1) and banded_vit (K4)
    at one band width: rows per chunk and the block's shared memory in
    bytes."""

    fwd_vit_rows: int
    fwd_vit_bytes: int
    bwd_rows: int
    bwd_bytes: int
    vit_rows: int
    vit_bytes: int


def _most_rows(name: str, nbytes, most: int, B: int, itemsize: int) -> int:
    fits = [C for C in range(1, most + 1) if nbytes(C) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"{name}: no chunk fits B={B}, "
                         f"itemsize {itemsize} in {SMEM_LIMIT} bytes")
    return fits[-1]


def staging(B: int, itemsize: int) -> Staging:
    """The chunk geometry K2, K1 and K4 are launched with at band width B
    and element size `itemsize` (4 or 8); each takes the most rows, up to
    FWD_VIT_MAX_ROWS, BWD_MAX_ROWS and VIT_MAX_ROWS, that fit in
    SMEM_LIMIT. The byte counts repeat csrc/nt_banded.cu's
    fwd_vit_smem_bytes, bwd_smem_bytes and vit_smem_bytes. K2 keeps its
    four previous rows and two stages of C rows of bM and bE, a window of
    C + B emission parameters of each of mu/c1/c2, C samples and C + 1
    band starts. K1 keeps its two previous rows and two stages of a
    window of C + B + 2 parameters of each of mu/c1/c2, C samples and
    C + 1 band starts. K4 keeps two stages of C rows of each of fM, fE, bM
    and bE, its two previous Viterbi rows of M and E with two cells at
    each end (a -inf cell beside the band), C 16-byte row records (band
    shift and live columns), an 8-byte mbarrier a stage and two stages of
    C + 1 band starts. (K3's chunk is a constant of the kernel,
    csrc/nt_banded.cu's WALK_ROWS.)"""

    def fwd_vit_bytes(C):
        stage = 2 * C * B + 3 * (B + C) + C
        return (8 * B + 2 * stage) * itemsize + 2 * (C + 1) * 4

    def bwd_bytes(C):
        stage = 3 * (C + B + 2) + C
        return (4 * B + 2 * stage) * itemsize + 2 * (C + 1) * 4

    def vit_bytes(C):
        return (2 * 4 * C * B + 4 * (B + 4)) * itemsize + 16 * C + 16 + 2 * (C + 1) * 4

    C2 = _most_rows("banded_fwd_vit", fwd_vit_bytes, FWD_VIT_MAX_ROWS, B, itemsize)
    C1 = _most_rows("banded_bwd", bwd_bytes, BWD_MAX_ROWS, B, itemsize)
    C4 = _most_rows("banded_vit", vit_bytes, VIT_MAX_ROWS, B, itemsize)
    return Staging(C2, fwd_vit_bytes(C2), C1, bwd_bytes(C1), C4, vit_bytes(C4))


class TrainStaging(NamedTuple):
    """Chunks of banded_fwd (K5) and banded_bwd_train (K6) at one band
    width: rows per chunk and the block's shared memory in bytes."""

    fwd_rows: int
    fwd_bytes: int
    bwd_train_rows: int
    bwd_train_bytes: int


def train_staging(B: int, itemsize: int) -> TrainStaging:
    """The chunk geometry K5 and K6 are launched with at band width B and
    element size `itemsize` (4 or 8); each takes the most rows, up to
    FWD_MAX_ROWS and BWD_TRAIN_MAX_ROWS, that fit in SMEM_LIMIT. The byte
    counts repeat csrc/nt_banded_train.cu's fwd_smem_bytes and
    bwd_train_smem_bytes. K5 keeps its two previous rows and two stages of
    a window of C + B emission parameters of each of mu/c1/c2, C samples
    and C + 1 band starts. K6 keeps its two previous rows, two stages of C
    fE rows, of a window of C + B + 2 parameters of each of mu/c1/c2, of C
    samples and of C + 1 band starts, and its band reduction over P
    entries (B rounded up to a power of two)."""
    P = 1 << (B - 1).bit_length()

    def fwd_bytes(C):
        stage = 3 * (B + C) + C
        return (4 * B + 2 * stage) * itemsize + 2 * (C + 1) * 4

    def bwd_train_bytes(C):
        stage = 3 * (C + B + 2) + C
        return (4 * B + 2 * C * B + 2 * stage + P) * itemsize + 2 * (C + 1) * 4

    C5 = _most_rows("banded_fwd", fwd_bytes, FWD_MAX_ROWS, B, itemsize)
    C6 = _most_rows("banded_bwd_train", bwd_train_bytes, BWD_TRAIN_MAX_ROWS, B,
                    itemsize)
    return TrainStaging(C5, fwd_bytes(C5), C6, bwd_train_bytes(C6))


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_RUNS[k] = 0


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = {
    "nt_banded_bwd": [_P] * 10 + [_I] * 6 + [_D, _D, _P],
    "nt_banded_fwd_vit": [_P] * 15 + [_I] * 6 + [_D, _D, _P],
    "nt_banded_walk": [_P] * 10 + [_I] * 4 + [_P],
    "nt_banded_vit": [_P] * 12 + [_I] * 4 + [_P],
    "nt_banded_fwd": [_P] * 10 + [_I] * 6 + [_D, _D, _P],
    "nt_banded_bwd_train": [_P] * 13 + [_I] * 6 + [_D, _D, _P],
}
_bound: dict = {}


def _entry(name: str, dtype):
    """ctypes function of kernel `name` for `dtype`, with its argtypes."""
    key = f"{name}_{'f32' if dtype == torch.float32 else 'f64'}"
    fn = _bound.get(key)
    if fn is None:
        fn = getattr(_build.load(), key)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _bound[key] = fn
    return fn


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"the kernels run on cuda or cpu, not {t.device}")
    return False


def _check(name: str, dtype, device, **tensors) -> None:
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dtype} is neither float32 nor float64")
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")


def _check_batch(name: str, batch: bb.BandedBatch) -> None:
    dtype = batch.sig.dtype
    _check(name, dtype, batch.sig.device, sig=batch.sig, mu_pad=batch.mu_pad,
           c1_pad=batch.c1_pad, c2_pad=batch.c2_pad, bstart=batch.bstart,
           T=batch.T, N=batch.N, bw=batch.bw)
    for arg in ("mu_pad", "c1_pad", "c2_pad"):
        if getattr(batch, arg).dtype != dtype:
            raise TypeError(f"{name}: {arg} is not {dtype}")
    for arg in ("bstart", "T", "N", "bw"):
        if getattr(batch, arg).dtype != torch.int32:
            raise TypeError(f"{name}: {arg} is not int32")
    if batch.B % 32 or not 0 < batch.B <= MAX_B:
        raise ValueError(f"{name}: band width B={batch.B} must be a multiple "
                         f"of 32 in (0, {MAX_B}]")


def _check_aligned(name: str, **tensors) -> None:
    """The kernels copy these in 16-byte pieces."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} does not start 16-byte aligned")


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaGetLastError() = {rc}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# K1: backward
# ---------------------------------------------------------------------------

def backward_plain(batch: bb.BandedBatch, log_m1: float, log_e2: float):
    PLAIN_RUNS["banded_bwd"] += 1
    return bb.backward(batch, log_m1, log_e2)


def backward(batch: bb.BandedBatch, log_m1: float, log_e2: float):
    """(bM, bE), each (R, T_pad, B). A read whose band start climbs by
    more than a column a row, far enough that a row leaves the kernel's
    staged emission window, gets NaN in row 0, so its Zb is NaN (inputs
    the CLIs refuse; the plain version has no window)."""
    if _on_cpu(batch.sig):
        return backward_plain(batch, log_m1, log_e2)
    _check_batch("banded_bwd", batch)
    R, T_pad = batch.bstart.shape
    bM = torch.empty((R, T_pad, batch.B), dtype=batch.sig.dtype,
                     device=batch.sig.device)
    bE = torch.empty_like(bM)
    rc = _entry("nt_banded_bwd", bM.dtype)(
        _ptr(batch.sig), _ptr(batch.mu_pad), _ptr(batch.c1_pad),
        _ptr(batch.c2_pad), _ptr(batch.bstart), _ptr(batch.T), _ptr(batch.N),
        _ptr(batch.bw), _ptr(bM), _ptr(bE), R, T_pad, batch.mu_pad.shape[1],
        batch.B, batch.pad, staging(batch.B, bM.element_size()).bwd_rows,
        log_m1, log_e2, _stream(bM.device))
    _raise_on("banded_bwd", rc)
    LAUNCHES["banded_bwd"] += 1
    return bM, bE


# ---------------------------------------------------------------------------
# K2: fused forward + posterior + Viterbi
# ---------------------------------------------------------------------------

def fwd_vit_plain(batch: bb.BandedBatch, bM, bE, Zb, log_m1: float,
                  log_e2: float):
    PLAIN_RUNS["banded_fwd_vit"] += 1
    return bb.fwd_vit(batch, bM, bE, Zb, log_m1, log_e2)


def fwd_vit(batch: bb.BandedBatch, bM, bE, Zb, log_m1: float, log_e2: float):
    """(ch uint8, LPM, LPE, Zf) from the backward rows and Zb."""
    if _on_cpu(batch.sig):
        return fwd_vit_plain(batch, bM, bE, Zb, log_m1, log_e2)
    _check_batch("banded_fwd_vit", batch)
    dtype = batch.sig.dtype
    _check("banded_fwd_vit", dtype, batch.sig.device, bM=bM, bE=bE, Zb=Zb)
    R, T_pad = batch.bstart.shape
    if bM.shape != (R, T_pad, batch.B) or bE.shape != bM.shape \
            or Zb.shape != (R,) or {bM.dtype, bE.dtype, Zb.dtype} != {dtype}:
        raise ValueError("banded_fwd_vit: bM/bE/Zb do not match the batch")
    _check_aligned("banded_fwd_vit", bM=bM, bE=bE)
    ch = torch.empty(bM.shape, dtype=torch.uint8, device=bM.device)
    LPM = torch.empty_like(bM)
    LPE = torch.empty_like(bM)
    Zf = torch.full((R,), float("-inf"), dtype=dtype, device=bM.device)
    rc = _entry("nt_banded_fwd_vit", dtype)(
        _ptr(batch.sig), _ptr(batch.mu_pad), _ptr(batch.c1_pad),
        _ptr(batch.c2_pad), _ptr(batch.bstart), _ptr(batch.T), _ptr(batch.N),
        _ptr(batch.bw), _ptr(bM), _ptr(bE), _ptr(Zb), _ptr(ch), _ptr(LPM),
        _ptr(LPE), _ptr(Zf), R, T_pad, batch.mu_pad.shape[1], batch.B,
        batch.pad, staging(batch.B, bM.element_size()).fwd_vit_rows, log_m1,
        log_e2, _stream(bM.device))
    _raise_on("banded_fwd_vit", rc)
    LAUNCHES["banded_fwd_vit"] += 1
    return ch, LPM, LPE, Zf


# ---------------------------------------------------------------------------
# K3: traceback walk
# ---------------------------------------------------------------------------

def walk_plain(LPM, LPE, ch, batch: bb.BandedBatch, N_max: int):
    PLAIN_RUNS["banded_walk"] += 1
    return bb.walk(LPM, LPE, ch, batch, N_max)


def walk(LPM, LPE, ch, batch: bb.BandedBatch, N_max: int):
    """(path_n int32, prob, close bool), each (R, T_pad-1)."""
    if _on_cpu(LPM):
        return walk_plain(LPM, LPE, ch, batch, N_max)
    dtype = LPM.dtype
    _check("banded_walk", dtype, LPM.device, LPM=LPM, LPE=LPE, ch=ch,
           bstart=batch.bstart, T=batch.T, N=batch.N, bw=batch.bw)
    R, T_pad, B = LPM.shape
    if LPE.shape != LPM.shape or ch.shape != LPM.shape \
            or LPE.dtype != dtype or ch.dtype != torch.uint8 \
            or batch.bstart.shape != (R, T_pad):
        raise ValueError("banded_walk: LPM/LPE/ch do not match the batch")
    if B % 32 or not 0 < B <= MAX_B:
        raise ValueError(f"banded_walk: band width B={B} must be a multiple "
                         f"of 32 in (0, {MAX_B}]")
    _check_aligned("banded_walk", ch=ch)
    path_n = torch.empty((R, T_pad - 1), dtype=torch.int32, device=LPM.device)
    prob = torch.empty((R, T_pad - 1), dtype=dtype, device=LPM.device)
    close = torch.empty((R, T_pad - 1), dtype=torch.uint8, device=LPM.device)
    rc = _entry("nt_banded_walk", dtype)(
        _ptr(LPM), _ptr(LPE), _ptr(ch), _ptr(batch.bstart), _ptr(batch.T),
        _ptr(batch.N), _ptr(batch.bw), _ptr(path_n), _ptr(prob), _ptr(close),
        R, T_pad, B, N_max, _stream(LPM.device))
    _raise_on("banded_walk", rc)
    LAUNCHES["banded_walk"] += 1
    return path_n, prob, close.bool()


# ---------------------------------------------------------------------------
# K4: posteriors + Viterbi over stored forward and backward rows
# ---------------------------------------------------------------------------

def viterbi_post_plain(batch: bb.BandedBatch, fM, fE, bM, bE, Zb):
    PLAIN_RUNS["banded_vit"] += 1
    return bb.viterbi_post(batch, fM, fE, bM, bE, Zb)


def viterbi_post(batch: bb.BandedBatch, fM, fE, bM, bE, Zb):
    """(ch uint8, LPM, LPE), each (R, T_pad, B), from the stored forward
    and backward rows and Zb; the kernel stages the four rows in chunks of
    staging(B, itemsize).vit_rows rows."""
    if _on_cpu(fM):
        return viterbi_post_plain(batch, fM, fE, bM, bE, Zb)
    _check_batch("banded_vit", batch)
    dtype = batch.sig.dtype
    _check("banded_vit", dtype, batch.sig.device, fM=fM, fE=fE, bM=bM, bE=bE,
           Zb=Zb)
    R, T_pad = batch.bstart.shape
    if any(x.shape != (R, T_pad, batch.B) or x.dtype != dtype
           for x in (fM, fE, bM, bE)) or Zb.shape != (R,) or Zb.dtype != dtype:
        raise ValueError("banded_vit: fM/fE/bM/bE/Zb do not match the batch")
    _check_aligned("banded_vit", fM=fM, fE=fE, bM=bM, bE=bE)
    ch = torch.empty(fM.shape, dtype=torch.uint8, device=fM.device)
    LPM = torch.empty_like(fM)
    LPE = torch.empty_like(fM)
    rc = _entry("nt_banded_vit", dtype)(
        _ptr(fM), _ptr(fE), _ptr(bM), _ptr(bE), _ptr(Zb), _ptr(batch.bstart),
        _ptr(batch.T), _ptr(batch.N), _ptr(batch.bw), _ptr(ch), _ptr(LPM),
        _ptr(LPE), R, T_pad, batch.B,
        staging(batch.B, fM.element_size()).vit_rows, _stream(fM.device))
    _raise_on("banded_vit", rc)
    LAUNCHES["banded_vit"] += 1
    return ch, LPM, LPE


# ---------------------------------------------------------------------------
# K5: forward, every row stored
# ---------------------------------------------------------------------------

def forward_plain(batch: bb.BandedBatch, log_m1: float, log_e2: float):
    PLAIN_RUNS["banded_fwd"] += 1
    return bb.forward(batch, log_m1, log_e2)


def forward(batch: bb.BandedBatch, log_m1: float, log_e2: float):
    """(fM, fE), each (R, T_pad, B); rows t >= T are -inf. A read whose
    band start climbs by more than a column a row, far enough that a row
    leaves the kernel's staged emission window, gets NaN in fE's row T-1,
    so its Zf is NaN (inputs the CLIs refuse; the plain version has no
    window)."""
    if _on_cpu(batch.sig):
        return forward_plain(batch, log_m1, log_e2)
    _check_batch("banded_fwd", batch)
    R, T_pad = batch.bstart.shape
    fM = torch.empty((R, T_pad, batch.B), dtype=batch.sig.dtype,
                     device=batch.sig.device)
    fE = torch.empty_like(fM)
    rc = _entry("nt_banded_fwd", fM.dtype)(
        _ptr(batch.sig), _ptr(batch.mu_pad), _ptr(batch.c1_pad),
        _ptr(batch.c2_pad), _ptr(batch.bstart), _ptr(batch.T), _ptr(batch.N),
        _ptr(batch.bw), _ptr(fM), _ptr(fE), R, T_pad, batch.mu_pad.shape[1],
        batch.B, batch.pad, train_staging(batch.B, fM.element_size()).fwd_rows,
        log_m1, log_e2, _stream(fM.device))
    _raise_on("banded_fwd", rc)
    LAUNCHES["banded_fwd"] += 1
    return fM, fE


# ---------------------------------------------------------------------------
# K6: backward fused with the m1/e2 transition numerators
# ---------------------------------------------------------------------------

def backward_train_plain(batch: bb.BandedBatch, fE, log_m1: float,
                         log_e2: float):
    PLAIN_RUNS["banded_bwd_train"] += 1
    return bb.backward_train(batch, fE, log_m1, log_e2)


def backward_train(batch: bb.BandedBatch, fE, log_m1: float, log_e2: float):
    """(bM, bE, rawM1, rawE2): the backward rows, each (R, T_pad, B), and
    the per-read log numerators of m1 and e2, each (R,). A read whose band
    start leaves the kernel's staged emission window (as in `backward`)
    gets NaN in row 0 of bM and bE, so its Zb is NaN."""
    if _on_cpu(batch.sig):
        return backward_train_plain(batch, fE, log_m1, log_e2)
    _check_batch("banded_bwd_train", batch)
    dtype = batch.sig.dtype
    _check("banded_bwd_train", dtype, batch.sig.device, fE=fE)
    R, T_pad = batch.bstart.shape
    if fE.shape != (R, T_pad, batch.B) or fE.dtype != dtype:
        raise ValueError("banded_bwd_train: fE does not match the batch")
    _check_aligned("banded_bwd_train", fE=fE)
    bM = torch.empty_like(fE)
    bE = torch.empty_like(fE)
    rawM1 = torch.empty((R,), dtype=dtype, device=fE.device)
    rawE2 = torch.empty_like(rawM1)
    rc = _entry("nt_banded_bwd_train", dtype)(
        _ptr(batch.sig), _ptr(batch.mu_pad), _ptr(batch.c1_pad),
        _ptr(batch.c2_pad), _ptr(batch.bstart), _ptr(batch.T), _ptr(batch.N),
        _ptr(batch.bw), _ptr(fE), _ptr(bM), _ptr(bE), _ptr(rawM1),
        _ptr(rawE2), R, T_pad, batch.mu_pad.shape[1], batch.B, batch.pad,
        train_staging(batch.B, fE.element_size()).bwd_train_rows, log_m1,
        log_e2, _stream(fE.device))
    _raise_on("banded_bwd_train", rc)
    LAUNCHES["banded_bwd_train"] += 1
    return bM, bE, rawM1, rawE2


def banded_segment(batch: bb.BandedBatch, N_max: int, log_m1: float,
                   log_e2: float):
    """Fused entry: backward (its row 0 yields Zb) -> forward + posterior +
    Viterbi -> walk -> grouped medians. Returns (Zf, Zb, starts, medians),
    starts (R, N_max) int32 with -1 for no segment."""
    bM, bE = backward(batch, log_m1, log_e2)
    r = torch.arange(bM.shape[0], device=bM.device)
    Zb = bE[r, 0, batch.bw.long() + 1]
    ch, LPM, LPE, Zf = fwd_vit(batch, bM, bE, Zb, log_m1, log_e2)
    del bM, bE
    path_n, prob, close = walk(LPM, LPE, ch, batch, N_max)
    starts, medians = bb.path_summaries(path_n, prob, close, N_max)
    return Zf, Zb, starts, medians

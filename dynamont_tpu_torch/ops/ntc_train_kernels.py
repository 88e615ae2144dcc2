"""Wrappers of the NTC training CUDA kernels (counterpart of
dynamont_tpu/ops/ntc_pallas.py, its Baum-Welch kernels) and their plain
versions:

  fwd_store / fwd_store_plain  K17 ntc_fwd_store  replaces _fwd_kernel
  train     / train_plain      K18 ntc_train      replaces _train_kernel

The kernels are in csrc/ntc_train.cu, in float and double. As in
ops/ntc_kernels.py, a wrapper runs its plain version for tensors on the
CPU, launches its kernel for CUDA tensors, and raises for anything else or
when the launch fails; LAUNCHES and PLAIN_RUNS count one per call. The
plain versions are ops/ntc_batch.ntc_forward_store_batch and
ntc_train_batch; the kernels repeat their arithmetic op for op.

Each kernel has two instances, picked by shape (fwd_store_instance,
train_instance): "shared" (fwd_store_shared_kernel, train_shared_kernel:
the columns and the staged row inputs in shared memory; the main rung) or
"device" (fwd_store_kernel, train_kernel: the previous column read back
from device memory; every other shape). FWD_STORE_LAUNCHES and
TRAIN_LAUNCHES count the launches by instance.

Layouts (one bucket of R reads, T_pad rows, CN n-slots, CK k-slots, K
k-mers; plan, dims, prm, sig and tl as in ops/ntc_kernels.py):

  fwd    (T_pad, R, 5, CN, CK)  the forward store
  Z      (R,)                   the normalizer of the moments (Zf)
  tacc   (13, R, CN, CK)        per-cell term sums, ntc_batch.TERMS order
  em     (R, 3, K)              k-mer moment sums [w, w*d, w*d*d]
  b0     (R, 5, CN, CK)         the backward store's row 0
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dynamont_tpu_torch import _build
from dynamont_tpu_torch.ops import ntc_batch as nb
from dynamont_tpu_torch.ops.nt_banded_kernels import (
    SMEM_LIMIT, _check, _check_aligned, _on_cpu, _ptr, _raise_on, _stream,
)
from dynamont_tpu_torch.ops.ntc_kernels import _al16, _check_dims, _check_plan, tl_tensor
from dynamont_tpu_torch.ops.ntc_pre_kernels import _check_ints, threads
from dynamont_tpu_torch.parallel.mesh import on_device

KERNELS = ("ntc_fwd_store", "ntc_train")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_RUNS = dict.fromkeys(KERNELS, 0)
# launches by instance: "shared" columns or "device"
FWD_STORE_LAUNCHES = {"shared": 0, "device": 0}
TRAIN_LAUNCHES = {"shared": 0, "device": 0}
NTERMS = len(nb.TERMS)


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_RUNS[k] = 0
    for counts in (FWD_STORE_LAUNCHES, TRAIN_LAUNCHES):
        for k in counts:
            counts[k] = 0


class Instance(NamedTuple):
    """Which kernel K17 or K18 launches at one shape: "shared" or "device"
    (module docstring); `nbytes` is that kernel's shared memory, and
    `fwd_staged` whether train_shared_kernel stages the forward rows and
    keeps the 13 accumulators in shared memory (its fp32 layout at the
    main rung; fp64 reads both from device memory)."""

    name: str
    nbytes: int
    fwd_staged: bool = False


def _staged_ok(CN: int, CK: int) -> bool:
    """The shared instances copy rows in 16-byte pieces (hd and allowed: NC
    a multiple of 16; the int and float rows: CN and CK multiples of 4),
    and K17 leaves its prefetch to the NT - CK threads phase 2 leaves
    idle."""
    NC = CN * CK
    return NC % 16 == 0 and CN % 4 == 0 and CK % 4 == 0 and threads(NC) > CK


def fwd_store_instance(CN: int, CK: int, A: int, itemsize: int) -> Instance:
    """K17's instance at CN n-slots, CK k-slots, alphabet A and element size
    `itemsize`: the shared one where _staged_ok and its bytes fit
    SMEM_LIMIT, else the device one. The byte counts repeat
    csrc/ntc_train.cu's fwd_store_shared_bytes (two columns 5 x NC, the
    score NC, the I-chain flags NC bytes, two stages of pv_stage_bytes:
    cand_n, row_same, row_prev CN int32 each, col_same CK and col_prec A*CK
    int32, hd NC int16, allowed NC bytes, mu_k/c1_k/c2_k 3*CK, the n-slots'
    3*CN and the sample) and fwd_store's device size."""
    NC = CN * CK
    stage = (_al16((3 * CN + CK + A * CK) * 4) + _al16(NC * 2) + _al16(NC)
             + _al16((3 * CK + 3 * CN + 1) * itemsize))
    shared = 11 * NC * itemsize + _al16(NC) + 2 * stage
    if _staged_ok(CN, CK) and shared <= SMEM_LIMIT:
        return Instance("shared", shared)
    return Instance("device", 2 * NC * itemsize + NC)


def train_instance(CN: int, CK: int, A: int, itemsize: int) -> Instance:
    """K18's instance at CN n-slots, CK k-slots, alphabet A and element size
    `itemsize`: the shared one where _staged_ok, CK is a multiple of 32 and
    at most half the threads (the moments' k-slots run on the NT - CK
    threads phase 2 leaves idle, which meet at a barrier of their own) and
    its bytes fit SMEM_LIMIT, with the forward rows staged and the
    accumulators in shared memory where that fits (fwd_staged); else the
    device one. The byte counts repeat csrc/ntc_train.cu's
    train_shared_bytes: two columns (5 x NC), train_column's scratch (4 x
    NC values and NC flags, and without fwd_staged the forward E and I, 2 x
    NC), with fwd_staged the 13 accumulators (13 x NC), the moments' w (NC),
    three slots of a staged row (ops/ntc_probe_kernels.stage_bytes at C = 1),
    live (CK bytes) and ks (CK int32), with fwd_staged its forward column (5
    x NC), and the slots' three mbarriers; and train's device sizes."""
    NC = CN * CK
    scratch = _al16(4 * NC * itemsize + NC)
    stage = (_al16((3 * CK + 3 * A * CK + 6 * CN + 2) * itemsize)
             + _al16((3 * CN + CK + A * CK) * 4) + _al16(NC * 2)
             + _al16(NC + 2 * CN) + _al16(CK) + _al16(CK * 4))
    if _staged_ok(CN, CK) and CK % 32 == 0 and threads(NC) >= 2 * CK:
        for staged in (True, False):
            nbytes = (10 * NC * itemsize + scratch
                      + (NTERMS * NC * itemsize if staged else 2 * NC * itemsize)
                      + NC * itemsize + 3 * (stage + (5 * NC * itemsize if staged else 0))
                      + _al16(3 * 8))
            if nbytes <= SMEM_LIMIT:
                return Instance("shared", nbytes, staged)
    base = scratch + 2 * NC * itemsize
    with_acc = base + NTERMS * NC * itemsize
    return Instance("device", with_acc if with_acc <= SMEM_LIMIT else base)


def _pick(name: str, pick, dims, itemsize: int, instance: str | None) -> str:
    """The instance to launch: the picker's, or `instance` where the
    wrapper can run it at this shape (the device one always)."""
    picked = pick(dims.CN, dims.CK, dims.A, itemsize).name
    if instance is None or instance == picked:
        return picked
    if instance != "device":
        raise ValueError(f"{name}: instance {instance!r} does not run at {dims} "
                         f"with itemsize {itemsize} (the picker gives {picked!r})")
    return instance


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "ntc_fwd_store": [_P] * 14 + [_I] * 7 + [_P],
    "ntc_train": [_P] * 26 + [_I] * 8 + [_P],
}
_bound: dict = {}


def _entry(name: str, dtype):
    key = f"{name}_{'f32' if dtype == torch.float32 else 'f64'}"
    fn = _bound.get(key)
    if fn is None:
        fn = getattr(_build.load(), key)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _bound[key] = fn
    return fn


def _check_inputs(name: str, plan, dims, prm, sig, **tensors) -> None:
    dtype, dev = sig.dtype, sig.device
    _check(name, dtype, dev, sig=sig, **tensors, **prm._asdict())
    _check_dims(name, dims)
    _check_plan(name, plan, sig.shape[1] + 1, dims, dev)
    if any(x.dtype != dtype for x in prm):
        raise TypeError(f"{name}: the gathered parameters are not {dtype}")


# ---------------------------------------------------------------------------
# K17: the forward store
# ---------------------------------------------------------------------------

def fwd_store_plain(plan, dims, prm, sig, trans_log: dict):
    PLAIN_RUNS["ntc_fwd_store"] += 1
    return nb.ntc_forward_store_batch(plan, dims, prm, sig, trans_log)


def fwd_store(plan: nb.NTCPlan, dims: nb.PlanDims, prm: nb.NTCParams, sig,
              trans_log: dict, instance: str | None = None):
    """The forward store (T_pad, R, 5, CN, CK). `instance` (default: the
    picker's, fwd_store_instance) names the kernel to launch."""
    if _on_cpu(sig):
        return fwd_store_plain(plan, dims, prm, sig, trans_log)
    name = "ntc_fwd_store"
    dtype, dev = sig.dtype, sig.device
    R, CN, CK, A = dims
    T_pad = sig.shape[1] + 1
    _check_inputs(name, plan, dims, prm, sig)
    inst = _pick(name, fwd_store_instance, dims, sig.element_size(), instance)
    if inst == "shared":
        p = plan
        _check_aligned(name, cand_n=p.cand_n, allowed=p.allowed, hd=p.hd,
                       row_same=p.row_same, row_prev=p.row_prev, col_same=p.col_same,
                       col_prec=p.col_prec, mu_k=prm.mu_k, c1_k=prm.c1_k,
                       c2_k=prm.c2_k, nsl=prm.nsl)
    out = torch.empty((T_pad, R, 5, CN, CK), dtype=dtype, device=dev)
    tl = tl_tensor(trans_log, dtype, dev)
    p = plan
    with on_device(dev):
        rc = _entry(name, dtype)(
            _ptr(sig), _ptr(p.cand_n), _ptr(p.allowed), _ptr(p.hd),
            _ptr(p.row_same), _ptr(p.row_prev), _ptr(p.col_same), _ptr(p.col_prec),
            _ptr(prm.mu_k), _ptr(prm.c1_k), _ptr(prm.c2_k), _ptr(prm.nsl),
            _ptr(tl), _ptr(out), R, T_pad, CN, CK, A, threads(CN * CK),
            int(inst == "shared"), _stream(dev))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    FWD_STORE_LAUNCHES[inst] += 1
    return out


# ---------------------------------------------------------------------------
# K18: the backward recurrence with the training sums
# ---------------------------------------------------------------------------

def train_plain(plan, dims, prm, sig, fwd, Z, trans_log: dict, N_r, T_r,
                K: int, bwd_out=None):
    PLAIN_RUNS["ntc_train"] += 1
    return nb.ntc_train_batch(plan, dims, prm, sig, fwd, Z, trans_log, N_r,
                              T_r, K, bwd_out=bwd_out)


def train(plan: nb.NTCPlan, dims: nb.PlanDims, prm: nb.NTCParams, sig, fwd,
          Z, trans_log: dict, N_r, T_r, K: int, instance: str | None = None):
    """(tacc (13, R, CN, CK), em (R, 3, K), b0 (R, 5, CN, CK)) from the
    forward store `fwd` and Z (R,). `instance` (default: the picker's,
    train_instance) names the kernel to launch."""
    if _on_cpu(sig):
        return train_plain(plan, dims, prm, sig, fwd, Z, trans_log, N_r, T_r, K)
    name = "ntc_train"
    dtype, dev = sig.dtype, sig.device
    R, CN, CK, A = dims
    T_pad = sig.shape[1] + 1
    _check_inputs(name, plan, dims, prm, sig, fwd=fwd, Z=Z, N_r=N_r, T_r=T_r,
                  live=plan.live, ks=plan.ks)
    _check_ints(name, N_r=N_r, T_r=T_r, ks=plan.ks)
    if (fwd.shape != (T_pad, R, 5, CN, CK) or Z.shape != (R,)
            or plan.live.shape != (T_pad, R, CK) or plan.ks.shape != plan.live.shape):
        raise ValueError(f"{name}: fwd/Z/live/ks do not match {dims} at T_pad {T_pad}")
    if fwd.dtype != dtype or Z.dtype != dtype or plan.live.dtype != torch.bool:
        raise TypeError(f"{name}: fwd and Z must be {dtype}, live bool")
    inst = _pick(name, train_instance, dims, sig.element_size(), instance)
    if inst == "shared":
        p = plan
        _check_aligned(name, cand_n=p.cand_n, allowed=p.allowed, hd=p.hd, d01=p.d01,
                       d02=p.d02, brow_same=p.brow_same, brow_next=p.brow_next,
                       bcol_same=p.bcol_same, bcol_suc=p.bcol_suc, live=p.live,
                       ks=p.ks, fwd=fwd, **prm._asdict())
    tacc = torch.empty((NTERMS, R, CN, CK), dtype=dtype, device=dev)
    em = torch.empty((R, 3, K), dtype=dtype, device=dev)
    b0 = torch.empty((R, 5, CN, CK), dtype=dtype, device=dev)
    # the device instance's per-read double buffer of columns
    scratch = torch.empty((R, 2, 5, CN, CK) if inst == "device" else (0,),
                          dtype=dtype, device=dev)
    tl = tl_tensor(trans_log, dtype, dev)
    p = plan
    with on_device(dev):
        rc = _entry(name, dtype)(
            _ptr(sig), _ptr(p.cand_n), _ptr(p.allowed), _ptr(p.hd), _ptr(p.d01),
            _ptr(p.d02), _ptr(p.brow_same), _ptr(p.brow_next), _ptr(p.bcol_same),
            _ptr(p.bcol_suc), _ptr(p.live), _ptr(p.ks), _ptr(prm.mu_k),
            _ptr(prm.c1_k), _ptr(prm.c2_k), _ptr(prm.suc), _ptr(prm.nsl), _ptr(tl),
            _ptr(N_r), _ptr(T_r), _ptr(fwd), _ptr(Z), _ptr(tacc), _ptr(em),
            _ptr(b0), _ptr(scratch), R, T_pad, CN, CK, A, K, threads(CN * CK),
            int(inst == "shared"), _stream(dev))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    TRAIN_LAUNCHES[inst] += 1
    return tacc, em, b0

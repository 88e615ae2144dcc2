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

import torch

from dynamont_tpu_torch import _build
from dynamont_tpu_torch.ops import ntc_batch as nb
from dynamont_tpu_torch.ops.nt_banded_kernels import (
    _check, _on_cpu, _ptr, _raise_on, _stream,
)
from dynamont_tpu_torch.ops.ntc_kernels import _check_dims, _check_plan, tl_tensor
from dynamont_tpu_torch.ops.ntc_pre_kernels import _check_ints, threads

KERNELS = ("ntc_fwd_store", "ntc_train")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_RUNS = dict.fromkeys(KERNELS, 0)


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_RUNS[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "ntc_fwd_store": [_P] * 14 + [_I] * 6 + [_P],
    "ntc_train": [_P] * 26 + [_I] * 7 + [_P],
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
              trans_log: dict):
    """The forward store (T_pad, R, 5, CN, CK)."""
    if _on_cpu(sig):
        return fwd_store_plain(plan, dims, prm, sig, trans_log)
    name = "ntc_fwd_store"
    dtype, dev = sig.dtype, sig.device
    R, CN, CK, A = dims
    T_pad = sig.shape[1] + 1
    _check_inputs(name, plan, dims, prm, sig)
    out = torch.empty((T_pad, R, 5, CN, CK), dtype=dtype, device=dev)
    tl = tl_tensor(trans_log, dtype, dev)
    p = plan
    rc = _entry(name, dtype)(
        _ptr(sig), _ptr(p.cand_n), _ptr(p.allowed), _ptr(p.hd),
        _ptr(p.row_same), _ptr(p.row_prev), _ptr(p.col_same), _ptr(p.col_prec),
        _ptr(prm.mu_k), _ptr(prm.c1_k), _ptr(prm.c2_k), _ptr(prm.nsl),
        _ptr(tl), _ptr(out), R, T_pad, CN, CK, A, threads(CN * CK),
        _stream(dev))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
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
          Z, trans_log: dict, N_r, T_r, K: int):
    """(tacc (13, R, CN, CK), em (R, 3, K), b0 (R, 5, CN, CK)) from the
    forward store `fwd` and Z (R,)."""
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
    tacc = torch.empty((len(nb.TERMS), R, CN, CK), dtype=dtype, device=dev)
    em = torch.empty((R, 3, K), dtype=dtype, device=dev)
    b0 = torch.empty((R, 5, CN, CK), dtype=dtype, device=dev)
    scratch = torch.empty((R, 2, 5, CN, CK), dtype=dtype, device=dev)
    tl = tl_tensor(trans_log, dtype, dev)
    p = plan
    rc = _entry(name, dtype)(
        _ptr(sig), _ptr(p.cand_n), _ptr(p.allowed), _ptr(p.hd), _ptr(p.d01),
        _ptr(p.d02), _ptr(p.brow_same), _ptr(p.brow_next), _ptr(p.bcol_same),
        _ptr(p.bcol_suc), _ptr(p.live), _ptr(p.ks), _ptr(prm.mu_k),
        _ptr(prm.c1_k), _ptr(prm.c2_k), _ptr(prm.suc), _ptr(prm.nsl), _ptr(tl),
        _ptr(N_r), _ptr(T_r), _ptr(fwd), _ptr(Z), _ptr(tacc), _ptr(em),
        _ptr(b0), _ptr(scratch), R, T_pad, CN, CK, A, K, threads(CN * CK),
        _stream(dev))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return tacc, em, b0

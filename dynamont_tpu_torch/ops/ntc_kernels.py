"""Wrappers of the NTC lattice CUDA kernels (counterpart of
dynamont_tpu/ops/ntc_pallas.py, its segmentation kernels) and their plain
versions:

  tab_gather / tab_gather_plain  K11 ntc_tab_gather  replaces _tab_gather_packs_kernel
  table_gather / table_gather_plain
                                 #12 ntc_table_gather replaces _tab_gather_kernel
  bwd        / bwd_plain         K13 ntc_bwd         replaces _bwd_kernel
                                 (two instances, bwd_instance)
  bwd_ckpt   / bwd_ckpt_plain    K14 ntc_bwd_ckpt    replaces _bwd_ckpt_kernel
                                 (two instances, bwd_ckpt_instance)
  pv         / pv_plain          K15 ntc_pv          replaces _pv_kernel
                                 (two instances, pv_instance)
  pv_ckpt    / pv_ckpt_plain     K15 ntc_pv_ckpt     its checkpoint branch
                                 (two instances, pv_ckpt_instance)
  walk       / walk_plain        K16 ntc_walk        replaces _walk_kernel
                                 (rows staged in chunks; two instances,
                                 walk_geometry)

The kernels are in csrc/ntc_lattice.cu, in float and double (#12 in float
only, as its TPU kernel). As in
ops/ntc_pre_kernels.py, a wrapper runs its plain version for tensors on the
CPU, launches its kernel for CUDA tensors, and raises for anything else or
when the launch fails; LAUNCHES and PLAIN_RUNS count one per call. The
plain versions are ops/ntc_batch.ntc_backward_batch,
ntc_backward_ckpt_batch, ntc_posterior_viterbi_batch (its checkpoint mode
for pv_ckpt) and ops/ntc_walk.walk_records_plain; the kernels repeat their
arithmetic op for op.

Layouts (one bucket of R reads, T_pad rows, CN n-slots, CK k-slots, A = 4):

  plan        ops/ntc_batch.NTCPlan, every field (T_pad, R, ...)
  ks          (T_pad, R*CK + 2*R*CN) int32  k-slot values | kN | kN2
  table       (3 + 3A, K)               mu, c1, c2, then the A successors' mu, c1, c2
  tabT        (16, K) float32           table, then a row of zeros (#12)
  out         (T, 16, J) float32        tabT[:, ks[t, j]] at out[t, :, j] (#12)
  prm         ops/ntc_batch.NTCParams   K11's outputs
  sig         (R, T_pad-1)              signal
  tl          (13,)                     log transitions in ntc_batch.TL_KEYS order
  bwd, lp     (T_pad, R, 5, CN, CK)     backward store; posteriors (may share bwd's buffer)
  ckpt        (T_pad/C, R, 5, CN, CK)   backward row (c+1)*C entering chunk c, -inf
                                        for the last (C = ntc_batch.C_CKPT)
  row0        (R, 5, CN, CK)            backward row 0
  choices     (T_pad, R, CN, CK) int16  Viterbi choice word
  slots       (T_pad, R, CN, CK) int32  predecessor-slot word
  apEf, fwdEf (R, CN, CK)               Viterbi and forward E at row T_r-1
  rec         (T_pad, N_MICRO, R, 8)    walk records (ops/ntc_walk.NREC fields)
  fin         (R, 2) int32              segments emitted, stuck
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dynamont_tpu_torch import _build
from dynamont_tpu_torch.ops import ntc_batch as nb
from dynamont_tpu_torch.ops import ntc_walk as nw
from dynamont_tpu_torch.ops.nt_banded_kernels import (
    SMEM_LIMIT, _check, _check_aligned, _on_cpu, _ptr, _raise_on, _stream,
)
from dynamont_tpu_torch.ops.ntc_pre_kernels import _check_ints, threads
from dynamont_tpu_torch.parallel.mesh import on_device

LATTICE_KERNELS = ("ntc_tab_gather", "ntc_bwd", "ntc_bwd_ckpt", "ntc_pv",
                   "ntc_pv_ckpt", "ntc_walk")
KERNELS = LATTICE_KERNELS + ("ntc_table_gather",)  # #12 lies on no path
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_RUNS = dict.fromkeys(KERNELS, 0)
# ntc_pv's launches by instance (pv_instance): "shared" columns or "device"
PV_LAUNCHES = {"shared": 0, "device": 0}
# ntc_bwd's launches by instance (bwd_instance), the same two names
BWD_LAUNCHES = {"shared": 0, "device": 0}
# ntc_bwd_ckpt's and ntc_pv_ckpt's launches by instance (bwd_ckpt_instance,
# pv_ckpt_instance): a thread block "cluster" a read, or one block ("device")
BWD_CKPT_LAUNCHES = {"cluster": 0, "device": 0}
PV_CKPT_LAUNCHES = {"cluster": 0, "device": 0}
# ntc_walk's launches by instance (walk_geometry): tensor copies or cp.async
WALK_LAUNCHES = {"tma": 0, "copy": 0}


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_RUNS[k] = 0
    for counts in (PV_LAUNCHES, BWD_LAUNCHES, BWD_CKPT_LAUNCHES, PV_CKPT_LAUNCHES,
                   WALK_LAUNCHES):
        for k in counts:
            counts[k] = 0


class PvInstance(NamedTuple):
    """Which kernel ntc_pv's full-store mode launches at one shape:
    "shared" (csrc/ntc_lattice.cu pv_shared_kernel, its columns, the
    backward column and two stages of plan inputs in shared memory) or
    "device" (pv_kernel<S, false>, the columns in a per-read device-memory
    double buffer); `shared_bytes` is what the shared instance would take."""

    name: str
    shared_bytes: int


def _al16(b: int) -> int:
    return (b + 15) & ~15


def pv_instance(CN: int, CK: int, A: int, itemsize: int) -> PvInstance:
    """ntc_pv's instance at CN n-slots, CK k-slots, alphabet A and element
    size `itemsize`: the shared one where NC = CN*CK is a multiple of 16
    (it copies hd, allowed and the backward column in 16-byte pieces) and
    its bytes fit SMEM_LIMIT; the device-memory one otherwise. The byte
    count repeats csrc/ntc_lattice.cu's pv_shared_bytes: the four columns
    and the backward column (5 x NC each), in fp32 the column's lp (5 x NC)
    and the block reduction's 32 + NT values, the choice words (NC int16),
    and two stages of row inputs (cand_n, row_same, row_prev: CN int32
    each; col_same CK and col_prec A*CK int32; hd NC int16; allowed NC
    bytes; mu_k/c1_k/c2_k 3*CK, the n-slots' 3*CN and the sample)."""
    NC = CN * CK
    col = 5 * NC * itemsize
    norm = col + _al16((32 + threads(NC)) * itemsize) if itemsize == 4 else 0
    stage = (_al16((3 * CN + CK + A * CK) * 4) + _al16(NC * 2) + _al16(NC)
             + _al16((3 * CK + 3 * CN + 1) * itemsize))
    nbytes = 5 * col + norm + _al16(NC * 2) + 2 * stage
    fits = NC % 16 == 0 and nbytes <= SMEM_LIMIT
    return PvInstance("shared" if fits else "device", nbytes)


class BwdInstance(NamedTuple):
    """Which kernel ntc_bwd launches at one shape: "shared"
    (csrc/ntc_lattice.cu bwd_shared_kernel: rows t + 1 and t, the phase 1
    -> 2 scratch and two stages of row inputs in shared memory) or "device"
    (bwd_kernel: row t + 1 read back from the device store); `nbytes` is
    the chosen kernel's shared memory."""

    name: str
    nbytes: int


def bwd_instance(CN: int, CK: int, A: int, itemsize: int) -> BwdInstance:
    """ntc_bwd's instance at CN n-slots, CK k-slots, alphabet A and element
    size `itemsize`: the shared one where NC = CN*CK is a multiple of 16,
    CN and CK multiples of 4 (its 16-byte copies of every row input, 4-byte
    ones of d01 and d02) and its bytes fit SMEM_LIMIT; the device-memory
    one otherwise. The byte counts repeat csrc/ntc_lattice.cu's
    bwd_shared_bytes and bwd_smem: two columns (5 x NC each), the phase 1
    -> 2 scratch (4 x NC values and NC flags), and two stages of one row's
    inputs (stage_bytes at C = 1: mu_k/c1_k/c2_k 3*CK, suc 3*A*CK, the
    n-slots' 6*CN and two samples; cand_n, brow_same, brow_next CN int32
    each, bcol_same CK and bcol_suc A*CK int32; hd NC int16; allowed NC,
    d01 and d02 CN bytes each)."""
    NC = CN * CK
    scratch = 4 * NC * itemsize + NC
    stage = (_al16((3 * CK + 3 * A * CK + 6 * CN + 2) * itemsize)
             + _al16((3 * CN + CK + A * CK) * 4) + _al16(NC * 2)
             + _al16(NC + 2 * CN))
    shared = 2 * 5 * NC * itemsize + _al16(scratch) + 2 * stage
    if NC % 16 == 0 and CN % 4 == 0 and CK % 4 == 0 and shared <= SMEM_LIMIT:
        return BwdInstance("shared", shared)
    return BwdInstance("device", scratch)


class CkptInstance(NamedTuple):
    """Which kernel ntc_bwd_ckpt or ntc_pv_ckpt launches at one shape:
    "cluster" (csrc/ntc_lattice.cu bwd_ckpt_cluster_kernel,
    pv_ckpt_cluster_kernel: one read on a cluster of G CTAs, each holding
    the columns' slice of CK / G k-slots in shared memory) or "device"
    (bwd_ckpt_kernel, pv_kernel<S, true>: one block a read, the columns in
    device memory; G = 1); `nbytes` is the cluster instance's shared
    memory a CTA (0 for "device")."""

    name: str
    G: int
    nbytes: int


# the cluster sizes the pickers try, in order: 8 is portable, 16 needs the
# non-portable cluster attribute (the kernels' launcher sets it), 4 serves
# the narrow shapes neither takes
CLUSTER_SIZES = (8, 16, 4)


def cluster_threads(CN: int, KS: int) -> int:
    """Threads of one CTA of a cluster instance: one per slice cell, whole
    warps, at most MAX_THREADS (the kernels loop over the rest)."""
    return min(-(-CN * KS // 32) * 32, 512)


def slice_row_bytes(CN: int, KS: int, A: int, itemsize: int) -> int:
    """csrc/ntc_lattice.cu's slice_row_bytes: one row's staged inputs for a
    slice of KS k-slots (each region 16-byte aligned): two samples,
    mu_k/c1_k/c2_k (3 KS), the successors' parameters (3 A KS) and the
    n-slots' (6 CN) in the working dtype; cand_n, brow_same, brow_next,
    row_same, row_prev (5 CN), bcol_same, col_same (2 KS), bcol_suc,
    col_prec (2 A KS) int32; hd (CN KS) int16; allowed (CN KS), d01 and
    d02 (2 CN) bytes."""
    return (_al16((2 + 3 * KS + 3 * A * KS + 6 * CN) * itemsize)
            + _al16((5 * CN + 2 * KS + 2 * A * KS) * 4) + _al16(CN * KS * 2)
            + _al16(CN * KS + 2 * CN))


def bwd_ckpt_cluster_bytes(CN: int, KS: int, A: int, itemsize: int) -> int:
    """csrc/ntc_lattice.cu's bwd_ckpt_cluster_bytes: rows t + 1 and t of a
    slice of CN x KS cells (5 states each), bwd_column's scratch over the
    slice (4 values and a flag a cell) and two staged rows."""
    LNC = CN * KS
    return (_al16(2 * 5 * LNC * itemsize) + _al16(4 * LNC * itemsize + LNC)
            + 2 * slice_row_bytes(CN, KS, A, itemsize))


def pv_ckpt_cluster_bytes(CN: int, KS: int, A: int, itemsize: int, C: int) -> int:
    """csrc/ntc_lattice.cu's pv_ckpt_cluster_bytes: the four forward and
    Viterbi columns' slices and the chunk's C re-derived backward rows with
    its checkpoint (4 + C + 1 slices of 5 x CN x KS values), in fp32 four
    rows' lp (4 slices), the reduction area (55 values), the larger of
    bwd_column's scratch and phase 1 -> 2's (score, choice word and flag a
    cell), and the chunk's C staged rows."""
    LNC = CN * KS
    lcol = 5 * LNC * itemsize
    bwd = 4 * LNC * itemsize + LNC
    fwd = LNC * (itemsize + 2 + 1)
    return ((4 + C + 1) * lcol + (4 * lcol if itemsize == 4 else 0)
            + _al16(55 * itemsize) + _al16(max(bwd, fwd))
            + C * slice_row_bytes(CN, KS, A, itemsize))


def bwd_ckpt_instance(CN: int, CK: int, A: int, itemsize: int,
                      G: int | None = None) -> CkptInstance:
    """ntc_bwd_ckpt's instance at CN n-slots, CK k-slots, alphabet A and
    element size `itemsize`: the cluster one at the first G of
    CLUSTER_SIZES (or the given G) that divides CK with at least 2
    k-slots a CTA and whose bytes fit SMEM_LIMIT; bwd_ckpt_kernel where
    none does (or G = 1)."""
    for g in CLUSTER_SIZES if G is None else (G,):
        if g > 1 and CK % g == 0 and CK // g >= 2:
            nbytes = bwd_ckpt_cluster_bytes(CN, CK // g, A, itemsize)
            if nbytes <= SMEM_LIMIT:
                return CkptInstance("cluster", g, nbytes)
        if G is not None and G != 1:
            raise ValueError(f"ntc_bwd_ckpt: no cluster of {G} at CN {CN}, CK {CK}")
    return CkptInstance("device", 1, 0)


def pv_ckpt_instance(CN: int, CK: int, A: int, itemsize: int,
                     G: int | None = None) -> CkptInstance:
    """ntc_pv_ckpt's instance at CN n-slots, CK k-slots, alphabet A and
    element size `itemsize`: the cluster one at the first G of
    CLUSTER_SIZES (or the given G) that divides CK, whose bytes fit
    SMEM_LIMIT and, in fp32, under which the column's normalization keeps
    block_sum's order locally: CK divides B = threads(CN*CK) (then virtual
    thread b's cells all lie in k-slot b mod CK), B > 32 and the slice's
    KS = CK / G k-slots are a multiple of 32 (then each virtual warp lies
    in one CTA), and the threads phase 2 leaves free (all but KS), which
    run the normalization, hold a warp and the CTA's B / CK * KS virtual
    threads; pv_kernel<S, true> where none does (or G = 1), e.g. fp32 at
    CK 272, where B = 256."""
    B = threads(CN * CK)
    for g in CLUSTER_SIZES if G is None else (G,):
        if g > 1 and CK % g == 0:
            KS = CK // g
            local = itemsize != 4 or (
                B % CK == 0 and B > 32 and KS % 32 == 0
                and cluster_threads(CN, KS) - KS >= max(B // CK * KS, 32))
            nbytes = pv_ckpt_cluster_bytes(CN, KS, A, itemsize, nb.C_CKPT)
            if local and nbytes <= SMEM_LIMIT:
                return CkptInstance("cluster", g, nbytes)
        if G is not None and G != 1:
            raise ValueError(f"ntc_pv_ckpt: no cluster of {G} at CN {CN}, CK {CK}, "
                             f"itemsize {itemsize}")
    return CkptInstance("device", 1, 0)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "ntc_tab_gather": [_P] * 7 + [_I] * 6 + [_P],
    "ntc_table_gather": [_P] * 3 + [_I] * 3 + [_P],
    "ntc_bwd": [_P] * 19 + [_I] * 7 + [_P],
    "ntc_bwd_ckpt": [_P] * 21 + [_I] * 7 + [_P],
    "ntc_pv": [_P] * 22 + [_I] * 8 + [_P],
    "ntc_pv_ckpt": [_P] * 31 + [_I] * 8 + [_P],
    "ntc_bwd_ckpt_cluster": [_P] * 20 + [_I] * 8 + [_P],
    "ntc_pv_ckpt_cluster": [_P] * 29 + [_I] * 9 + [_P],
    "ntc_ckpt_cluster_fit": [_I] * 7 + [_P],
    "ntc_walk": [_P] * 13 + [_I] * 10 + [_P],
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


def tl_tensor(trans_log: dict, dtype, device):
    return torch.tensor([trans_log[k] for k in nb.TL_KEYS], dtype=dtype,
                        device=device)


def _check_dims(name: str, dims: nb.PlanDims) -> None:
    if dims.A != 4:
        raise ValueError(f"{name}: the kernels take an alphabet of 4, not {dims.A}")


def _check_plan(name: str, plan: nb.NTCPlan, T_pad: int, dims: nb.PlanDims,
                device) -> None:
    R, CN, CK, A = dims
    shapes = {"cand_n": (R, CN), "allowed": (R, CN, CK), "hd": (R, CN, CK),
              "d01": (R, CN), "d02": (R, CN), "row_same": (R, CN),
              "row_prev": (R, CN), "brow_same": (R, CN), "brow_next": (R, CN),
              "col_same": (R, CK), "bcol_same": (R, CK),
              "col_prec": (R, A, CK), "bcol_suc": (R, A, CK)}
    dtypes = {"allowed": torch.bool, "hd": torch.int16, "d01": torch.int8,
              "d02": torch.int8}
    for f, sh in shapes.items():
        x = getattr(plan, f)
        if tuple(x.shape) != (T_pad, *sh):
            raise ValueError(f"{name}: plan.{f} {tuple(x.shape)} is not {(T_pad, *sh)}")
        if x.dtype != dtypes.get(f, torch.int32):
            raise TypeError(f"{name}: plan.{f} is {x.dtype}")
        if x.device != device or not x.is_contiguous():
            raise ValueError(f"{name}: plan.{f} must be contiguous on {device}")


# ---------------------------------------------------------------------------
# K11: model parameters into the plan's slots
# ---------------------------------------------------------------------------

def tab_gather_plain(ks, table, dims: nb.PlanDims) -> nb.NTCParams:
    PLAIN_RUNS["ntc_tab_gather"] += 1
    R, CN, CK, A = dims
    T = ks.shape[0]
    K = table.shape[1]
    live = (ks >= 0) & (ks < K)
    g = torch.where(live, table[:, ks.clamp(0, K - 1).long()], 0.0)
    k_part = g[:, :, :R * CK].reshape(-1, T, R, CK)
    suc = torch.stack([
        torch.cat([k_part[3 + s * A + a] for a in range(A)], dim=2)
        for s in range(3)], dim=1)
    return nb.NTCParams(
        mu_k=k_part[0].contiguous(), c1_k=k_part[1].contiguous(),
        c2_k=k_part[2].contiguous(), suc=suc.contiguous(),
        nsl=g[:3, :, R * CK:].permute(1, 0, 2).contiguous())


def tab_gather(ks, table, dims: nb.PlanDims) -> nb.NTCParams:
    """NTCParams from the index rows `ks` (ntc_batch.gather_index) and the
    table (ntc_batch.combined_tables); dead slots (ks = K) read 0."""
    if _on_cpu(ks):
        return tab_gather_plain(ks, table, dims)
    name = "ntc_tab_gather"
    dtype = table.dtype
    _check(name, dtype, ks.device, ks=ks, table=table)
    _check_ints(name, ks=ks)
    _check_dims(name, dims)
    R, CN, CK, A = dims
    T, J = ks.shape
    K = table.shape[1]
    if J != R * CK + 2 * R * CN or table.shape[0] != 3 + 3 * A:
        raise ValueError(f"{name}: ks {tuple(ks.shape)} / table "
                         f"{tuple(table.shape)} do not match {dims}")
    e = lambda *sh: torch.empty(sh, dtype=dtype, device=ks.device)
    prm = nb.NTCParams(mu_k=e(T, R, CK), c1_k=e(T, R, CK), c2_k=e(T, R, CK),
                       suc=e(T, 3, R, A * CK), nsl=e(T, 3, 2 * R * CN))
    with on_device(ks.device):
        rc = _entry(name, dtype)(
            _ptr(ks), _ptr(table), *(_ptr(x) for x in prm), T, R, CN, CK, A, K,
            _stream(ks.device))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return prm


# ---------------------------------------------------------------------------
# #12: the stacked table rows at k-mer indices, without the pack layout
# ---------------------------------------------------------------------------

def table_gather_plain(ks, tabT):
    PLAIN_RUNS["ntc_table_gather"] += 1
    K = tabT.shape[1]
    live = (ks >= 0) & (ks < K)
    g = torch.where(live, tabT[:, ks.clamp(0, K - 1).long()], 0.0)
    return g.permute(1, 0, 2).contiguous()


def table_gather(ks, tabT):
    """out (T, 16, J) float32 with out[t, :, j] = tabT[:, ks[t, j]] and 0
    where ks is outside [0, K); ks (T, J) int32, tabT (16, K) float32
    (ntc_batch.combined_tablesT)."""
    if _on_cpu(ks):
        return table_gather_plain(ks, tabT)
    name = "ntc_table_gather"
    _check(name, torch.float32, ks.device, ks=ks, tabT=tabT)
    _check_ints(name, ks=ks)
    if tabT.dtype != torch.float32 or tabT.shape[0] != nb.TG_ROWS \
            or ks.dim() != 2:
        raise ValueError(f"{name}: ks {tuple(ks.shape)} / tabT "
                         f"{tuple(tabT.shape)} {tabT.dtype}: want (T, J) and "
                         f"({nb.TG_ROWS}, K) float32")
    T, J = ks.shape
    out = torch.empty((T, nb.TG_ROWS, J), dtype=torch.float32, device=ks.device)
    with on_device(ks.device):
        rc = _entry(name, torch.float32)(_ptr(ks), _ptr(tabT), _ptr(out), T, J,
                                         tabT.shape[1], _stream(ks.device))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# K13: the backward lattice
# ---------------------------------------------------------------------------

def bwd_plain(plan, dims, prm, sig, trans_log: dict, N_r, T_r):
    PLAIN_RUNS["ntc_bwd"] += 1
    return nb.ntc_backward_batch(plan, dims, prm, sig, trans_log, N_r, T_r)


def _check_bwd_inputs(name: str, plan, dims, prm, sig, N_r, T_r) -> int:
    """Checks of what the backward kernels read; returns T_pad."""
    T_pad = sig.shape[1] + 1
    _check(name, sig.dtype, sig.device, sig=sig, N_r=N_r, T_r=T_r, **prm._asdict())
    _check_ints(name, N_r=N_r, T_r=T_r)
    _check_dims(name, dims)
    _check_plan(name, plan, T_pad, dims, sig.device)
    if any(x.dtype != sig.dtype for x in prm):
        raise TypeError(f"{name}: the gathered parameters are not {sig.dtype}")
    return T_pad


def _bwd_ptrs(plan: nb.NTCPlan, prm: nb.NTCParams, sig) -> tuple:
    """The pointers of bwd_column's inputs, in the kernels' order."""
    p = plan
    return (_ptr(sig), _ptr(p.cand_n), _ptr(p.allowed), _ptr(p.hd), _ptr(p.d01),
            _ptr(p.d02), _ptr(p.brow_same), _ptr(p.brow_next), _ptr(p.bcol_same),
            _ptr(p.bcol_suc), _ptr(prm.mu_k), _ptr(prm.c1_k), _ptr(prm.c2_k),
            _ptr(prm.suc), _ptr(prm.nsl))


def bwd(plan: nb.NTCPlan, dims: nb.PlanDims, prm: nb.NTCParams, sig,
        trans_log: dict, N_r, T_r):
    """The backward store (T_pad, R, 5, CN, CK)."""
    if _on_cpu(sig):
        return bwd_plain(plan, dims, prm, sig, trans_log, N_r, T_r)
    name = "ntc_bwd"
    dtype, dev = sig.dtype, sig.device
    R, CN, CK, A = dims
    T_pad = _check_bwd_inputs(name, plan, dims, prm, sig, N_r, T_r)
    out = torch.empty((T_pad, R, 5, CN, CK), dtype=dtype, device=dev)
    inst = bwd_instance(CN, CK, A, sig.element_size()).name
    if inst == "shared":
        p = plan
        _check_aligned(name, cand_n=p.cand_n, allowed=p.allowed,
                       hd=p.hd, d01=p.d01, d02=p.d02, brow_same=p.brow_same,
                       brow_next=p.brow_next, bcol_same=p.bcol_same,
                       bcol_suc=p.bcol_suc, **prm._asdict())
    tl = tl_tensor(trans_log, dtype, dev)
    with on_device(dev):
        rc = _entry(name, dtype)(
            *_bwd_ptrs(plan, prm, sig), _ptr(tl), _ptr(N_r), _ptr(T_r),
            _ptr(out), R, T_pad, CN, CK, A, threads(CN * CK),
            int(inst == "shared"), _stream(dev))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    BWD_LAUNCHES[inst] += 1
    return out


# ---------------------------------------------------------------------------
# K14: the checkpointed backward lattice
# ---------------------------------------------------------------------------

def bwd_ckpt_plain(plan, dims, prm, sig, trans_log: dict, N_r, T_r):
    PLAIN_RUNS["ntc_bwd_ckpt"] += 1
    return nb.ntc_backward_ckpt_batch(plan, dims, prm, sig, trans_log, N_r, T_r)


def _check_chunks(name: str, T_pad: int) -> None:
    if T_pad % nb.C_CKPT:
        raise ValueError(f"{name}: T_pad {T_pad} is not a multiple of {nb.C_CKPT}")


def bwd_ckpt(plan: nb.NTCPlan, dims: nb.PlanDims, prm: nb.NTCParams, sig,
             trans_log: dict, N_r, T_r, G: int | None = None):
    """(ckpt (T_pad/C, R, 5, CN, CK), row0 (R, 5, CN, CK)): the backward
    store's row (c+1)*C entering each chunk c of C = ntc_batch.C_CKPT rows
    (-inf for the last chunk), and its row 0. The instance is
    bwd_ckpt_instance's for the shape, or G's (1: the one-block kernel;
    for timing the alternatives)."""
    if _on_cpu(sig):
        return bwd_ckpt_plain(plan, dims, prm, sig, trans_log, N_r, T_r)
    name = "ntc_bwd_ckpt"
    dtype, dev = sig.dtype, sig.device
    R, CN, CK, A = dims
    T_pad = _check_bwd_inputs(name, plan, dims, prm, sig, N_r, T_r)
    _check_chunks(name, T_pad)
    C = nb.C_CKPT
    inst = bwd_ckpt_instance(CN, CK, A, sig.element_size(), G)
    ckpt = torch.empty((T_pad // C, R, 5, CN, CK), dtype=dtype, device=dev)
    row0 = torch.empty((R, 5, CN, CK), dtype=dtype, device=dev)
    tl = tl_tensor(trans_log, dtype, dev)
    head = (*_bwd_ptrs(plan, prm, sig), _ptr(tl), _ptr(N_r), _ptr(T_r), _ptr(ckpt),
            _ptr(row0))
    if inst.name == "cluster":
        _check_aligned(name, hd=plan.hd, allowed=plan.allowed, d01=plan.d01, d02=plan.d02)
        with on_device(dev):
            rc = _entry("ntc_bwd_ckpt_cluster", dtype)(
                *head, R, T_pad, CN, CK, A, inst.G, cluster_threads(CN, CK // inst.G), C,
                _stream(dev))
    else:
        scratch = torch.empty((R, 2, 5, CN, CK), dtype=dtype, device=dev)
        with on_device(dev):
            rc = _entry(name, dtype)(*head, _ptr(scratch), R, T_pad, CN, CK, A,
                                     threads(CN * CK), C, _stream(dev))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    BWD_CKPT_LAUNCHES[inst.name] += 1
    return ckpt, row0


# ---------------------------------------------------------------------------
# K15: forward, posteriors, Viterbi choices and predecessor slots
# ---------------------------------------------------------------------------

def pv_plain(plan, dims, prm, sig, bwd_store, Z_norm, trans_log: dict, T_r,
             out=None, fwd_out=None):
    PLAIN_RUNS["ntc_pv"] += 1
    return nb.ntc_posterior_viterbi_batch(plan, dims, prm, sig, bwd_store,
                                          Z_norm, trans_log, T_r, out=out,
                                          fwd_out=fwd_out)


def pv(plan: nb.NTCPlan, dims: nb.PlanDims, prm: nb.NTCParams, sig,
       bwd_store, Z_norm, trans_log: dict, T_r, out=None):
    """(lp, choices, slots, apE_final, fwdE_final); lp goes into `out`
    when given, which may be bwd_store itself (lp written over it)."""
    if _on_cpu(sig):
        return pv_plain(plan, dims, prm, sig, bwd_store, Z_norm, trans_log,
                        T_r, out=out)
    name = "ntc_pv"
    dtype, dev = sig.dtype, sig.device
    R, CN, CK, A = dims
    T_pad = sig.shape[1] + 1
    _check(name, dtype, dev, sig=sig, bwd_store=bwd_store, Z_norm=Z_norm,
           T_r=T_r, **prm._asdict())
    _check_ints(name, T_r=T_r)
    _check_dims(name, dims)
    _check_plan(name, plan, T_pad, dims, dev)
    if bwd_store.shape != (T_pad, R, 5, CN, CK) or Z_norm.shape != (R,):
        raise ValueError(f"{name}: bwd_store/Z_norm do not match {dims}")
    if any(x.dtype != dtype for x in (*prm, bwd_store, Z_norm)):
        raise TypeError(f"{name}: every float input must be {dtype}")
    lp = torch.empty_like(bwd_store) if out is None else out
    if lp.shape != bwd_store.shape or lp.dtype != dtype or not lp.is_contiguous():
        raise ValueError(f"{name}: out must be a contiguous {dtype} like bwd_store")
    choices = torch.empty((T_pad, R, CN, CK), dtype=torch.int16, device=dev)
    slots = torch.empty((T_pad, R, CN, CK), dtype=torch.int32, device=dev)
    apEf = torch.empty((R, CN, CK), dtype=dtype, device=dev)
    fwdEf = torch.empty_like(apEf)
    inst = pv_instance(CN, CK, A, bwd_store.element_size()).name
    p = plan
    if inst == "shared":
        _check_aligned(name, hd=p.hd, allowed=p.allowed, bwd_store=bwd_store)
        scratch = None
    else:
        scratch = torch.empty((R, 4, 5, CN, CK), dtype=dtype, device=dev)
    tl = tl_tensor(trans_log, dtype, dev)
    with on_device(dev):
        rc = _entry(name, dtype)(
            _ptr(sig), _ptr(p.cand_n), _ptr(p.allowed), _ptr(p.hd),
            _ptr(p.row_same), _ptr(p.row_prev), _ptr(p.col_same), _ptr(p.col_prec),
            _ptr(prm.mu_k), _ptr(prm.c1_k), _ptr(prm.c2_k), _ptr(prm.nsl),
            _ptr(tl), _ptr(Z_norm), _ptr(T_r), _ptr(bwd_store), _ptr(lp),
            _ptr(choices), _ptr(slots), _ptr(apEf), _ptr(fwdEf),
            None if scratch is None else _ptr(scratch), R, T_pad, CN, CK, A,
            threads(CN * CK), nb.slot_bits(CK), int(inst == "shared"), _stream(dev))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    PV_LAUNCHES[inst] += 1
    return lp, choices, slots, apEf, fwdEf


def pv_ckpt_plain(plan, dims, prm, sig, ckpt, Z_norm, trans_log: dict, N_r,
                  T_r):
    PLAIN_RUNS["ntc_pv_ckpt"] += 1
    return nb.ntc_posterior_viterbi_batch(plan, dims, prm, sig, None, Z_norm,
                                          trans_log, T_r, ckpt=ckpt, N_r=N_r)


def pv_ckpt(plan: nb.NTCPlan, dims: nb.PlanDims, prm: nb.NTCParams, sig,
            ckpt, Z_norm, trans_log: dict, N_r, T_r, G: int | None = None):
    """pv's outputs from bwd_ckpt's checkpoints: each chunk's backward rows
    re-derived in the kernel; lp in a buffer of its own. The instance is
    pv_ckpt_instance's for the shape, or G's (1: the one-block kernel)."""
    if _on_cpu(sig):
        return pv_ckpt_plain(plan, dims, prm, sig, ckpt, Z_norm, trans_log,
                             N_r, T_r)
    name = "ntc_pv_ckpt"
    dtype, dev = sig.dtype, sig.device
    R, CN, CK, A = dims
    T_pad = _check_bwd_inputs(name, plan, dims, prm, sig, N_r, T_r)
    _check_chunks(name, T_pad)
    C = nb.C_CKPT
    _check(name, dtype, dev, ckpt=ckpt, Z_norm=Z_norm)
    if ckpt.shape != (T_pad // C, R, 5, CN, CK) or Z_norm.shape != (R,):
        raise ValueError(f"{name}: ckpt/Z_norm do not match {dims}")
    if ckpt.dtype != dtype or Z_norm.dtype != dtype:
        raise TypeError(f"{name}: every float input must be {dtype}")
    lp = torch.empty((T_pad, R, 5, CN, CK), dtype=dtype, device=dev)
    choices = torch.empty((T_pad, R, CN, CK), dtype=torch.int16, device=dev)
    slots = torch.empty((T_pad, R, CN, CK), dtype=torch.int32, device=dev)
    apEf = torch.empty((R, CN, CK), dtype=dtype, device=dev)
    fwdEf = torch.empty_like(apEf)
    inst = pv_ckpt_instance(CN, CK, A, sig.element_size(), G)
    tl = tl_tensor(trans_log, dtype, dev)
    p = plan
    head = (*_bwd_ptrs(plan, prm, sig), _ptr(p.row_same), _ptr(p.row_prev),
            _ptr(p.col_same), _ptr(p.col_prec), _ptr(tl), _ptr(Z_norm), _ptr(N_r),
            _ptr(T_r), _ptr(ckpt), _ptr(lp), _ptr(choices), _ptr(slots),
            _ptr(apEf), _ptr(fwdEf))
    if inst.name == "cluster":
        _check_aligned(name, hd=p.hd, allowed=p.allowed, d01=p.d01, d02=p.d02)
        with on_device(dev):
            rc = _entry("ntc_pv_ckpt_cluster", dtype)(
                *head, R, T_pad, CN, CK, A, inst.G, cluster_threads(CN, CK // inst.G),
                nb.slot_bits(CK), C, _stream(dev))
    else:
        scratch = torch.empty((R, 4, 5, CN, CK), dtype=dtype, device=dev)
        bbuf = torch.empty((R, C, 5, CN, CK), dtype=dtype, device=dev)
        with on_device(dev):
            rc = _entry(name, dtype)(
                *head, _ptr(scratch), _ptr(bbuf), R, T_pad, CN, CK, A, threads(CN * CK),
                nb.slot_bits(CK), C, _stream(dev))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    PV_CKPT_LAUNCHES[inst.name] += 1
    return lp, choices, slots, apEf, fwdEf


def ckpt_cluster_fit(kernel: str, dims: nb.PlanDims, itemsize: int, G: int) -> int:
    """How many clusters of G CTAs of `kernel`'s ("ntc_bwd_ckpt" or
    "ntc_pv_ckpt") cluster instance fit the card at once at `dims`
    (cudaOccupancyMaxActiveClusters); the kernels' launches refuse a shape
    where this is 0."""
    _, CN, CK, A = dims
    out = ctypes.c_int(0)
    rc = _entry("ntc_ckpt_cluster_fit", torch.float32 if itemsize == 4 else torch.float64)(
        int(kernel == "ntc_pv_ckpt"), CN, CK, A, G, cluster_threads(CN, CK // G),
        nb.C_CKPT, ctypes.byref(out))
    _raise_on(kernel, rc)
    return out.value


# ---------------------------------------------------------------------------
# K16: the traceback walk
# ---------------------------------------------------------------------------

WALK_MAX_ROWS = 64  # csrc/ntc_lattice.cu NTC_WALK_MAX_ROWS: rows a staged chunk, at most


class WalkGeometry(NamedTuple):
    """K16's launch at CN n-slots and CK k-slots (csrc/ntc_lattice.cu
    walk_rows, walk_tma): `rows` (C) staged a chunk, `row_bytes` of one
    (t, read)'s staged arrays, `nbytes` of shared memory the block takes,
    and the instance that stages them: "tma" (a tensor copy of each array
    a chunk) or "copy" (cp.async by a warp's lanes)."""
    rows: int
    row_bytes: int
    nbytes: int
    instance: str


def _al128(b: int) -> int:
    return (b + 127) & ~127


def _walk_smem(CN: int, CK: int, NM: int, C: int) -> int:
    """csrc/ntc_lattice.cu walk_smem_bytes: two stages of C rows (each
    array's rows one 128-byte aligned block), two chunks of C * NM 16-byte
    records, two 8-byte mbarriers."""
    NC = CN * CK
    stage = _al128(C * NC * 2) + _al128(C * NC * 4) + 2 * _al128(C * CN * 4)
    return 2 * stage + 2 * C * NM * 16 + 16


def _row_tma(nbytes: int) -> bool:
    """csrc/ntc_lattice.cu walk_row_tma: a row the tensor copies take."""
    w = nbytes // 8
    return nbytes % 16 == 0 and (w <= 256 or w % 256 == 0)


def walk_geometry(CN: int, CK: int) -> WalkGeometry:
    """K16's chunk at (CN, CK), as csrc/ntc_lattice.cu counts it: a staged
    row holds choices (NC int16), slots (NC int32), row_same and row_prev
    (CN int32 each); C, the most rows up to WALK_MAX_ROWS whose two stages
    and records fit SMEM_LIMIT. The same at every dtype (lp is gathered
    from device memory). Raises ValueError where not one row fits."""
    NM, NC = nw.n_micro(CN), CN * CK
    C = next((c for c in range(WALK_MAX_ROWS, 0, -1)
              if _walk_smem(CN, CK, NM, c) <= SMEM_LIMIT), 0)
    if C < 1:
        raise ValueError(f"ntc_walk: two stages of one row at CN {CN}, CK {CK} "
                         f"take {_walk_smem(CN, CK, NM, 1)} B, more than the "
                         f"block's {SMEM_LIMIT}")
    tma = _row_tma(2 * NC) and _row_tma(4 * NC) and _row_tma(4 * CN)
    return WalkGeometry(C, 6 * NC + 8 * CN, _walk_smem(CN, CK, NM, C),
                        "tma" if tma else "copy")


def walk_plain(lp, choices, slots, plan, i0, j0, k0, valid, N_r, T_r, K: int,
               A: int, kmer_size: int, S_max: int):
    PLAIN_RUNS["ntc_walk"] += 1
    return nw.walk_records_plain(lp, choices, slots, plan.row_same,
                                 plan.row_prev, i0, j0, k0, valid, N_r, T_r,
                                 K, A, kmer_size, S_max)


def walk(lp, choices, slots, plan: nb.NTCPlan, i0, j0, k0, valid, N_r, T_r,
         K: int, A: int, kmer_size: int, S_max: int):
    """(rec (T_pad, N_MICRO, R, 8), fin (R, 2) int32): the walk's records,
    for ops/ntc_walk.finish_records (kernel walk_kernel, its rows staged in
    chunks of walk_geometry's C)."""
    if _on_cpu(lp):
        return walk_plain(lp, choices, slots, plan, i0, j0, k0, valid, N_r,
                          T_r, K, A, kmer_size, S_max)
    name = "ntc_walk"
    dtype, dev = lp.dtype, lp.device
    T_pad, R, _, CN, CK = lp.shape
    _check(name, dtype, dev, lp=lp, choices=choices, slots=slots,
           row_same=plan.row_same, row_prev=plan.row_prev, i0=i0, j0=j0,
           k0=k0, valid=valid, N_r=N_r, T_r=T_r)
    _check_ints(name, slots=slots, row_same=plan.row_same,
                row_prev=plan.row_prev, i0=i0, j0=j0, k0=k0, N_r=N_r, T_r=T_r)
    if (choices.dtype != torch.int16 or valid.dtype != torch.bool
            or choices.shape != (T_pad, R, CN, CK) or slots.shape != choices.shape
            or plan.row_same.shape != (T_pad, R, CN) or A != 4):
        raise ValueError(f"{name}: inputs do not match lp {tuple(lp.shape)}")
    geo = walk_geometry(CN, CK)  # raises for a shape whose rows cannot be staged
    if geo.instance == "tma":  # the tensor copies' global addresses
        _check_aligned(name, choices=choices, slots=slots, row_same=plan.row_same,
                       row_prev=plan.row_prev)
    NM = nw.n_micro(CN)
    rec = torch.empty((T_pad, NM, R, nw.NREC), dtype=dtype, device=dev)
    fin = torch.empty((R, 2), dtype=torch.int32, device=dev)
    with on_device(dev):
        rc = _entry(name, dtype)(
            _ptr(lp), _ptr(choices), _ptr(slots), _ptr(plan.row_same),
            _ptr(plan.row_prev), _ptr(i0), _ptr(j0), _ptr(k0), _ptr(valid),
            _ptr(N_r), _ptr(T_r), _ptr(rec), _ptr(fin), R, T_pad, CN, CK, A, K,
            kmer_size // 2, S_max, NM, nb.slot_bits(CK), _stream(dev))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    WALK_LAUNCHES[geo.instance] += 1
    return rec, fin

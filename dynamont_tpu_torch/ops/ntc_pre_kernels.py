"""Wrappers of the NTC pre-pass CUDA kernels (counterpart of
dynamont_tpu/ops/ntc_pre_pallas.py) and their plain-torch versions:

  tn_fwd     / tn_fwd_plain      K7  ntc_tn_fwd      replaces _tn_fwd_kernel
  tn_bwd_sel / tn_bwd_sel_plain  K8  ntc_tn_bwd_sel  replaces _tn_bwd_kernel,
                                 two kernels: tn_bwd_u / tn_bwd_u_plain (the
                                 chain) and tn_sel / tn_sel_plain (the
                                 selection)
  tk_bwd     / tk_bwd_plain      K9  ntc_tk_bwd      replaces _tk_bwd_kernel
  tk_fwd_u   / tk_fwd_u_plain    K10 ntc_tk_fwd_u    replaces _tk_fwd_kernel

The kernels are in csrc/ntc_pre.cu, in float and double. As in
ops/nt_banded_kernels.py, a wrapper runs its plain version for tensors on
the CPU, launches its kernel for CUDA tensors, and raises for anything else
or when the launch fails; LAUNCHES and PLAIN_RUNS count one per call.

Layouts (one bucket of R reads, T_pad lattice rows, row t of the forward
uses sig[t-1], of the backward sig[t]; the rows past a read's T are dead):

  sig     (R, T_pad-1)        signal
  tab     (3, R, N2-1)        TN tables per k-mer position: mu, 1/sd, 2 log sd
  kid     (R, N2-1) int32     k-mer ids, 0 past the read
  tabk    (3, K)              TK tables per k-mer: mu, c1, c2
  N_r,T_r (R,) int32          per-read lattice sizes
  fwd     (T_pad, 2, R, N2)   TN forward store (M, E)
  pack    (T_pad, R, 4cap+2)  per TN column: the top-cap values | their
                              indices | kid at index-1 | kid at index
                              (clipped to [0, N2-2]) | max | mass
  E0      (R, N2)             TN backward E row 0 (Zb = E0[:, 0])
  u       (T_pad, R, N2)      K8's u store between its two kernels:
                              logaddexp(fwd_M + M, fwd_E + E) of the TN
                              backward (M, E)
  bwd     (T_pad, 2, R, K)    TK backward store (M, E)
  U       (T_pad, R, K)       TK combined log-posteriors, unnormalized
  finalE  (R, K)              TK forward E at row T_r-1 (Zf)

K7 gives each thread 4 (or 8) columns of the TN row, contiguous in fp32
and strided in fp64 (tn_fwd_geometry, tn_fwd_layout, tn_fwd_columns);
K8's chain keeps B = threads(N2) threads, thread b owning columns b, b+B,
... .

K9 and K10 give each thread one k-mer group (tk_geometry): the A columns
that share one successor group (K9) or one predecessor class (K10), so
each group's logsumexp is computed once a row; tk_columns lists each
thread's columns. They take A = 4 and K <= BIG_K (4096).

The mass in the pack is sum(exp(u - max)) over the column, added in a
fixed order that the kernel and its plain version share: thread b of a
block of B threads owns columns b, b+B, b+2B, ... and sums them in that
order; the partial sums then add as pairwise trees (element i gets
element i+h for h = W/2, ..., 1), first within each warp of 32 threads,
then over the warp sums. B = threads(N2). The top-cap takes the maximum
`cap` times, ties to the lowest index, and masks it.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from dynamont_tpu_torch import _build
from dynamont_tpu_torch.ops.nt_banded_kernels import (
    SMEM_LIMIT, _check, _check_aligned, _on_cpu, _ptr, _raise_on, _stream,
)
from dynamont_tpu_torch.ops.ntc_pre import _prec_sum, _suc_sum
from dynamont_tpu_torch.utils.logmath import log_normal_pdf_c

KERNELS = ("ntc_tn_fwd", "ntc_tn_bwd_sel", "ntc_tk_bwd", "ntc_tk_fwd_u")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_RUNS = dict.fromkeys(KERNELS, 0)
# ntc_tn_bwd_sel's two kernels, launches of each
TN_BWD_SEL_LAUNCHES = {"tn_bwd_u": 0, "tn_sel": 0}
MAX_THREADS = 512  # csrc/ntc_pre.cu __launch_bounds__
MAX_COLS = 8  # columns per thread (registers in the kernels)
NEG_INF = -math.inf
LOG_2PI = 1.8378770664093453


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_RUNS[k] = 0
    for k in TN_BWD_SEL_LAUNCHES:
        TN_BWD_SEL_LAUNCHES[k] = 0


def threads(W: int) -> int:
    """Threads per block for a row of W columns: the largest power of two
    that divides W, at most MAX_THREADS."""
    return min(W & -W, MAX_THREADS)


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ARGTYPES = {
    "ntc_tn_fwd": [_P] * 4 + [_I] * 4 + [_D, _D, _P],
    "ntc_tn_bwd_u": [_P] * 7 + [_I] * 4 + [_D, _D, _P],
    "ntc_tn_sel": [_P] * 3 + [_I] * 5 + [_P],
    "ntc_tk_bwd": [_P] * 4 + [_I] * 4 + [_D, _D, _P],
    "ntc_tk_fwd_u": [_P] * 6 + [_I] * 5 + [_D, _D, _P],
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


def _check_ints(name: str, **tensors) -> None:
    for arg, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} is not int32")


def _check_width(name: str, W: int) -> int:
    B = threads(W)
    if W // B > MAX_COLS:
        raise ValueError(f"{name}: a row of {W} columns needs {W // B} per "
                         f"thread at {B} threads; the kernel takes at most "
                         f"{MAX_COLS} (pad the row to a multiple of "
                         f"{max(W // MAX_COLS, 32)})")
    return B


def _check_same(name: str, dtype, *tensors) -> None:
    if any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name}: every float input must be {dtype}")


# ---------------------------------------------------------------------------
# plain building blocks
# ---------------------------------------------------------------------------

def _tn_scores(sig_t, mu_n, sinv_n, l2s_n, n_live):
    """(R, N2-1) emission row; padded n positions are -inf. Same op order
    as utils.logmath.log_normal_pdf, so the fp64 batched lattice equals the
    per-read pre-pass's."""
    d = (sig_t[:, None] - mu_n) * sinv_n
    return torch.where(n_live, -0.5 * (LOG_2PI + l2s_n + d * d), NEG_INF)


def _topk_maxmask(U, cap: int):
    """Top-cap by iterated max-extraction: (vals, idx), each (rows, cap),
    descending, ties to the lowest index (the minimum index holding the
    maximum), the taken entry masked to -inf. An exhausted row repeats
    index 0 with -inf values, as the JAX function does."""
    W = U.shape[-1]
    lane = torch.arange(W, device=U.device)
    u = U
    vals, idxs = [], []
    for _ in range(cap):
        v = torch.amax(u, dim=-1)
        i = torch.where(u == v[..., None], lane, W).amin(dim=-1)
        vals.append(v)
        idxs.append(i)
        u = torch.where(lane == i[..., None], NEG_INF, u)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _halve(s):
    """Pairwise tree over the last dim (a power of two): element i gets
    element i + h for h = W/2, ..., 1."""
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s[..., 0]


def _tree_sum(e, B: int):
    """sum over the last dim of e (..., W) in ntc_tn_bwd_sel's order:
    thread b's columns b, b+B, ... first, then a pairwise tree within each
    warp of 32 threads and one over the warp sums (one tree when B <= 32)."""
    W = e.shape[-1]
    parts = e.reshape(*e.shape[:-1], W // B, B)
    s = parts[..., 0, :]
    for j in range(1, W // B):
        s = s + parts[..., j, :]
    if B > 32:
        s = _halve(s.reshape(*s.shape[:-1], B // 32, 32))
    return _halve(s)


# ---------------------------------------------------------------------------
# K7: TN forward store
# ---------------------------------------------------------------------------

TN_FWD_VEC = 4  # csrc/ntc_pre.cu ALPHA: K7's columns go out four at a time


class TnFwdGeometry(NamedTuple):
    """K7's launch at width N2 (csrc/ntc_pre.cu tn_fwd_cols): `cols`
    columns a thread, `threads` a block: ceil(N2 / cols) rounded up to a
    whole warp, the threads past the row idle."""
    threads: int
    cols: int


def tn_fwd_geometry(N2: int) -> TnFwdGeometry:
    """K7's launch at N2 columns: 4 columns a thread up to N2 = 4 *
    MAX_THREADS, 8 up to twice that. Raises ValueError for a width the
    kernel does not take (N2 not a multiple of 4: its stores are vectors
    of four columns)."""
    if N2 < TN_FWD_VEC or N2 % TN_FWD_VEC or N2 > 2 * TN_FWD_VEC * MAX_THREADS:
        raise ValueError(f"ntc_tn_fwd takes N2 a multiple of {TN_FWD_VEC} up to "
                         f"{2 * TN_FWD_VEC * MAX_THREADS}, not {N2}")
    cols = TN_FWD_VEC if N2 <= TN_FWD_VEC * MAX_THREADS else 2 * TN_FWD_VEC
    return TnFwdGeometry((-(-N2 // cols) + 31) // 32 * 32, cols)


def tn_fwd_layout(itemsize: int) -> str:
    """K7's column layout at element size `itemsize` (csrc/ntc_pre.cu
    tn_fwd_launch): "contiguous" in fp32 (thread q owns columns q*cols + j,
    its neighbour in registers, vector stores), "strided" in fp64 (columns
    q + j*threads, its neighbour through shared memory), whichever measured
    faster in that dtype."""
    return "strided" if itemsize == 8 else "contiguous"


def tn_fwd_columns(N2: int, itemsize: int = 4):
    """(threads, cols) int64: the columns thread q owns in K7 at element
    size `itemsize`, in the order it walks them (columns >= N2 belong to
    no one: the kernel neither reads their table nor stores them)."""
    geo = tn_fwd_geometry(N2)
    q = torch.arange(geo.threads)[:, None]
    j = torch.arange(geo.cols)[None, :]
    return q + j * geo.threads if tn_fwd_layout(itemsize) == "strided" else q * geo.cols + j


def tn_fwd_plain(sig, tab, N_r, log_m1: float, log_e2: float):
    PLAIN_RUNS["ntc_tn_fwd"] += 1
    R, Tm1 = sig.shape
    N2 = tab.shape[2] + 1
    mu, sinv, l2s = tab
    live = torch.arange(N2 - 1, device=sig.device)[None, :] < (N_r - 1)[:, None]
    fwd = torch.empty((Tm1 + 1, 2, R, N2), dtype=sig.dtype, device=sig.device)
    fwd[0] = NEG_INF
    fwd[0, 1, :, 0] = 0.0
    fwd[1:, :, :, 0] = NEG_INF
    for t in range(1, Tm1 + 1):
        sc = _tn_scores(sig[:, t - 1], mu, sinv, l2s, live)
        M_prev, E_prev = fwd[t - 1, 0], fwd[t - 1, 1]
        fwd[t, 0, :, 1:] = E_prev[:, :-1] + sc + log_m1
        fwd[t, 1, :, 1:] = torch.logaddexp(M_prev[:, 1:] + sc,
                                           E_prev[:, 1:] + sc + log_e2)
    return fwd


def tn_fwd(sig, tab, N_r, log_m1: float, log_e2: float):
    """fwd (T_pad, 2, R, N2): the TN forward lattice, every row (kernel
    tn_fwd_kernel at tn_fwd_geometry's launch)."""
    if _on_cpu(sig):
        return tn_fwd_plain(sig, tab, N_r, log_m1, log_e2)
    name = "ntc_tn_fwd"
    dtype = sig.dtype
    _check(name, dtype, sig.device, sig=sig, tab=tab, N_r=N_r)
    _check_same(name, dtype, tab)
    _check_ints(name, N_r=N_r)
    R, Tm1 = sig.shape
    N2 = tab.shape[2] + 1
    if tab.shape[:2] != (3, R) or N_r.shape != (R,):
        raise ValueError(f"{name}: tab/N_r do not match sig {tuple(sig.shape)}")
    B = tn_fwd_geometry(N2).threads
    fwd = torch.empty((Tm1 + 1, 2, R, N2), dtype=dtype, device=sig.device)
    rc = _entry(name, dtype)(
        _ptr(sig), _ptr(tab), _ptr(N_r), _ptr(fwd), R, Tm1 + 1, N2, B,
        log_m1, log_e2, _stream(sig.device))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return fwd


# ---------------------------------------------------------------------------
# K8: the TN backward (the chain, into the u store), then the per-column
# top-cap (the selection)
# ---------------------------------------------------------------------------

def tn_bwd_u_plain(sig, tab, N_r, T_r, fwd, log_m1: float, log_e2: float):
    """(u (T_pad, R, N2), E0 (R, N2)): the TN backward from row T_pad-1
    down, each row's u = logaddexp(fwd_M + M, fwd_E + E)."""
    R, Tm1 = sig.shape
    T_pad, N2 = Tm1 + 1, tab.shape[2] + 1
    dev, dtype = sig.device, sig.dtype
    mu, sinv, l2s = tab
    n_iota = torch.arange(N2, device=dev)[None, :]
    live = n_iota[:, :-1] < (N_r - 1)[:, None]
    term_E = torch.where(n_iota == (N_r - 1)[:, None], 0.0, NEG_INF).to(dtype)
    u = torch.empty((T_pad, R, N2), dtype=dtype, device=dev)
    M_next = torch.full((R, N2), NEG_INF, dtype=dtype, device=dev)
    E_next = M_next.clone()
    neg1 = torch.full((R, 1), NEG_INF, dtype=dtype, device=dev)
    zero = torch.zeros((R,), dtype=dtype, device=dev)
    for t in range(T_pad - 1, -1, -1):
        sc = _tn_scores(sig[:, t] if t < Tm1 else zero, mu, sinv, l2s, live)
        ext = torch.cat([M_next[:, 1:] + sc + log_m1, neg1], dim=1)
        M_new = torch.cat([neg1, E_next[:, 1:] + sc], dim=1)
        ext[:, 1:] = torch.logaddexp(ext[:, 1:], E_next[:, 1:] + sc + log_e2)
        is_term = (t == T_r - 1)[:, None]
        dead = (t > T_r - 1)[:, None]
        M_next = torch.where(is_term | dead, NEG_INF, M_new)
        E_next = torch.where(is_term, term_E, torch.where(dead, NEG_INF, ext))
        u[t] = torch.logaddexp(fwd[t, 0] + M_next, fwd[t, 1] + E_next)
    return u, E_next


def tn_sel_plain(u, kid, cap: int):
    """pack (T_pad, R, 4cap+2) from the u store: per row the top-cap
    (_topk_maxmask), the k-mer ids at index-1 and index (clipped to
    [0, N2-2]), the max m0 and the mass _tree_sum(exp(u - m0)) at B =
    threads(N2). Rows are independent; a block of rows at a time."""
    T_pad, R, N2 = u.shape
    B = threads(N2)
    kid = kid.long()
    pack = torch.empty((T_pad, R, 4 * cap + 2), dtype=u.dtype, device=u.device)
    step = max(1, (1 << 24) // (R * N2))
    for t0 in range(0, T_pad, step):
        ub = u[t0:t0 + step]
        nt = ub.shape[0]
        vals, idx = _topk_maxmask(ub.reshape(nt * R, N2), cap)
        m0 = vals[:, 0]
        m0s = torch.where(torch.isfinite(m0), m0, 0.0)
        tot = _tree_sum(torch.exp(ub.reshape(nt * R, N2) - m0s[:, None]), B)
        idx = idx.reshape(nt, R, cap)
        kb = kid[None].expand(nt, R, N2 - 1)
        kn1 = torch.gather(kb, 2, (idx - 1).clamp(0, N2 - 2))
        kn2 = torch.gather(kb, 2, idx.clamp(0, N2 - 2))
        pack[t0:t0 + nt] = torch.cat(
            [vals.reshape(nt, R, cap), idx.to(u.dtype), kn1.to(u.dtype),
             kn2.to(u.dtype), m0.reshape(nt, R, 1), tot.reshape(nt, R, 1)],
            dim=2)
    return pack


def tn_bwd_sel_plain(sig, tab, kid, N_r, T_r, fwd, cap: int, log_m1: float,
                     log_e2: float):
    PLAIN_RUNS["ntc_tn_bwd_sel"] += 1
    u, E0 = tn_bwd_u_plain(sig, tab, N_r, T_r, fwd, log_m1, log_e2)
    return tn_sel_plain(u, kid, cap), E0


def tn_bwd_u(sig, tab, N_r, T_r, fwd, log_m1: float, log_e2: float):
    """(u (T_pad, R, N2), E0 (R, N2)): K8's chain (kernel tn_bwd_u_kernel)."""
    if _on_cpu(sig):
        return tn_bwd_u_plain(sig, tab, N_r, T_r, fwd, log_m1, log_e2)
    name = "ntc_tn_bwd_u"
    dtype = sig.dtype
    _check(name, dtype, sig.device, sig=sig, tab=tab, N_r=N_r, T_r=T_r, fwd=fwd)
    _check_same(name, dtype, tab, fwd)
    _check_ints(name, N_r=N_r, T_r=T_r)
    R, Tm1 = sig.shape
    N2 = tab.shape[2] + 1
    if (tab.shape[:2] != (3, R) or fwd.shape != (Tm1 + 1, 2, R, N2)
            or N_r.shape != (R,) or T_r.shape != (R,)):
        raise ValueError(f"{name}: inputs do not match sig {tuple(sig.shape)}")
    T_pad = Tm1 + 1
    B = _check_width(name, N2)
    u = torch.empty((T_pad, R, N2), dtype=dtype, device=sig.device)
    E0 = torch.empty((R, N2), dtype=dtype, device=sig.device)
    rc = _entry(name, dtype)(
        _ptr(sig), _ptr(tab), _ptr(N_r), _ptr(T_r), _ptr(fwd), _ptr(u),
        _ptr(E0), R, T_pad, N2, B, log_m1, log_e2, _stream(sig.device))
    _raise_on(name, rc)
    TN_BWD_SEL_LAUNCHES["tn_bwd_u"] += 1
    return u, E0


def tn_sel(u, kid, cap: int):
    """pack (T_pad, R, 4cap+2) from the u store: K8's selection (kernel
    tn_sel_kernel, one warp per row)."""
    if _on_cpu(u):
        return tn_sel_plain(u, kid, cap)
    name = "ntc_tn_sel"
    _check(name, u.dtype, u.device, u=u, kid=kid)
    _check_ints(name, kid=kid)
    T_pad, R, N2 = u.shape
    if kid.shape != (R, N2 - 1):
        raise ValueError(f"{name}: kid {tuple(kid.shape)} does not match u "
                         f"{tuple(u.shape)}")
    if not 1 <= cap <= N2:
        raise ValueError(f"{name}: cap {cap} outside [1, {N2}]")
    B = _check_width(name, N2)
    pack = torch.empty((T_pad, R, 4 * cap + 2), dtype=u.dtype, device=u.device)
    rc = _entry(name, u.dtype)(_ptr(u), _ptr(kid), _ptr(pack), T_pad * R, R,
                               N2, B, cap, _stream(u.device))
    _raise_on(name, rc)
    TN_BWD_SEL_LAUNCHES["tn_sel"] += 1
    return pack


def tn_bwd_sel(sig, tab, kid, N_r, T_r, fwd, cap: int, log_m1: float,
               log_e2: float):
    """(pack (T_pad, R, 4cap+2), E0 (R, N2)) from the TN forward store:
    tn_bwd_u, then tn_sel on its u store (T_pad x R x N2, freed on return;
    fwd is left as it was)."""
    if _on_cpu(sig):
        return tn_bwd_sel_plain(sig, tab, kid, N_r, T_r, fwd, cap, log_m1,
                                log_e2)
    u, E0 = tn_bwd_u(sig, tab, N_r, T_r, fwd, log_m1, log_e2)
    pack = tn_sel(u, kid, cap)
    LAUNCHES["ntc_tn_bwd_sel"] += 1
    return pack, E0


# ---------------------------------------------------------------------------
# the TK columns, shared by K9, K10 and ntc_batch.pre_tk_batch_ckpt
# ---------------------------------------------------------------------------

BIG_K = 4096  # above it JAX's batched TK pre-pass sums its groups otherwise
TK_A = 4  # csrc/ntc_pre.cu ALPHA: the alphabet K9 and K10 take
TK_MAX_THREADS = 1024  # csrc/ntc_pre.cu TK_MAX_THREADS: K/A threads, at most
TK_CHUNK = 512  # csrc/ntc_pre.cu TK_CHUNK: signal samples a shared-memory stage
TK_RING = 4  # csrc/ntc_pre.cu TK_RING: K10's backward rows in flight, at most


class TkGeometry(NamedTuple):
    """A launch of K9 or K10 at K columns: `threads` threads a block, each
    owning one k-mer group of TK_A columns, the kernel built for
    `max_threads`; K10's ring of `ring` backward rows; each kernel's bytes
    of shared memory."""
    threads: int
    max_threads: int
    ring: int
    bwd_bytes: int
    fwd_bytes: int


def tk_geometry(K: int, A: int, itemsize: int) -> TkGeometry:
    """K9's and K10's launch at K = A * step columns (csrc/ntc_pre.cu): one
    group a thread, step threads, the kernel built for MAX_THREADS threads
    up to it and TK_MAX_THREADS above; the shared bytes as tk_smem_bytes
    sums them (the double-buffered row [2][K], two signal stages
    [2][TK_CHUNK], K10's ring [ring][2][K]), the ring as deep as TK_RING or
    SMEM_LIMIT allow. Raises ValueError for a shape the kernels do not
    take."""
    if A != TK_A or K % A or not 0 < K <= BIG_K:
        raise ValueError(f"the TK kernels take A = {TK_A} and K a multiple of "
                         f"it up to {BIG_K}, not A = {A}, K = {K}")
    step = K // A
    base = (2 * K + 2 * TK_CHUNK) * itemsize
    ring = min(TK_RING, (SMEM_LIMIT - base) // (2 * K * itemsize))
    return TkGeometry(step, MAX_THREADS if step <= MAX_THREADS else TK_MAX_THREADS,
                      ring, base, base + ring * 2 * K * itemsize)


def tk_columns(K: int, A: int, itemsize: int, kernel: str):
    """(threads, A) int64: the columns thread i owns in K9 ("bwd":
    successor group i, columns i + j*K/A) or K10 ("fwd": predecessor class
    i, columns i*A + j), j < A, in the order the kernel walks them."""
    geo = tk_geometry(K, A, itemsize)
    i = torch.arange(geo.threads)[:, None]
    j = torch.arange(A)[None, :]
    return i + j * (K // A) if kernel == "bwd" else i * A + j


def _prec_sum_b(E_prev, alphabet_size: int):
    """X[:, k] = logsumexp_j E_prev[:, prec_j(k)], in the batched JAX
    pre-pass's order (ops/ntc_batch._prec_sum_b): ntc_pre._prec_sum up to
    K = 4096; above it, for A = 4, the class sum pairwise, (e0 + e1) +
    (e2 + e3), as JAX's two lane rolls add it."""
    R, K = E_prev.shape
    if K <= BIG_K or alphabet_size != 4:
        return _prec_sum(E_prev, alphabet_size)
    g = E_prev.reshape(R, 4, K // 4)
    m = torch.amax(g, dim=1)
    fin = torch.isfinite(m)
    safe = torch.where(fin, m, 0.0)
    e = torch.exp(g - safe[:, None])
    s = (e[:, 0] + e[:, 1]) + (e[:, 2] + e[:, 3])
    x = torch.where(fin, torch.log(s) + safe, NEG_INF)
    return torch.repeat_interleave(x, 4, dim=-1)


def tk_scores(x, tabk):
    """Emission scores c1 - c2 * (x - mu)^2 of every k-mer: x (..., R) ->
    (..., R, K); elementwise, so a block of rows rounds as row by row."""
    return log_normal_pdf_c(x[..., None], *tabk)


def tk_row_masks(t, T_r):
    """(is_term, dead), each (..., R, 1) bool, of rows t (an int or an
    (n, 1) tensor): the row T_r-1, and the rows past it."""
    return ((t == T_r - 1)[..., None], (t > T_r - 1)[..., None])


def tk_bwd_column(sc, M_next, E_next, is_term, dead, alphabet_size: int,
                  log_m1: float, log_e2: float):
    """Backward TK row t (M, E), each (R, K), from row t+1, with sc =
    tk_scores(sig[t]) (sig 0 at t = T_pad-1) and row t's masks. The
    successor sum is ntc_pre._suc_sum at every K: JAX's big-K branch adds
    each group of 4 ascending too (_sum4's one-hot contraction)."""
    M_new = E_next + sc
    E_new = torch.logaddexp(_suc_sum(M_next + sc + log_m1, alphabet_size),
                            E_next + sc + log_e2)
    return (torch.where(is_term | dead, NEG_INF, M_new),
            torch.where(is_term, 0.0, torch.where(dead, NEG_INF, E_new)))


def tk_fwd_column(sc, M_prev, E_prev, dead, alphabet_size: int,
                  log_m1: float, log_e2: float):
    """Forward TK row t >= 1 (M, E), each (R, K), from row t-1, with sc =
    tk_scores(sig[t-1]) and row t's dead mask (row 0 is M = -inf, E = 0)."""
    M_new = _prec_sum_b(E_prev, alphabet_size) + sc + log_m1
    E_new = torch.logaddexp(M_prev + sc, E_prev + sc + log_e2)
    return torch.where(dead, NEG_INF, M_new), torch.where(dead, NEG_INF, E_new)


# ---------------------------------------------------------------------------
# K9: TK backward store
# ---------------------------------------------------------------------------

def tk_bwd_plain(sig, tabk, T_r, alphabet_size: int, log_m1: float,
                 log_e2: float):
    PLAIN_RUNS["ntc_tk_bwd"] += 1
    R, Tm1 = sig.shape
    K = tabk.shape[1]
    bwd = torch.empty((Tm1 + 1, 2, R, K), dtype=sig.dtype, device=sig.device)
    M_next = torch.full((R, K), NEG_INF, dtype=sig.dtype, device=sig.device)
    E_next = M_next.clone()
    zero = torch.zeros((R,), dtype=sig.dtype, device=sig.device)
    for t in range(Tm1, -1, -1):
        M_next, E_next = tk_bwd_column(
            tk_scores(sig[:, t] if t < Tm1 else zero, tabk), M_next, E_next,
            *tk_row_masks(t, T_r), alphabet_size, log_m1, log_e2)
        bwd[t, 0] = M_next
        bwd[t, 1] = E_next
    return bwd


def tk_bwd(sig, tabk, T_r, alphabet_size: int, log_m1: float, log_e2: float):
    """bwd (T_pad, 2, R, K): the TK backward lattice, every row (kernel
    tk_bwd_kernel at tk_geometry's launch)."""
    if _on_cpu(sig):
        return tk_bwd_plain(sig, tabk, T_r, alphabet_size, log_m1, log_e2)
    name = "ntc_tk_bwd"
    dtype = sig.dtype
    _check(name, dtype, sig.device, sig=sig, tabk=tabk, T_r=T_r)
    _check_same(name, dtype, tabk)
    _check_ints(name, T_r=T_r)
    R, Tm1 = sig.shape
    K = tabk.shape[1]
    if tabk.shape != (3, K) or T_r.shape != (R,):
        raise ValueError(f"{name}: tabk/T_r do not match sig {tuple(sig.shape)}")
    tk_geometry(K, alphabet_size, sig.element_size())  # raises for other shapes
    bwd = torch.empty((Tm1 + 1, 2, R, K), dtype=dtype, device=sig.device)
    rc = _entry(name, dtype)(
        _ptr(sig), _ptr(tabk), _ptr(T_r), _ptr(bwd), R, Tm1 + 1, K,
        alphabet_size, log_m1, log_e2, _stream(sig.device))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return bwd


# ---------------------------------------------------------------------------
# K10: TK forward fused with U = lse(bM + M, bE + E) and finalE
# ---------------------------------------------------------------------------

def tk_fwd_u_plain(sig, tabk, T_r, bwd, alphabet_size: int, log_m1: float,
                   log_e2: float):
    PLAIN_RUNS["ntc_tk_fwd_u"] += 1
    R, Tm1 = sig.shape
    K = tabk.shape[1]
    U = torch.empty((Tm1 + 1, R, K), dtype=sig.dtype, device=sig.device)
    M_prev = torch.full((R, K), NEG_INF, dtype=sig.dtype, device=sig.device)
    E_prev = torch.zeros_like(M_prev)
    finalE = M_prev.clone()
    for t in range(Tm1 + 1):
        if t > 0:
            M_prev, E_prev = tk_fwd_column(
                tk_scores(sig[:, t - 1], tabk), M_prev, E_prev,
                tk_row_masks(t, T_r)[1], alphabet_size, log_m1, log_e2)
        finalE = torch.where((t == T_r - 1)[:, None], E_prev, finalE)
        U[t] = torch.logaddexp(bwd[t, 0] + M_prev, bwd[t, 1] + E_prev)
    return U, finalE


def tk_fwd_u(sig, tabk, T_r, bwd, alphabet_size: int, log_m1: float,
             log_e2: float):
    """(U (T_pad, R, K), finalE (R, K)) from the TK backward store (kernel
    tk_fwd_u_kernel at tk_geometry's launch)."""
    if _on_cpu(sig):
        return tk_fwd_u_plain(sig, tabk, T_r, bwd, alphabet_size, log_m1,
                              log_e2)
    name = "ntc_tk_fwd_u"
    dtype = sig.dtype
    _check(name, dtype, sig.device, sig=sig, tabk=tabk, T_r=T_r, bwd=bwd)
    _check_same(name, dtype, tabk, bwd)
    _check_ints(name, T_r=T_r)
    R, Tm1 = sig.shape
    K = tabk.shape[1]
    if (tabk.shape != (3, K) or T_r.shape != (R,)
            or bwd.shape != (Tm1 + 1, 2, R, K)):
        raise ValueError(f"{name}: inputs do not match sig {tuple(sig.shape)}")
    geo = tk_geometry(K, alphabet_size, sig.element_size())
    _check_aligned(name, bwd=bwd)  # copied into the ring in 16-byte pieces
    U = torch.empty((Tm1 + 1, R, K), dtype=dtype, device=sig.device)
    finalE = torch.empty((R, K), dtype=dtype, device=sig.device)
    rc = _entry(name, dtype)(
        _ptr(sig), _ptr(tabk), _ptr(T_r), _ptr(bwd), _ptr(U), _ptr(finalE),
        R, Tm1 + 1, K, alphabet_size, geo.ring, log_m1, log_e2,
        _stream(sig.device))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return U, finalE

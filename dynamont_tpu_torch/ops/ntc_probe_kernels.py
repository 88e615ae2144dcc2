"""Wrappers of the probe kernels (counterpart of the JAX package's TPU
timing probes of K13, scripts/probe_ntc_*.py) and their plain versions:

  bwd_variant / bwd_variant_plain  ntc_bwd_variant  replaces
      scripts/probe_ntc_bwd_synth.py::variant_bwd (#19) and
      scripts/probe_ntc_bwd_variants.py::variant_bwd (#20)
  microop     / microop_plain      ntc_microop      replaces
      scripts/probe_ntc_microops.py::run_block (#21)

ntc_bwd_variant is in csrc/ntc_lattice.cu beside K13 (ntc_bwd), ntc_microop
in csrc/ntc_probe.cu; both in float32 only, as the TPU probes. As in
ops/ntc_kernels.py, a wrapper runs its plain version for tensors on the
CPU, launches its kernel for CUDA tensors, and raises for anything else or
when the launch fails; LAUNCHES and PLAIN_RUNS count one per call.

bwd_variant is K13's backward lattice under the probes' axes, mapped onto
the card: C rows per chunk, staged into shared memory before the chunk
runs (stage) or read from device memory as K13 reads them; chunks in
K13's order (reverse) or ascending with the rows of a chunk descending,
each row reading the row visited before it (the TPU forward grid's access
pattern: wrong values, for timing); nt threads per read (the card's
counterpart of the TPU's dimension semantics); every row stored (store
"full") or only row 0 ("none", the rows between in a per-read double
buffer). Every row goes through K13's column, so a reverse-order variant
equals ntc_kernels.bwd bit for bit. A C whose staged rows do not fit the
card's shared memory raises DoesNotFit, with the bytes.

microop(block, x, aux, iters) applies one building block of K13 to a (128,
128) float32 tile `iters` times, y = body(y, aux) * 0.999: the 15 blocks of
the TPU probe (MICRO_TPU, computing the values of the JAX package's
helpers on that tile) and four forms in which the card's K13 does the same
jobs (MICRO_CARD). micro_inputs makes the tiles.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from dynamont_tpu_torch import _build
from dynamont_tpu_torch.ops import ntc_batch as nb
from dynamont_tpu_torch.ops import ntc_kernels as kern
from dynamont_tpu_torch.ops.nt_banded_kernels import (
    _check, _on_cpu, _ptr, _raise_on, _stream,
)
from dynamont_tpu_torch.parallel.mesh import on_device

KERNELS = ("ntc_bwd_variant", "ntc_microop")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_RUNS = dict.fromkeys(KERNELS, 0)


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_RUNS[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "ntc_bwd_variant": [_P] * 21 + [_I] * 10 + [_P],
    "ntc_microop": [_I] + [_P] * 3 + [_I] + [_P],
}
_bound: dict = {}


def _entry(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(_build.load(), f"{name}_f32")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def _check_f32(name: str, *tensors) -> None:
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: the probe kernels take float32 only")


# ---------------------------------------------------------------------------
# ntc_bwd_variant: K13 under the TPU probes' axes (#19, #20)
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448     # shared memory one block can use on Hopper (227 KB)
THREADS = (128, 256, 512, 1024)  # threads per read
STORES = ("full", "none")


class DoesNotFit(ValueError):
    """A variant's shared memory exceeds the card's SMEM_LIMIT."""


def _al16(b: int) -> int:
    return (b + 15) // 16 * 16


def stage_bytes(dims: nb.PlanDims, C: int, itemsize: int = 4) -> int:
    """Bytes of C staged rows of one read, as csrc/ntc_lattice.cu's
    stage_bytes lays them out: the float parameters (mu, c1, c2 at the
    k-slots, their successors', the n-slots') and C + 1 samples, the int
    maps (cand_n, brow_same, brow_next, bcol_same, bcol_suc), hd, then
    allowed, d01, d02 — 13.6 KB a row at (8, 128) in float32."""
    _, CN, CK, A = dims
    NC = CN * CK
    return (_al16((C * (3 * CK + 3 * A * CK + 6 * CN) + C + 1) * itemsize)
            + _al16(C * (3 * CN + CK + A * CK) * 4) + _al16(C * NC * 2)
            + _al16(C * (NC + 2 * CN)))


def smem_bytes(dims: nb.PlanDims, C: int, stage: bool, itemsize: int = 4) -> int:
    """A variant's shared memory: the staged rows and K13's column scratch
    (ntc_lattice.cu bwd_smem)."""
    NC = dims.CN * dims.CK
    return (stage_bytes(dims, C, itemsize) if stage else 0) + 4 * NC * itemsize + NC


def row_order(T_pad: int, C: int, reverse: bool) -> list[int]:
    """The rows in the order a variant visits them: chunks of C rows
    descending (reverse) or ascending, the rows of a chunk descending."""
    nc = T_pad // C
    chunks = range(nc - 1, -1, -1) if reverse else range(nc)
    return [c * C + i for c in chunks for i in range(C - 1, -1, -1)]


def _check_variant(name: str, T_pad: int, C: int, nt: int, store: str) -> None:
    if C < 1 or T_pad % C:
        raise ValueError(f"{name}: T_pad {T_pad} is not a multiple of C = {C}")
    if nt not in THREADS:
        raise ValueError(f"{name}: nt {nt} is none of {THREADS}")
    if store not in STORES:
        raise ValueError(f"{name}: store {store!r} is none of {STORES}")


def plain_rows(plan, dims, prm, sig, trans_log: dict, N_r, T_r, order, nxt=None):
    """Yields (t, row) for the rows `order`, each row (R, 5, CN, CK) K13's
    plain column (ops/ntc_batch._bwd_column) read from the row before it,
    the first from `nxt` (-inf when None): what a variant stores at those
    rows when `nxt` is what it stored at the row visited before them."""
    R, CN, CK, _ = dims
    rows = nb._rows(dims, prm, sig)
    Nm1 = (N_r.long() - 1)[:, None]
    if nxt is None:
        nxt = torch.full((R, 5, CN, CK), -math.inf, dtype=sig.dtype, device=sig.device)
    for t in order:
        col = nb._bwd_column(plan, dims, rows, trans_log, t, nxt, Nm1)
        nxt = nb._bwd_stored(plan, t, col, Nm1, T_r)
        yield t, nxt


def bwd_variant_plain(plan, dims, prm, sig, trans_log: dict, N_r, T_r, *, C: int,
                      reverse: bool = True, nt: int = 512, store: str = "full",
                      stage: bool = True):
    """The variant's values: plain_rows over row_order's rows, from -inf.
    nt and stage change no value."""
    PLAIN_RUNS["ntc_bwd_variant"] += 1
    R, CN, CK, _ = dims
    T_pad = sig.shape[1] + 1
    _check_variant("ntc_bwd_variant", T_pad, C, nt, store)
    out = (torch.empty((T_pad, R, 5, CN, CK), dtype=sig.dtype, device=sig.device)
           if store == "full" else None)
    row0 = None
    for t, row in plain_rows(plan, dims, prm, sig, trans_log, N_r, T_r,
                             row_order(T_pad, C, reverse)):
        if out is not None:
            out[t] = row
        elif t == 0:
            row0 = row
    return out if store == "full" else row0


def bwd_variant(plan: nb.NTCPlan, dims: nb.PlanDims, prm: nb.NTCParams, sig,
                trans_log: dict, N_r, T_r, *, C: int, reverse: bool = True,
                nt: int = 512, store: str = "full", stage: bool = True):
    """The backward store (T_pad, R, 5, CN, CK) (store "full") or its row 0
    (R, 5, CN, CK) ("none") of the variant; the inputs are K13's."""
    if _on_cpu(sig):
        return bwd_variant_plain(plan, dims, prm, sig, trans_log, N_r, T_r, C=C,
                                 reverse=reverse, nt=nt, store=store, stage=stage)
    name = "ntc_bwd_variant"
    _check_f32(name, sig)
    dev = sig.device
    R, CN, CK, A = dims
    T_pad = kern._check_bwd_inputs(name, plan, dims, prm, sig, N_r, T_r)
    _check_variant(name, T_pad, C, nt, store)
    need = smem_bytes(dims, C, stage)
    if need > SMEM_LIMIT:
        raise DoesNotFit(f"{name}: C = {C} staged needs {need} bytes of shared "
                         f"memory, the card gives a block {SMEM_LIMIT}")
    full = store == "full"
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = torch.empty((R, 2, 5, CN, CK), **f32)
    out = torch.empty((T_pad, R, 5, CN, CK), **f32) if full else scratch
    row0 = scratch if full else torch.empty((R, 5, CN, CK), **f32)
    tl = kern.tl_tensor(trans_log, torch.float32, dev)
    with on_device(dev):
        rc = _entry(name)(
            *kern._bwd_ptrs(plan, prm, sig), _ptr(tl), _ptr(N_r), _ptr(T_r),
            _ptr(out), _ptr(row0), _ptr(scratch), R, T_pad, CN, CK, A, nt, C,
            int(stage), int(reverse), int(full), _stream(dev))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return out if full else row0


# ---------------------------------------------------------------------------
# ntc_microop: one building block of K13 on a (128, 128) tile (#21)
# ---------------------------------------------------------------------------

# the TPU probe's tile: RC = R * CN rows (16 reads x 8 n-slots), CK lanes
M_RC, M_CK, M_R, M_CN, M_A, M_K = 128, 128, 16, 8, 4, 1024
NEG = -math.inf
NEG_BIG = -1e30   # the TPU kernels' finite -inf proxy inside one-hot matmuls
NEG_THR = -5e29
DECAY = 0.999
SC_C1, SC_C2 = -0.5, 0.01  # sc_score's c1 and c2
MICRO_TPU = ("noop", "roll_up_1", "roll_up_4", "roll_down_127", "roll_down_124",
             "roll_lane_1", "affine_chain_up", "affine_chain_down", "row_gather_x2",
             "row_gather_x5", "col_gather_L4", "col_gather_L16+slots",
             "lse_13_terms", "unpack_hd", "transpose_24x128")
MICRO_CARD = ("gat_slot_map", "ichain_fold", "sc_score", "sync_pair")
MICRO_BLOCKS = MICRO_TPU + MICRO_CARD
# the input tiles whose values reach each gather's every branch (micro_inputs)
MICRO_KIND = {"row_gather_x2": "rows", "row_gather_x5": "rows",
              "col_gather_L4": "cols", "col_gather_L16+slots": "cols",
              "gat_slot_map": "rows"}


def micro_inputs(seed: int = 0, kind: str = "normal") -> tuple[np.ndarray, np.ndarray]:
    """(x, aux), (128, 128) float32, from numpy's generator at `seed`.

    "normal": standard normal, the TPU probe's inputs. "rows": aux[:, 0]
    (the row gathers' slot, gat's row map) mostly integers in [-2, 12), so
    that rows match within, across and past the read groups, or are
    absent. "cols": read r's 128 source slots aux[:, r] (r < 16) hold
    distinct p in [0, 256) (k-mer value 100p mod 1024), one in ten dead
    (-2); five of them hold the values 4u, u in (0, 1, 4, 16, 64), whose
    successor and predecessor digit 0 stay among them, so that the column
    gathers stay finite over iterations; the targets aux[r, 16:] are such a
    value (0 on those five slots' lanes) or standard normal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M_RC, M_CK)).astype(np.float32)
    aux = rng.standard_normal((M_RC, M_CK)).astype(np.float32)
    if kind == "rows":
        idx = rng.integers(-2, 12, size=M_RC).astype(np.float32)
        aux[:, 0] = np.where(rng.random(M_RC) < 0.2, aux[:, 0], idx)
    elif kind == "cols":
        # slots s_u of each read hold the k-mer values 4u, u in Q, which Q's
        # successors (4u mod 256) and predecessors (u / 4) keep in Q
        Q = (0, 1, 4, 16, 64)
        for r in range(M_R):
            su = rng.choice(np.arange(M_R, M_CK), size=len(Q), replace=False)
            pq = [41 * u % 256 for u in Q]                # 100p mod 1024 = 4u
            rest = rng.permutation(np.setdiff1d(np.arange(256), pq))
            col = np.where(rng.random(M_CK) < 0.1, -2.0, rest[:M_CK]).astype(np.float32)
            col[su] = pq
            aux[:, r] = col
            tgt = np.where(rng.random(M_CK) < 0.6, 4.0 * rng.choice(Q, size=M_CK),
                           aux[r])
            tgt[su] = 0.0
            aux[r, M_R:] = tgt[M_R:]
    elif kind != "normal":
        raise ValueError(f"micro_inputs: kind {kind!r}")
    return x, aux


def _roll_grp(x, sh: int, fill: float, up: bool):
    """Shift by sh within each read's 8 rows (up: row m gets m - sh)."""
    m = torch.arange(M_RC, device=x.device)[:, None] % M_CN
    if up:
        return torch.where(m >= sh, torch.roll(x, sh, 0), fill)
    return torch.where(m < M_CN - sh, torch.roll(x, M_RC - sh, 0), fill)


def affine_chain(a, b, up: bool):
    """ntc_pallas._affine_chain (logaddexp): the inclusive scan of the maps
    v -> lse(a, v + b) within each read's rows, by log2(8) doublings."""
    for s in range(M_CN.bit_length() - 1):
        sh = 1 << s
        a_in = _roll_grp(a, sh, NEG, up)
        b_in = _roll_grp(b, sh, 0.0, up)
        a = torch.logaddexp(a, a_in + b)
        b = b + b_in
    return a


def ichain_fold(a, b):
    """K13's phase-2 I chain: from each read's last row down, row i takes
    lse(a[i], (row i + 1's result) + b[i]); equals affine_chain(a, b,
    up=False) up to rounding."""
    a3 = a.reshape(M_R, M_CN, M_CK).clone()
    b3 = b.reshape(M_R, M_CN, M_CK)
    for i in range(M_CN - 2, -1, -1):
        a3[:, i] = torch.logaddexp(a3[:, i], a3[:, i + 1] + b3[:, i])
    return a3.reshape(M_RC, M_CK)


def _gathered(v):
    """A source value as the TPU's one-hot matmul returns it."""
    g = v.clamp(min=NEG_BIG)
    return torch.where(g <= NEG_THR, NEG, g)


def row_gather(idx_col, blocks):
    """ntc_pallas._row_gather: row m of each block gathered from row
    base(m) + idx_col[m] of the tile, 0 where no row is that, -inf where
    idx_col[m] < 0."""
    dev = idx_col.device
    base = (torch.arange(M_RC, device=dev) // M_CN * M_CN).to(torch.float32)[:, None]
    oh = torch.arange(M_RC, device=dev, dtype=torch.float32)[None, :] == base + idx_col
    hit = oh.any(1, keepdim=True)
    n = oh.to(torch.uint8).argmax(1)
    outs = []
    for b in blocks:
        g = torch.where(hit, b.clamp(min=NEG_BIG)[n], 0.0)
        g = torch.where(g <= NEG_THR, NEG, g)
        outs.append(torch.where(idx_col >= 0.0, g, NEG))
    return outs


def mk_ks(a):
    """The TPU probe's source slots (CK, R): |a * 100| mod 1024, -1 dead."""
    s = a[:M_CK, :M_R]
    return torch.where(s > -1.0, (s * 100.0).abs() % 1024.0, -1.0)


def dst_vals(ks_row, mode: str):
    """ntc_pallas._dst_vals at K = 1024: the target values per destination
    slot (R, CK) ('same') or (R, A*CK) ('suc', 'prec'), -2 where invalid."""
    ok = ks_row >= 0.0
    if mode == "same":
        return torch.where(ok, ks_row, -2.0)
    step = float(M_K // M_A)
    if mode == "suc":
        base = (ks_row - step * torch.floor(ks_row / step)) * M_A
        offs = [base + a for a in range(M_A)]
    else:
        base = torch.floor(ks_row / M_A)
        offs = [base + a * step for a in range(M_A)]
    return torch.cat([torch.where(ok, o, -2.0) for o in offs], dim=1)


def first_slot(ksT, dst):
    """(R, D) int64: the first source slot of each read whose value equals
    the target dst (R, D), -1 where none does (ksT (CK, R))."""
    eq = ksT.T[:, :, None] == dst[:, None, :]
    return torch.where(eq.any(1), eq.to(torch.uint8).argmax(1), -1)


def gather_slot(src, slot):
    """ntc_pallas._col_gather of one (128, CK) source block at the slots
    (R, D): row r*8 + i, lane d gets src[r*8 + i, slot[r, d]], -inf where
    the slot is -1."""
    D = slot.shape[1]
    v = src.reshape(M_R, M_CN, M_CK)
    idx = slot.clamp(min=0)[:, None, :].expand(M_R, M_CN, D)
    g = _gathered(torch.gather(v, 2, idx)).reshape(M_RC, D)
    return torch.where((slot >= 0).repeat_interleave(M_CN, 0), g, NEG)


def lse_terms(terms):
    """ntc_pallas._lse: max, exp summed in list order, log(sum) + max."""
    m = terms[0]
    for t in terms[1:]:
        m = torch.maximum(m, t)
    fin = m > NEG_THR
    ms = torch.where(fin, m, 0.0)
    s = torch.exp(terms[0] - ms)
    for t in terms[1:]:
        s = s + torch.exp(t - ms)
    return torch.where(fin, ms + torch.log(s), m)


def gat_maps(a):
    """gat_slot_map's maps, computed once: a row slot per row m (R*CN,)
    and a column slot per read and lane (R, CK), -1 where absent."""
    rmap = torch.floor(a[:, 0]).clamp(-1, M_CN - 1).long()
    cmap = torch.floor(a[:M_R] * 16.0).clamp(-1, M_CK - 1).long()
    return rmap, cmap


def gat_slot_map(v, rmap, cmap):
    """K13's gat: row r*8 + i, lane j reads v at the read's row rmap and
    lane cmap[r, j], -inf where either is -1."""
    rows = torch.arange(M_RC, device=v.device) // M_CN * M_CN + rmap.clamp(min=0)
    cols = cmap.clamp(min=0).repeat_interleave(M_CN, 0)
    ok = (rmap >= 0)[:, None] & (cmap >= 0).repeat_interleave(M_CN, 0)
    return torch.where(ok, v[rows[:, None], cols], NEG)


def _body(block: str, aux):
    """The block as a function of y, with what depends on aux alone
    computed once (the TPU kernel recomputes it every iteration; the
    values are the same)."""
    a = aux
    if block in ("noop", "sync_pair"):
        return lambda v: v
    if block.startswith("roll_"):
        s, dim = {"roll_up_1": (1, 0), "roll_up_4": (4, 0), "roll_down_127": (127, 0),
                  "roll_down_124": (124, 0), "roll_lane_1": (1, 1)}[block]
        return lambda v: torch.roll(v, s, dim)
    if block.startswith("affine_chain"):
        up = block == "affine_chain_up"
        return lambda v: affine_chain(v, a, up)
    if block == "row_gather_x2":
        return lambda v: (lambda g: g[0] + g[1])(row_gather(a[:, 0:1], [v, v * 0.5]))
    if block == "row_gather_x5":
        return lambda v: sum(row_gather(a[:, 0:1], [v, v, v, v, v]))
    if block.startswith("col_gather"):
        ksT = mk_ks(a)
        ks_cur = a[:M_R, :M_CK] % 1024.0
        s1 = first_slot(ksT, dst_vals(ks_cur, "same"))
        if block == "col_gather_L4":
            s2 = first_slot(ksT, dst_vals(ks_cur, "suc")[:, :M_CK])
            return lambda v: gather_slot(v, s1) + gather_slot(v * 2.0, s2)
        s2 = first_slot(ksT, dst_vals(ks_cur, "prec")[:, :M_CK])
        cs = s1.to(torch.float32).repeat_interleave(M_CN, 0)
        return lambda v: (gather_slot(v * (0.9 + 0.01 * 0), s1)
                          + gather_slot(v * (0.9 + 0.01 * 15), s2) + cs)
    if block == "lse_13_terms":
        return lambda v: lse_terms([v + 0.01 * i for i in range(13)])
    if block == "unpack_hd":
        h = a.to(torch.int16).to(torch.int32)
        p = [((h >> s) & 0xF).to(torch.float32) for s in (0, 4, 8, 12)]
        return lambda v: v + p[0] + p[1] + p[2] + p[3]
    if block == "transpose_24x128":
        acc = a[0]
        for s in range(1, 24):
            acc = acc + a[s]
        return lambda v: v + acc[:, None]
    if block == "gat_slot_map":
        rmap, cmap = gat_maps(a)
        return lambda v: gat_slot_map(v, rmap, cmap)
    if block == "ichain_fold":
        return lambda v: ichain_fold(v, a)
    if block == "sc_score":
        return lambda v: (lambda d: SC_C1 - SC_C2 * d * d)(v - a)
    raise ValueError(f"microop: no block {block!r}")


def _check_micro(name: str, block: str, x, aux, iters: int) -> None:
    if block not in MICRO_BLOCKS:
        raise ValueError(f"{name}: no block {block!r}")
    if x.shape != (M_RC, M_CK) or aux.shape != (M_RC, M_CK) or iters < 0:
        raise ValueError(f"{name}: x, aux must be ({M_RC}, {M_CK}), iters >= 0")


def microop_plain(block: str, x, aux, iters: int):
    PLAIN_RUNS["ntc_microop"] += 1
    _check_micro("ntc_microop", block, x, aux, iters)
    body = _body(block, aux)
    y = x
    for _ in range(iters):
        y = body(y) * DECAY
    return y


def microop(block: str, x, aux, iters: int):
    """y (128, 128) float32 after `iters` applications of
    y = body(y, aux) * 0.999, starting from x."""
    if _on_cpu(x):
        return microop_plain(block, x, aux, iters)
    name = "ntc_microop"
    _check_micro(name, block, x, aux, iters)
    _check_f32(name, x, aux)
    _check(name, torch.float32, x.device, x=x, aux=aux)
    out = torch.empty_like(x)
    with on_device(x.device):
        rc = _entry(name)(MICRO_BLOCKS.index(block), _ptr(x), _ptr(aux), _ptr(out),
                          iters, _stream(x.device))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    return out

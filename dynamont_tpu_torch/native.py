"""ctypes bindings for the native host runtime (dynamont_tpu/_native).

The shared library is compiled on demand with g++ -O3 -fopenmp and cached
next to the source. Every entry point has a pure-Python fallback so the
package works without a toolchain (slower tracebacks only).
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import threading

import numpy as np

_SRC_DIR = os.path.join(os.path.dirname(__file__), "_native")
_SRC = os.path.join(_SRC_DIR, "native.cpp")
_LIB = os.path.join(_SRC_DIR, "libdynamont_native.so")

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _build() -> bool:
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
        "-std=c++17", _SRC, "-o", _LIB,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        # retry without -march=native (portability)
        try:
            cmd.remove("-march=native")
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            return True
        except Exception:
            return False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            if not _build():
                _lib_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            _lib_failed = True
            return None
        c_i64 = ctypes.c_int64
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.banded_traceback.restype = c_i64
        lib.banded_traceback.argtypes = [
            u8p, f32p, f32p, i32p, c_i64, c_i64, c_i64, c_i64, c_i64,
            i32p, i32p, f64p,
        ]
        lib.banded_traceback_batch.restype = None
        lib.banded_traceback_batch.argtypes = [
            u8p, f32p, f32p, i32p, c_i64, c_i64, c_i64,
            i32p, i32p, i32p, c_i64, c_i64, i32p, i32p, f64p, i64p,
        ]
        lib.nt_traceback.restype = c_i64
        lib.nt_traceback.argtypes = [
            u8p, f32p, f32p, c_i64, c_i64, c_i64, i32p, i32p, f64p,
        ]
        lib.summaries_to_csv.restype = c_i64
        lib.summaries_to_csv.argtypes = [
            ctypes.c_char_p, i32p, f32p, c_i64, ctypes.c_char_p, c_i64,
            c_i64, c_i64, c_i64, c_i64, ctypes.c_char_p, c_i64,
        ]
        _lib = lib
        return _lib


def _as_segments(nseg, basepos, start, med):
    return [
        ("M", int(basepos[i]), int(start[i]), float(med[i])) for i in range(nseg)
    ]


def banded_traceback(choices, PM, PE, bstart, T, N, bw, kmer_size):
    """MAP walk in band coordinates over posterior probabilities.

    choices (T_pad, B) bool, PM/PE (T_pad, B) float32, bstart (T_pad,) int32.
    Returns [(state, basepos, start_t, median_prob)] in read order
    (ref walk: NT_banded.cpp:204-250).
    """
    lib = get_lib()
    kmer_half = kmer_size // 2
    if lib is not None:
        ch = np.ascontiguousarray(choices, dtype=np.uint8)
        pm = np.ascontiguousarray(PM, dtype=np.float32)
        pe = np.ascontiguousarray(PE, dtype=np.float32)
        bs = np.ascontiguousarray(bstart, dtype=np.int32)
        out_b = np.empty(N, dtype=np.int32)
        out_s = np.empty(N, dtype=np.int32)
        out_m = np.empty(N, dtype=np.float64)
        nseg = lib.banded_traceback(
            ch, pm, pe, bs, ch.shape[1], T, N, bw, kmer_half, out_b, out_s, out_m
        )
        return _as_segments(nseg, out_b, out_s, out_m)
    return _banded_traceback_py(choices, PM, PE, bstart, T, N, bw, kmer_half)


def banded_traceback_batch(choices, PM, PE, bstart, T, N, bw, kmer_size):
    """Batched banded traceback; OpenMP across reads when native is built.

    choices (R, T_pad, B) bool, PM/PE (R, T_pad, B) float32,
    bstart (R, T_pad) int32, T/N/bw (R,) int arrays.
    Returns a list of per-read segment lists.
    """
    lib = get_lib()
    kmer_half = kmer_size // 2
    R, T_pad, B = choices.shape
    if lib is None:
        return [
            _banded_traceback_py(
                choices[i], PM[i], PE[i], bstart[i], int(T[i]), int(N[i]),
                int(bw[i]), kmer_half,
            )
            for i in range(R)
        ]
    ch = np.ascontiguousarray(choices, dtype=np.uint8)
    pm = np.ascontiguousarray(PM, dtype=np.float32)
    pe = np.ascontiguousarray(PE, dtype=np.float32)
    bs = np.ascontiguousarray(bstart, dtype=np.int32)
    T32 = np.ascontiguousarray(T, dtype=np.int32)
    N32 = np.ascontiguousarray(N, dtype=np.int32)
    bw32 = np.ascontiguousarray(bw, dtype=np.int32)
    max_seg = int(N32.max())
    out_b = np.empty((R, max_seg), dtype=np.int32)
    out_s = np.empty((R, max_seg), dtype=np.int32)
    out_m = np.empty((R, max_seg), dtype=np.float64)
    counts = np.empty(R, dtype=np.int64)
    lib.banded_traceback_batch(
        ch, pm, pe, bs, R, T_pad, B, T32, N32, bw32, kmer_half, max_seg,
        out_b, out_s, out_m, counts,
    )
    return [
        _as_segments(int(counts[i]), out_b[i], out_s[i], out_m[i]) for i in range(R)
    ]


def _banded_traceback_py(choices, PM, PE, bstart, T, N, bw, kmer_half):
    t, n = T - 1, N - 1
    j = bw + 1
    is_m = False
    probs: list[float] = []
    segments: list[tuple[str, int, int, float]] = []
    while t and n:
        s = int(bstart[t] != bstart[t - 1])
        if is_m:
            probs.append(float(PM[t, j]))
            segments.append(("M", n - 1 + kmer_half, t - 1, float(np.median(probs))))
            probs.clear()
            t -= 1
            n -= 1
            j = j - 1 + s
            is_m = False
        else:
            probs.append(float(PE[t, j]))
            is_m = bool(choices[t, j])
            t -= 1
            j = j + s
    segments.reverse()
    return segments


def nt_traceback(choices, PM, PE, kmer_size):
    """Full-lattice MAP walk (ref: NT.cpp:146-177) over probabilities."""
    lib = get_lib()
    kmer_half = kmer_size // 2
    T, N = choices.shape
    if lib is not None:
        ch = np.ascontiguousarray(choices, dtype=np.uint8)
        pm = np.ascontiguousarray(PM, dtype=np.float32)
        pe = np.ascontiguousarray(PE, dtype=np.float32)
        out_b = np.empty(N, dtype=np.int32)
        out_s = np.empty(N, dtype=np.int32)
        out_m = np.empty(N, dtype=np.float64)
        nseg = lib.nt_traceback(ch, pm, pe, T, N, kmer_half, out_b, out_s, out_m)
        return _as_segments(nseg, out_b, out_s, out_m)
    t, n = T - 1, N - 1
    is_m = False
    probs: list[float] = []
    segments: list[tuple[str, int, int, float]] = []
    while t and n:
        if is_m:
            probs.append(float(PM[t, n]))
            segments.append(("M", n - 1 + kmer_half, t - 1, float(np.median(probs))))
            probs.clear()
            t -= 1
            n -= 1
            is_m = False
        else:
            probs.append(float(PE[t, n]))
            is_m = bool(choices[t, n])
            t -= 1
    segments.reverse()
    return segments


def _bind_ntc(lib):
    import ctypes

    if getattr(lib, "_ntc_bound", False):
        return
    c_i64 = ctypes.c_int64
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.ntc_traceback.restype = c_i64
    lib.ntc_traceback.argtypes = [
        f64p, f64p, i32p, i32p, u8p,
        c_i64, c_i64, c_i64, c_i64, c_i64, c_i64, c_i64, c_i64,
        i32p, i32p, i32p, f64p, i32p,
    ]
    lib._ntc_bound = True


def ntc_traceback_native(apsei, logp, cand_n, ks, allowed, T, N, K,
                         alphabet_size, kmer_size, start_k):
    """5-state NTC walk over the candidate-slot layout (ref:
    NTC.cpp:691-904). Returns [(state01, basepos, start, median, polish_k)]
    in read order, or None if the native library is unavailable or the walk
    hits an inconsistency (caller falls back to Python)."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_ntc(lib)
    ap = np.ascontiguousarray(apsei, dtype=np.float64)
    lp = np.ascontiguousarray(logp, dtype=np.float64)
    cn = np.ascontiguousarray(cand_n, dtype=np.int32)
    kk = np.ascontiguousarray(ks, dtype=np.int32)
    al = np.ascontiguousarray(allowed, dtype=np.uint8)
    CN, CK = cn.shape[1], kk.shape[1]
    cap = int(T + N + 8)
    out_state = np.empty(cap, np.int32)
    out_basepos = np.empty(cap, np.int32)
    out_start = np.empty(cap, np.int32)
    out_median = np.empty(cap, np.float64)
    out_polish = np.empty(cap, np.int32)
    nseg = lib.ntc_traceback(
        ap, lp, cn, kk, al, T, N, K, CN, CK, alphabet_size, kmer_size,
        start_k, out_state, out_basepos, out_start, out_median, out_polish,
    )
    if nseg < 0:
        return None
    return [
        (int(out_state[i]), int(out_basepos[i]), int(out_start[i]),
         float(out_median[i]), int(out_polish[i]))
        for i in range(nseg)
    ]


def summaries_csv_native(
    prefix: str,
    starts_row,
    medians_row,
    N: int,
    read: str,
    kmer_size: int,
    rna: bool,
    sig_offset: int,
    last_index: int,
) -> bytes | None:
    """Device summaries -> CSV bytes (byte-identical to the Python
    formatter); None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts_row, np.int32)
    medians = np.ascontiguousarray(medians_row, np.float32)
    n = int(N)
    cap = (len(prefix) + 96 + 2 * kmer_size) * max(1, n) + 16
    buf = ctypes.create_string_buffer(cap)
    written = lib.summaries_to_csv(
        prefix.encode(), starts, medians, n, read.encode(), len(read),
        kmer_size, int(rna), sig_offset, last_index, buf, cap,
    )
    if written < 0:
        return None
    return buf.raw[:written]

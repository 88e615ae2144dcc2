"""Build and load the CUDA kernels of `csrc/`.

The kernels are plain CUDA C++ with an `extern "C"` interface: one nvcc
per source file, all started together, compiles an object each, and one
more nvcc links them into a shared library, which ctypes loads. No
PyTorch header is compiled, so a build takes seconds instead of the
minutes a torch.utils.cpp_extension build takes.

The library is built at first use into `_kernels_build/` beside this file
(listed in .gitignore; override with DYNAMONT_TORCH_BUILD_DIR), under a
name keyed by a hash of the sources and flags. It is written to a
temporary name and renamed into place, so processes sharing the directory
never load a half-written library.

Flags: `sm_90a` (Hopper); no --use_fast_math, and -fmad=false so that
`c1 - c2*d*d` and every other product-then-sum rounds exactly as the
plain-torch versions (separate elementwise ops) round it. The Viterbi
choice bit and the traceback depend on exact float equality.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-fmad=false", "-Xptxas", "-v", "-c"]
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]

_lock = threading.Lock()
_lib = None
# what the last build printed (ptxas registers/spills per kernel) and took
build_log = ""
build_seconds = 0.0


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def build_dir() -> str:
    return os.environ.get("DYNAMONT_TORCH_BUILD_DIR",
                          os.path.join(_PKG_DIR, "_kernels_build"))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def library_path() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir(), f"libdynamont_kernels_{h.hexdigest()[:16]}.so")


def _nvcc(cmds: list[list[str]]) -> str:
    """Run the nvcc commands side by side; their joined output, or a
    RuntimeError naming the first that failed once all have ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    done = [(cmd, *p.communicate(), p.returncode) for cmd, p in procs]
    for cmd, out, err, rc in done:
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}{err}")
    return "".join(out + err for _, out, err, _ in done)


def _compile(out: str) -> None:
    global build_log, build_seconds
    import time

    os.makedirs(os.path.dirname(out), exist_ok=True)
    nvcc = find_nvcc()
    sources = [s for s in _sources() if s.endswith(".cu")]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in sources]
        log = _nvcc([[nvcc, *COMPILE_FLAGS, "-o", o, s]
                     for s, o in zip(sources, objs)])
        lib = os.path.join(tmp, "kernels.so")
        log += _nvcc([[nvcc, *LINK_FLAGS, "-o", lib, *objs]])
        os.replace(lib, out)
    build_seconds = time.perf_counter() - t0
    build_log = log

def load() -> ctypes.CDLL:
    """The kernel library, built on first call (thread-safe)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            _lib = ctypes.CDLL(path)
    return _lib

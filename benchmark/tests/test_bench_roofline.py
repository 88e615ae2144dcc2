"""The roofline groups' counts against hand counts, and their kernel names
against the program's sources."""

import glob
import os

from conftest import ROOT

from benchmark.harness.main import load_file


def _group(name):
    return load_file(os.path.join(ROOT, "benchmark", "roofline", f"{name}.py"),
                     f"roofline_{name}")


def test_banded_counts_one_short_read():
    g = _group("banded")
    # 10 samples, 4 k-mers: T 11, N 5, band min(200, 2) = 2 -> 7 columns
    ops, nbytes = g.counts(11, 5, band=400, itemsize=4)
    assert ops == 40 * 11 * 7 + 16 * 11
    # signal 10 x 4 B, mean/c1/c2 of 4 positions, starts and medians of 5
    # bases, Zf and Zb
    assert nbytes == 40 + 48 + 40 + 8
    # a long read's band stops at 200 each side
    ops, _ = g.counts(20001, 1001, band=400, itemsize=4)
    assert ops == 40 * 20001 * 403 + 16 * 20001


def test_kernel_names_exist_in_the_sources():
    src = "".join(open(p).read() for p in glob.glob(
        os.path.join(ROOT, "dynamont_tpu_torch", "csrc", "*.cu")))
    for path in glob.glob(os.path.join(ROOT, "benchmark", "roofline", "*.py")):
        g = _group(os.path.basename(path)[:-3])
        for k in g.KERNELS:
            assert f"{k}(" in src, k


def test_ntc_counts_one_short_read():
    g = _group("ntc")
    # 10 samples, 4 k-mers, the 1,024 5-mers: T 11, N 5; a TN cell 16 + 23,
    # a TK cell 18 + 25, one lattice cell a row 340
    ops, nbytes = g.counts(11, 5, K=1024, itemsize=8)
    assert ops == 11 * (39 * 5 + 43 * 1024 + 340) == 490237
    # signal 10 x 8 B, 4 k-mer ids, mean/c1/c2 of 1,024 k-mers, 5 segments
    # of four int32 and a median
    assert nbytes == 80 + 16 + 3 * 1024 * 8 + 5 * 24
    # float32 halves what the precision holds, not the operations
    ops32, nbytes32 = g.counts(11, 5, K=1024, itemsize=4)
    assert ops32 == ops and nbytes32 == 40 + 16 + 3 * 1024 * 4 + 5 * 20

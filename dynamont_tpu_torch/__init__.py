"""dynamont-tpu-torch: the PyTorch + CUDA port of dynamont_tpu.

The JAX package `dynamont_tpu` is the reference; this package mirrors its
module names so each counterpart is found at the same path:

  ops/nt_banded_batch.py    plain-torch banded DP (CPU path, kernel oracles)
  ops/nt_banded_kernels.py  CUDA wrappers of the five banded kernels
                            (counterpart of ops/nt_banded_pallas.py and of
                            the kernel in ops/nt_banded_train.py)
  ops/nt_banded_device.py   wire format, on-device decode, device entry
  ops/nt_banded_train.py    batched Baum-Welch estimates (training op)
  ops/nt_banded.py          exact per-read banded DP (the fp64 rung)
  ops/nt_full.py            dense 2-state lattice (the per-read TN pass)
  ops/ntc_pre.py, ntc_dp.py, ntc_viterbi.py, ntc_train.py
                            exact per-read NTC: pre-passes, 5-state DP,
                            MAP walk, Baum-Welch updates
  ops/ntc_batch.py          batched NTC pre-pass and candidate selection
  ops/ntc_pre_kernels.py    CUDA wrappers of the four pre-pass kernels
                            (counterpart of ops/ntc_pre_pallas.py)
  models/                   parameters, per-read and batched engines,
                            models/ntc.py the per-read NTC (run_ntc)
  training/trainer.py       the basic-mode training driver
  cli/resquiggle.py         dynamont-resquiggle --mode basic
  cli/train.py              dynamont-train --mode basic
  cli/ntc_main.py           dynamont-NTC (single read, stdin protocol)
  csrc/                     CUDA C++ kernels, built with nvcc at first use
                            (see _build.py)

Host code without JAX (pore models, k-mers, geometry, packing, readers,
CSV writers, the native library) is imported from `dynamont_tpu`, never
copied. This package imports `torch` and never `jax`. Importing it
compiles nothing: the kernels build on first launch.
"""

__version__ = "0.1.0"

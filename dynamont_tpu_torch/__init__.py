"""dynamont-tpu-torch: the PyTorch + CUDA port of dynamont_tpu.

The JAX package `dynamont_tpu` is the reference; this package mirrors its
module names so each counterpart is found at the same path:

  ops/nt_banded_batch.py    plain-torch banded DP (CPU path, kernel oracles)
                            and the matrix route (banded_batch_run)
  ops/nt_banded_kernels.py  CUDA wrappers of the six banded kernels K1-K6
                            (counterpart of ops/nt_banded_pallas.py and of
                            the kernel in ops/nt_banded_train.py)
  ops/nt_banded_device.py   wire format, on-device decode, device entry
  ops/nt_banded_train.py    batched Baum-Welch estimates (training op)
  ops/nt_banded.py          exact per-read banded DP (the fp64 rung)
  ops/nt_full.py            dense 2-state lattice (the per-read TN pass)
  ops/ntc_pre.py, ntc_dp.py, ntc_viterbi.py, ntc_train.py
                            exact per-read NTC: pre-passes, 5-state DP,
                            MAP walk, Baum-Welch updates
  ops/ntc_batch.py          batched NTC: pre-pass and candidate selection,
                            plan, the lattice's and training's plain versions
  ops/ntc_pre_kernels.py    CUDA wrappers of the four pre-pass kernels K7-K10
                            (counterpart of ops/ntc_pre_pallas.py)
  ops/ntc_kernels.py        CUDA wrappers of the lattice kernels K11-K16
                            and #12 (counterpart of ops/ntc_pallas.py)
  ops/ntc_train_kernels.py  CUDA wrappers of the NTC training kernels K17,
                            K18 (the Baum-Welch kernels of ops/ntc_pallas.py)
  ops/ntc_walk.py           the batched NTC traceback records
  ops/ntc_probe_kernels.py  CUDA wrappers of the probe kernels #19-#21
  probes/                   the K13 timing probes (counterparts of the TPU
                            probes scripts/probe_ntc_*.py)
  models/                   parameters, per-read and batched engines:
                            batch.py (basic mode), ntc_batch.py (resquiggle
                            mode), nt.py / nt_banded.py / ntc.py per read
  training/trainer.py       the training driver, both modes
  cli/resquiggle.py         dynamont-resquiggle --mode basic|resquiggle
  cli/train.py              dynamont-train --mode basic|resquiggle
  cli/ntc_main.py           dynamont-NTC (single read, stdin protocol)
  cli/nt_main.py, nt_banded_main.py
                            dynamont-NT, dynamont-NT-banded (single read)
  csrc/                     CUDA C++ kernels, built with nvcc at first use
                            (see _build.py)

Host code without JAX (constants, pore models, k-mers, geometry, packing,
readers, CSV writers, the native library and the model tables) is kept as
this package's own copy of the JAX package's module, never imported from
`dynamont_tpu`; tests/test_torch_isolation.py holds the copies equal and
scans the imports. This package imports `torch` and never `jax`.
Importing it compiles nothing: the kernels build on first launch.
"""

__version__ = "0.1.0"

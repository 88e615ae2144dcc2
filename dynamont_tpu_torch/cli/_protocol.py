"""Shared stdin/stdout protocol for the single-read CLIs.

Contract (ref: NT_main.cpp:77-123, README.md:106-122):
  stdin line 1: comma-separated signal values
  stdin line 2: read (processing orientation)
  exit codes: 3 Z mismatch, 4 signal missing, 5 read missing, 6 model kmer
  length mismatch, 7 bad model path, 8-11 input size violations; the
  port's own, NO_CUDA_EXIT, for --device cuda without a CUDA device.
"""

from __future__ import annotations

import os
import sys

import numpy as np


# the protocol's codes: 1/2 NTC pre-pass Z mismatch, 3 Z mismatch, 4-11
# input and model errors; this one is the port's
NO_CUDA_EXIT = 12


def device_or_exit(name: str):
    """torch.device(name); without a CUDA device, --device cuda exits
    NO_CUDA_EXIT instead of falling back to the CPU."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: torch sees no CUDA device (pass --device cpu "
              "to run the plain-torch path)", file=sys.stderr)
        raise SystemExit(NO_CUDA_EXIT)
    return device


def read_stdin_pair() -> tuple[np.ndarray, str]:
    signal_line = sys.stdin.readline().strip()
    read_line = sys.stdin.readline().strip()
    if not signal_line:
        print("Signal missing!", file=sys.stderr)
        raise SystemExit(4)
    if not read_line:
        print("Read missing!", file=sys.stderr)
        raise SystemExit(5)
    signal = np.array([float(x) for x in signal_line.split(",")], dtype=np.float64)
    return signal, read_line


def check_model_path(path: str) -> None:
    if not path or not os.path.exists(path):
        print(f"Please provide a valid modelpath: {path}", file=sys.stderr)
        raise SystemExit(7)


def load_model_or_exit(path: str, rna: bool):
    from dynamont_tpu_torch.utils.pore_model import load_pore_model

    check_model_path(path)
    try:
        return load_pore_model(path, rna)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        raise SystemExit(6)


def fmt(v: float) -> str:
    """std::fixed << setprecision(11) equivalent."""
    return f"{v:.11f}"


def print_train_output(trained_transitions: dict, trained_emissions: dict, Z: float) -> None:
    print(";".join(f"{k}:{fmt(v)}" for k, v in trained_transitions.items()))
    print("".join(f"{kmer}:{fmt(m)},{fmt(s)};" for kmer, (m, s) in trained_emissions.items()))
    print(f"Z:{fmt(Z)}")

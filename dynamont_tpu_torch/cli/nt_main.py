"""dynamont-NT on PyTorch: full-lattice 2-state segmentation of one read
from stdin (counterpart of dynamont_tpu/cli/nt_main.py; ref:
src/cpp/NT_main.cpp).

    echo "<sig csv>\\n<read>\\n" | python -m dynamont_tpu_torch.cli.nt_main \\
        -m <model> -r rna002 [-z | --train | -p] [--device cuda|cpu]

Same flags, stdin/stdout protocol, output formats and exit codes as the
JAX CLI, plus --device: it runs the exact fp64 full lattice
(models/nt.run_nt) on the device given. -t is accepted and unused.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser

from dynamont_tpu_torch.cli._protocol import NO_CUDA_EXIT


def build_parser() -> ArgumentParser:
    p = ArgumentParser(
        prog="dynamont-NT", description="dynamont basic (PyTorch)",
        epilog="exit codes: 3 Z mismatch, 4/5 signal/read missing, 6 model "
               "k-mer length, 7 model path, 8-11 input sizes, "
               f"{NO_CUDA_EXIT} --device cuda without a CUDA device")
    p.add_argument("-m", "--model", required=True, dest="model")
    p.add_argument(
        "-r", "--pore", required=True, dest="pore",
        choices=["rna002", "dna_r9", "rna004", "dna_r10_260bps", "dna_r10_400bps"],
    )
    p.add_argument("-m1", "--matchscore1", type=float, default=-1.0, dest="m1")
    p.add_argument("-e1", "--extendscore1", type=float, default=-1.0, dest="e1")
    p.add_argument("-e2", "--extendscore2", type=float, default=-1.0, dest="e2")
    p.add_argument("--train", action="store_true")
    p.add_argument("-z", "--calcZ", action="store_true", dest="calcZ")
    p.add_argument("-p", "--probabilty", action="store_true", dest="prob")
    p.add_argument("-t", type=int, default=1, dest="threads")  # accepted, unused
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain-torch "
                        f"path). Without a CUDA device, cuda exits "
                        f"{NO_CUDA_EXIT}.")
    return p


def run(args, run_read):
    """The protocol around `run_read(signal, read, model, overrides, mode,
    device)`, shared with dynamont-NT-banded: device, model, stdin, the run,
    and the output of its mode. Returns the NTResult."""
    from dynamont_tpu_torch.cli._protocol import (
        device_or_exit, fmt, load_model_or_exit, print_train_output,
        read_stdin_pair,
    )
    from dynamont_tpu_torch.constants import is_rna
    from dynamont_tpu_torch.models.nt import ZConsistencyError
    from dynamont_tpu_torch.utils.output import segments_to_string

    device = device_or_exit(args.device)
    model = load_model_or_exit(args.model, is_rna(args.pore))
    signal, read = read_stdin_pair()
    overrides = {"m1": args.m1, "e1": args.e1, "e2": args.e2}
    mode = "calcZ" if args.calcZ else ("train" if args.train else "segment")
    try:
        res = run_read(signal, read, model, overrides, mode, device)
    except ZConsistencyError as e:
        print(str(e), file=sys.stderr)
        raise SystemExit(3)

    if mode == "calcZ":
        print(fmt(res.Z))
    elif mode == "train":
        print_train_output(res.trained_transitions, res.trained_emissions, res.Z)
    else:
        print(segments_to_string(res.segments))
        if args.prob:
            print("".join(fmt(v) + "," for v in res.per_t_logprob))
    return res


def main(argv=None):
    """Runs the protocol; returns the NTResult (for in-process callers)."""
    args = build_parser().parse_args(argv)
    from dynamont_tpu_torch.models.nt import run_nt

    def run_read(signal, read, model, overrides, mode, device):
        return run_nt(signal, read, model, args.pore, overrides, mode=mode,
                      want_prob=args.prob, device=device)

    return run(args, run_read)


if __name__ == "__main__":
    main()

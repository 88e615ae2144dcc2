"""dynamont-NTC on PyTorch: 5-state resquiggle / error-correction of one
read from stdin (counterpart of dynamont_tpu/cli/ntc_main.py; ref:
src/cpp/NTC_main.cpp).

    echo "<sig csv>\\n<read>\\n" | python -m dynamont_tpu_torch.cli.ntc_main \\
        -m <model> -r rna002 [--device cuda|cpu]

Same flags, stdin/stdout protocol, output formats and exit codes as the
JAX CLI, plus --device. It runs the exact fp64 per-read path
(models/ntc.run_ntc) on the device given.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser

from dynamont_tpu_torch.cli._protocol import NO_CUDA_EXIT
from dynamont_tpu_torch.constants import NTK_PARAM_NAMES

_FLAG_NAMES = {
    "a1": "--alignscore1", "a2": "--alignscore2",
    "p1": "--polishscore1", "p2": "--polishscore2", "p3": "--polishscore3",
    "s1": "--sequencescore1", "s2": "--sequencescore2", "s3": "--sequencescore3",
    "e1": "--extendscore1", "e2": "--extendscore2", "e3": "--extendscore3",
    "e4": "--extendscore4", "i1": "--insertionscore1", "i2": "--insertionscore2",
}


def build_parser() -> ArgumentParser:
    p = ArgumentParser(
        prog="dynamont-NTC", description="dynamont resquiggle (PyTorch)",
        epilog="exit codes: 1/2 pre-pass Z mismatch (TN/TK), 3 Z mismatch, "
               "4/5 signal/read missing, 6 model k-mer length, 7 model path, "
               "8-11 input sizes, "
               f"{NO_CUDA_EXIT} --device cuda without a CUDA device")
    p.add_argument("-m", "--model", required=True, dest="model")
    p.add_argument(
        "-r", "--pore", required=True, dest="pore",
        choices=["rna002", "dna_r9", "rna004", "dna_r10_260bps", "dna_r10_400bps"],
    )
    for name in NTK_PARAM_NAMES:
        p.add_argument(f"-{name}", _FLAG_NAMES[name], type=float, default=-1.0,
                       dest=name)
    p.add_argument("--train", action="store_true")
    p.add_argument("-z", "--calcZ", action="store_true", dest="calcZ")
    p.add_argument("-p", "--probabilty", action="store_true", dest="prob")
    p.add_argument("-t", type=int, default=1, dest="threads")  # accepted, unused
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain-torch "
                        f"path). Without a CUDA device, cuda exits "
                        f"{NO_CUDA_EXIT}.")
    return p


def main(argv=None):
    """Runs the protocol; returns the NTCResult (for in-process callers)."""
    args = build_parser().parse_args(argv)

    from dynamont_tpu_torch.cli._protocol import (
        device_or_exit, fmt, load_model_or_exit, print_train_output,
        read_stdin_pair,
    )
    from dynamont_tpu_torch.constants import is_rna

    device = device_or_exit(args.device)
    model = load_model_or_exit(args.model, is_rna(args.pore))
    signal, read = read_stdin_pair()

    from dynamont_tpu_torch.models.ntc import (
        NTCPreprocessError, NTCZError, run_ntc,
    )

    overrides = {name: getattr(args, name) for name in NTK_PARAM_NAMES}
    mode = "calcZ" if args.calcZ else ("train" if args.train else "segment")
    try:
        res = run_ntc(signal, read, model, args.pore, overrides, mode=mode,
                      device=device)
    except (NTCPreprocessError, NTCZError) as e:
        print(str(e), file=sys.stderr)
        raise SystemExit(e.exit_code)

    if mode == "calcZ":
        print(fmt(res.Z))
    elif mode == "train":
        print_train_output(res.trained_transitions, res.trained_emissions, res.Z)
    else:
        print(
            "".join(
                f"{s[0]}{s[1]},{s[2]},{s[3]:.5f},{s[4]};" for s in res.segments
            )
        )
    return res


if __name__ == "__main__":
    main()

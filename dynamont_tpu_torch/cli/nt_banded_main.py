"""dynamont-NT-banded on PyTorch: banded 2-state segmentation of one read
from stdin (counterpart of dynamont_tpu/cli/nt_banded_main.py; ref:
src/cpp/NT_banded_main.cpp).

    echo "<sig csv>\\n<read>\\n" | python -m dynamont_tpu_torch.cli.nt_banded_main \\
        -m <model> -r rna002 [-b 400] [-z | --train | -p] [--device cuda|cpu]

dynamont-NT's flags and protocol plus -b/--band; it runs the exact fp64
banded rung (models/nt_banded.run_nt_banded) on the device given: the
fused kernels for the segments, the matrix route's for -p.
"""

from __future__ import annotations

from dynamont_tpu_torch.cli.nt_main import build_parser, run


def main(argv=None):
    """Runs the protocol; returns the NTResult (for in-process callers)."""
    p = build_parser()
    p.prog = "dynamont-NT-banded"
    p.add_argument("-b", "--band", type=int, default=400, dest="band")
    args = p.parse_args(argv)
    from dynamont_tpu_torch.models.nt_banded import run_nt_banded

    def run_read(signal, read, model, overrides, mode, device):
        return run_nt_banded(signal, read, model, args.pore, overrides, mode=mode,
                             want_prob=args.prob, band=args.band, device=device)

    return run(args, run_read)


if __name__ == "__main__":
    main()

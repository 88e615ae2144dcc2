"""Training-curve plots from params.csv (ref: FileIO.py:497-519
plotParameters + src/python/plot/plotTrainedParams.py)."""

from __future__ import annotations

import sys
from argparse import ArgumentParser
from os.path import join


def plot_parameters(param_file: str, outdir: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    try:
        import seaborn as sns

        sns.set_theme()
        line = lambda df, col: sns.lineplot(data=df, x="batch", y=col, hue="epoch")
    except ImportError:
        line = lambda df, col: plt.plot(df["batch"], df[col])

    df = pd.read_csv(param_file, sep=",")
    for column in df:
        if column in ("epoch", "batch", "read"):
            continue
        line(df, column)
        plt.title(f"{column} parameter change during training")
        plt.ylabel("Parameter Value")
        out = join(outdir, f"{column}.pdf")
        print("Savefig: ", out, file=sys.stderr)
        plt.savefig(out)
        plt.close()


def main(argv=None) -> None:
    p = ArgumentParser(prog="dynamont-plot-params")
    p.add_argument("-i", "--input", required=True, help="params.csv from training")
    p.add_argument("-o", "--outdir", required=True)
    args = p.parse_args(argv)
    plot_parameters(args.input, args.outdir)


if __name__ == "__main__":
    main()

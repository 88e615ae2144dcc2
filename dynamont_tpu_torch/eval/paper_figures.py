"""Paper-grade figure/table generators over the collected metrics CSVs
(ref: src/python/misc/csv_to_tex.py, csv_to_ms_heatmap.py,
compareDatasets.py — the reference scripts hardcode dataset paths; these
take them as arguments).

Input schema: the long-format CSV from dynamont-collect-metrics
(`Tool,Value,Metric[,Metric Score]`). The per-metric normalized score
(value / max over tools; inverted for cost-like metrics) follows
collectMetrics.py:155-174.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser

import numpy as np

# metrics where smaller is better -> score inverted (ref: collectMetrics.py:174)
INVERTED_METRICS = {"homogeneity", "missing", "truncated", "nt_changed",
                    "min_length", "missing reads", "truncated reads",
                    "nt changed", "min length"}
# metrics entering the aggregated score (ref: csv_to_tex.py:34-52)
AGG_METRICS = [
    "median delta", "mad delta", "homogeneity", "segmented reads",
    "truncated reads", "min length", "n50 length", "max length",
    "flye total length", "flye n50", "flye mean coverage",
    "svim structural variants",
]
METRIC_RENAMES = {
    "total": "total reads", "truncated": "truncated reads",
    "identical": "identical reads", "present": "segmented reads",
    "missing": "missing reads",
}


def load_metrics(path: str):
    """Metrics CSV -> tidy DataFrame with canonical metric names and a
    `Metric Score` column (computed here if absent)."""
    import pandas as pd

    sep = "\t" if open(path).readline().count("\t") else ","
    df = pd.read_csv(path, sep=sep)
    df["Metric"] = (
        df["Metric"].astype(str).str.replace("_", " ").str.lower()
    )
    df["Metric"] = df["Metric"].replace(METRIC_RENAMES)
    if "Metric Score" not in df.columns:
        df["Metric Score"] = compute_metric_scores(df)
    return df


def compute_metric_scores(df):
    """value / max-over-tools per metric, inverted for cost-like metrics,
    non-numeric rows 0 (ref: collectMetrics.py:155-174)."""
    import pandas as pd

    vals = pd.to_numeric(df["Value"], errors="coerce")
    num = df.assign(_v=vals)
    score = num.groupby("Metric")["_v"].transform(
        lambda x: x / x.max() if x.max() and x.max() > 0 else 0.0
    )
    score = score.fillna(0.0)
    inv = df["Metric"].isin(INVERTED_METRICS)
    score = score.where(~inv, 1.0 - score)
    return score


def aggregated_scores(df):
    """Per-tool sum of scores over the AGG_METRICS subset."""
    sub = df[df["Metric"].isin(AGG_METRICS)]
    return sub.groupby("Tool")["Metric Score"].sum()


def metrics_to_latex(input_csv: str, output_tex: str | None = None) -> str:
    """Pivoted LaTeX results table with `score_{value}` cells, per-row max
    highlighted, aggregated-score footer (ref: csv_to_tex.py:18-177)."""
    import pandas as pd

    df = load_metrics(input_csv)
    agg = aggregated_scores(df)

    def combined(row):
        v = row["Value"]
        try:
            vtxt = f"{float(v):.1f}"
        except (TypeError, ValueError):
            vtxt = str(v)
        return f"${row['Metric Score']:.3f}_{{~{vtxt}}}$"

    df = df.assign(Combined=df.apply(combined, axis=1))
    pivot = df.pivot_table(
        index="Metric", columns="Tool", values="Combined", aggfunc="first"
    )
    scores = df.pivot_table(
        index="Metric", columns="Tool", values="Metric Score", aggfunc="first"
    )
    for metric in pivot.index:
        row = scores.loc[metric]
        if row.dropna().empty:
            continue
        for tool in row[row == row.max()].index:
            if pd.notna(pivot.at[metric, tool]):
                pivot.at[metric, tool] = (
                    "\\cellcolor{green!15}" + pivot.at[metric, tool]
                )
    footer = {}
    for tool in pivot.columns:
        val = agg.get(tool, 0.0)
        cell = f"{val:.2f}"
        if len(agg) and val == agg.max():
            cell = "\\cellcolor{green!15}" + cell
        footer[tool] = cell
    pivot.loc["aggregated metric score"] = pd.Series(footer)
    keep = [m for m in AGG_METRICS if m in pivot.index]
    pivot = pivot.loc[keep + ["aggregated metric score"]]
    latex = pivot.to_latex(na_rep="-", escape=False)
    if output_tex:
        with open(output_tex, "w") as f:
            f.write(latex)
        print(f"wrote {output_tex}", file=sys.stderr)
    return latex


def metric_score_heatmap(dataset_csvs: list, outfile: str) -> None:
    """Tool x Dataset heatmap of aggregated metric scores with averages
    (ref: csv_to_ms_heatmap.py:98-234). dataset_csvs: [(name, path)]."""
    import pandas as pd

    rows = []
    for name, path in dataset_csvs:
        agg = aggregated_scores(load_metrics(path))
        for tool, score in agg.items():
            rows.append((tool, name, score))
    df = pd.DataFrame(rows, columns=["Tool", "Dataset", "Metric Score"])
    mat = df.pivot(index="Tool", columns="Dataset", values="Metric Score")
    mat["tool average"] = mat.mean(axis=1)
    mat.loc["dataset average"] = mat.mean(axis=0)
    order = mat["tool average"].sort_values(ascending=False).index
    mat = mat.loc[order]

    from dynamont_tpu_torch.eval.figures import _plt

    plt = _plt()
    fig, ax = plt.subplots(
        figsize=(1.2 * len(mat.columns) + 3, 0.5 * len(mat) + 2), dpi=150
    )
    im = ax.imshow(mat.values, cmap="viridis", aspect="auto")
    ax.set_xticks(range(len(mat.columns)))
    ax.set_xticklabels(mat.columns, rotation=45, ha="right", fontsize=8)
    ax.set_yticks(range(len(mat.index)))
    ax.set_yticklabels(mat.index, fontsize=8)
    for (y, x), v in np.ndenumerate(mat.values):
        if np.isfinite(v):
            ax.text(x, y, f"{v:.2f}", ha="center", va="center", fontsize=7,
                    color="w" if v < np.nanmax(mat.values) * 0.6 else "k")
    fig.colorbar(im, ax=ax, label="aggregated metric score")
    ax.set_title("Aggregated metric score per tool and dataset")
    fig.tight_layout()
    fig.savefig(outfile)
    plt.close(fig)
    print(f"wrote {outfile}", file=sys.stderr)


def compare_datasets(score_csvs: list, out_prefix: str) -> None:
    """Cross-dataset segment-quality comparison (ref: compareDatasets.py):
    per-tool median contrast (Median Delta) and homogeneity boxes across
    datasets. score_csvs: [(dataset, path)] of Tool,Score,Segment Quality
    CSVs from the signal-scoring pass (compare_tools.score_tools)."""
    import pandas as pd

    frames = []
    for name, path in score_csvs:
        df = pd.read_csv(path)
        df["Dataset"] = name
        frames.append(df)
    data = pd.concat(frames, ignore_index=True)

    from dynamont_tpu_torch.eval.figures import _plt

    plt = _plt()
    for quality, fname in [
        ("Median Delta", "contrast"), ("Homogeneity", "homogeneity"),
    ]:
        sub = data[data["Segment Quality"] == quality]
        if sub.empty:
            continue
        med = sub.groupby(["Tool", "Dataset"])["Score"].median().unstack()
        fig, ax = plt.subplots(figsize=(8, 4.5), dpi=150)
        x = np.arange(len(med.index))
        width = 0.8 / max(1, len(med.columns))
        for ci, ds in enumerate(med.columns):
            ax.bar(x + ci * width, med[ds].values, width, label=ds)
        ax.set_xticks(x + 0.4 - width / 2)
        ax.set_xticklabels(med.index, rotation=45, ha="right", fontsize=8)
        ax.set_ylabel(f"median {quality.lower()}")
        ax.legend(fontsize=8, title="dataset")
        ax.set_title(f"{quality} across datasets")
        fig.tight_layout()
        out = f"{out_prefix}_{fname}.png"
        fig.savefig(out)
        plt.close(fig)
        print(f"wrote {out}", file=sys.stderr)


def main(argv=None) -> None:
    p = ArgumentParser(prog="dynamont-paper-figures")
    sub = p.add_subparsers(dest="cmd", required=True)
    s1 = sub.add_parser("tex", help="metrics CSV -> LaTeX results table")
    s1.add_argument("-i", "--input", required=True)
    s1.add_argument("-o", "--output", required=True)
    s2 = sub.add_parser("heatmap", help="metric-score heatmap over datasets")
    s2.add_argument("-d", "--dataset", action="append", nargs=2, required=True,
                    metavar=("NAME", "CSV"))
    s2.add_argument("-o", "--output", required=True)
    s3 = sub.add_parser("datasets", help="cross-dataset quality figures")
    s3.add_argument("-d", "--dataset", action="append", nargs=2, required=True,
                    metavar=("NAME", "SCORE_CSV"))
    s3.add_argument("-o", "--out-prefix", required=True)
    args = p.parse_args(argv)

    if args.cmd == "tex":
        metrics_to_latex(args.input, args.output)
    elif args.cmd == "heatmap":
        metric_score_heatmap(args.dataset, args.output)
    else:
        compare_datasets(args.dataset, args.out_prefix)


if __name__ == "__main__":
    main()

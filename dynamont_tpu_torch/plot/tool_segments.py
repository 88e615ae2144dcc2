"""Multi-tool segmentation overlay for a single read
(ref: src/python/plot/plotToolSegments.py:16-279).

One panel per tool (dynamont / uncalled4 / f5c resquiggle / f5c eventalign /
dorado moves / tombo), each drawing the raw signal with that tool's segment
borders and base-colored segment rectangles. Unlike the reference (which
requires all five inputs), every tool flag here is optional — panels are
rendered for whatever was given — and tombo (commented out in the
reference) is wired in through the fast5 border reader. Signal comes from
pod5 via read5_ont when available, or from the TSV source this image uses.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser
from os.path import join, splitext

import numpy as np

from dynamont_tpu_torch.plot import readers as rd

# per-base colors (ref: plotToolSegments.py:169-176)
BASECOLORS = {
    "A": "#377eb8", "C": "#ff7f00", "G": "#4daf4a",
    "T": "#f781bf", "U": "#f781bf", "N": "#ffffff",
}


def parse(argv=None):
    p = ArgumentParser(
        prog="dynamont-plot-tool-segments",
        description="Overlay segmentations of one read by multiple tools",
    )
    p.add_argument("--dynamont", metavar="CSV", help="dynamont CSV (may be .zst)")
    p.add_argument("--uncalled4", metavar="TSV")
    p.add_argument("--f5cresquiggle", metavar="TSV")
    p.add_argument("--f5ceventalign", metavar="TSV",
                   help="summary .sum file must exist next to it")
    p.add_argument("--dorado", metavar="TSV",
                   help="move table from `dynamont-convert dorado-moves`")
    p.add_argument("--tombo", metavar="DIR",
                   help="single-fast5 directory processed by tombo resquiggle")
    p.add_argument("--basecalls", metavar="BAM",
                   help="basecalled BAM (for the f5c-resquiggle base lookup)")
    p.add_argument("--read", metavar="STR",
                   help="basecalled sequence (alternative to --basecalls)")
    p.add_argument("--pod5", metavar="POD5", help="raw signal file")
    p.add_argument("--tsv", metavar="TSV",
                   help="raw signal TSV (readid\\tsignalid\\tsig,csv\\tread)")
    p.add_argument("--readid", required=True, metavar="ID")
    p.add_argument("-k", type=int, default=5, metavar="INT", help="kmer length")
    p.add_argument("-o", "--out", required=True, metavar="DIR")
    p.add_argument("--region", metavar="START:END",
                   help="also render a zoomed panel over this signal range")
    p.add_argument("--formats", default="svg,pdf,png",
                   help="comma-separated output formats")
    return p.parse_args(argv)


def _load_signal_and_read(args) -> tuple[np.ndarray, str]:
    if args.tsv:
        with rd._open_maybe_zst(args.tsv) as f:
            for line in f:
                rid, _, sig_csv, read = line.rstrip("\n").split("\t")
                if rid == args.readid:
                    sig = np.array([float(x) for x in sig_csv.split(",")])
                    return sig, read
        raise SystemExit(f"readid {args.readid} not in {args.tsv}")
    if not args.pod5:
        raise SystemExit("need --pod5 or --tsv for the raw signal")
    import read5_ont

    read = args.read or ""
    signalid = args.readid
    if args.basecalls:
        import pysam

        with pysam.AlignmentFile(args.basecalls, "rb", check_sq=False) as bam:
            for rec in bam.fetch(until_eof=True):
                if rec.query_name == args.readid:
                    read = rec.query_sequence
                    if rec.has_tag("pi"):
                        signalid = rec.get_tag("pi")
                    break
    r5 = read5_ont.read(args.pod5)
    try:
        sig = r5.getpASignal(args.readid)
    except Exception:
        sig = r5.getSignal(signalid)
    return np.asarray(sig, np.float64), read


def collect_tools(args, read: str) -> dict[str, list]:
    """{tool name: sorted unique [(start, end, base)]}, only for the inputs
    that were provided."""
    tools: dict[str, list] = {}
    if args.dynamont:
        tools["Dynamont"] = rd.read_dynamont(args.dynamont, args.readid)
    if args.uncalled4:
        tools["Uncalled4"] = rd.read_uncalled4(args.uncalled4, args.readid)
    if args.f5cresquiggle:
        tools["f5c Resquiggle"] = rd.read_f5c_resquiggle(
            args.f5cresquiggle, args.readid, read, args.k
        )
    if args.f5ceventalign:
        tools["f5c Eventalign"] = rd.read_f5c_eventalign(
            args.f5ceventalign,
            splitext(args.f5ceventalign)[0] + ".sum", args.readid,
        )
    if args.dorado:
        tools["Dorado"] = rd.read_dorado(args.dorado, args.readid)
    if args.tombo:
        borders = rd.read_tombo_borders(args.tombo).get(args.readid)
        if borders is not None and len(borders) > 1:
            tools["Tombo"] = [
                (int(a), int(b), "N", "N")
                for a, b in zip(borders[:-1], borders[1:])
            ]
        else:
            tools["Tombo"] = []
    return {
        k: sorted({(int(s[0]), int(s[1]), str(s[2]).upper()) for s in v})
        for k, v in tools.items()
    }


def plot_panels(signal, tools, out_base: str, formats, region=None,
                title="Segmentation of the same read by different tools"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    n = len(tools)
    zoomed = region is not None
    lo, hi = region if zoomed else (0, len(signal))
    fig, ax = plt.subplots(
        nrows=n, figsize=(10 if zoomed else 110, 3 * n),
        dpi=120, squeeze=False,
    )
    ax = ax[:, 0]
    fig.suptitle(title)
    fig.supylabel("Current (pA)")
    fig.supxlabel("Rel. Time (Sequencing Data Points)")
    ymin, ymax = float(np.min(signal)), float(np.max(signal))
    for i, (tool, segments) in enumerate(tools.items()):
        ax[i].plot(signal, linewidth=1.0, c="black")
        ax[i].set_xlim((lo, hi))
        ax[i].set_title(tool)
        for s in segments:
            start, end, base = int(s[0]), int(s[1]), str(s[2])
            if zoomed and (end < lo or start > hi):
                continue
            color = BASECOLORS.get(base, "#999999")
            ax[i].vlines([start, end], ymin=ymin, ymax=ymax, colors=color,
                         linestyles="--", linewidth=0.7)
            ax[i].add_patch(Rectangle((start, ymin), end - start,
                                      ymax - ymin, alpha=0.4,
                                      edgecolor=color, facecolor=color))
    plt.tight_layout()
    for fmt in formats:
        plt.savefig(f"{out_base}.{fmt}", dpi=120)
    plt.close()
    print(f"Plotted: {out_base}.{formats[0]}", file=sys.stderr)


def main(argv=None) -> None:
    args = parse(argv)
    signal, read = _load_signal_and_read(args)
    tools = collect_tools(args, read)
    if not tools:
        raise SystemExit("no tool segmentation inputs given")
    os.makedirs(args.out, exist_ok=True)
    formats = [f.strip() for f in args.formats.split(",") if f.strip()]
    plot_panels(signal, tools,
                join(args.out, f"{args.readid}_tool_segmentation"), formats)
    if args.region:
        lo, hi = (int(x) for x in args.region.split(":"))
        plot_panels(
            signal, tools,
            join(args.out, f"{args.readid}_tool_segmentation_region"),
            formats, region=(lo, hi),
            title=f"Segmentation of {args.readid} by Different Tools",
        )


if __name__ == "__main__":
    main()

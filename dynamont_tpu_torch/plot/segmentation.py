"""Per-read segmentation plot (ref: src/python/plot/plotSegmentation.py;
counterpart of dynamont_tpu/plot/segmentation.py).

Draws the normalized signal with base-colored segment rectangles, border
lines, motif labels, model mean +- stdev bands, and (optionally) the
posterior border-probability track and a second overlay panel for an
external (e.g. f5c) segmentation. The CLI segments its read with the
port's banded engine on --device (default cuda).
"""

from __future__ import annotations

import sys

import numpy as np

BASE_COLORS = {  # ref: plotSegmentation.py:51-64
    "A": "#377eb8", "a": "#377eb8",
    "C": "#ff7f00", "c": "#ff7f00",
    "G": "#4daf4a", "g": "#4daf4a",
    "T": "#f781bf", "t": "#f781bf",
    "U": "#f781bf", "u": "#f781bf",
    "N": "#ffffff", "n": "#ffffff",
}


def plot_borders(
    norm_signal: np.ndarray,
    rows,
    read: str,
    readid: str,
    outpath: str,
    model=None,
    border_probs: np.ndarray | None = None,
    overlay=None,
    overlay_label: str = "overlay segmentation",
):
    """rows: output rows [start, end, basepos, base, motif, state, prob,
    polish] (5'->3' coordinates, as in the CSV). overlay: same-shaped list
    of (start, end, base, motif) tuples from plot.readers."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    try:
        import seaborn as sns

        sns.set_theme()
    except ImportError:
        pass

    lb, ub = -5, 3
    n_plots = 1 + (overlay is not None) + (border_probs is not None)
    fig, ax = plt.subplots(
        nrows=n_plots, figsize=(max(20, len(norm_signal) // 100), 10), dpi=200
    )
    if n_plots == 1:
        ax = [ax]
    fig.suptitle(f"{readid} segmentation in 3' -> 5' orientation")

    sig_axes = [0] + ([1] if overlay is not None else [])
    for axis in sig_axes:
        ax[axis].plot(norm_signal, color="black", label="Normalized Signal",
                      linewidth=0.8)
        ax[axis].set_ylim((lb, ub))
        ax[axis].set_ylabel("Normalized pA Signal")

    def draw(axis, segs):
        for start, end, base, motif in segs:
            color = BASE_COLORS.get(base, "#999999")
            ax[axis].text(
                start + (end - start) / 2 - 6, -3.5, motif,
                fontdict={"size": 6, "color": "black"}, rotation=90,
            )
            ax[axis].vlines([start], ymin=lb, ymax=ub, colors=color,
                            linestyles="--", linewidth=0.7)
            ax[axis].add_patch(
                Rectangle((start, lb), end - start, ub - lb, alpha=0.4,
                          edgecolor=color, facecolor=color)
            )

    main_segs = [(int(r[0]), int(r[1]), str(r[3]), str(r[4])) for r in rows]
    draw(0, main_segs)

    # model mean +- stdev band per segment
    if model is not None:
        from dynamont_tpu_torch.utils.kmer import seq_to_kmer_ids

        for r in rows:
            motif = str(r[4])
            if len(motif) != model.kmer_size:
                continue
            kid = int(seq_to_kmer_ids(
                motif[::-1] if model.rna else motif,
                model.kmer_size, model.alphabet_size)[0])
            mu, sd = float(model.means[kid]), float(model.stdevs[kid])
            ax[0].hlines(mu, int(r[0]), int(r[1]), colors="red", linewidth=1)
            ax[0].fill_between(
                [int(r[0]), int(r[1])], mu - sd, mu + sd, alpha=0.2,
                color="red", linewidth=0,
            )

    axis = 1 if overlay is not None else None
    if overlay is not None:
        draw(1, overlay)
        ax[1].set_title(overlay_label)

    if border_probs is not None:
        pax = ax[-1]
        pax.plot(np.exp(border_probs), linewidth=0.8)
        pax.set_ylabel("Border probability")

    fig.savefig(outpath, bbox_inches="tight")
    plt.close(fig)
    print(f"Saved {outpath}", file=sys.stderr)


def main(argv=None) -> None:
    """CLI: segment one read (TSV source) on --device and plot it."""
    from argparse import ArgumentParser

    import torch

    from dynamont_tpu_torch.constants import PORES, is_rna
    from dynamont_tpu_torch.io import readers as io_readers
    from dynamont_tpu_torch.io.output import format_segments
    from dynamont_tpu_torch.models.batch import BandedBatchEngine, BatchItem
    from dynamont_tpu_torch.models.registry import load_model_for_pore

    p = ArgumentParser(prog="dynamont-plot-segmentation")
    p.add_argument("--tsv", required=True)
    p.add_argument("--readid", required=True)
    p.add_argument("-p", "--pore", required=True, choices=list(PORES))
    p.add_argument("--model_path", default=None)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device to segment on (default cuda; the run "
                        "fails rather than fall back to the CPU)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: torch sees no CUDA device (pass --device cpu "
              "to run the plain-torch path)", file=sys.stderr)
        raise SystemExit(2)

    rna = is_rna(args.pore)
    model = load_model_for_pore(args.pore, args.model_path)
    job = next(
        j for j in io_readers.generate_tsv_jobs(args.tsv, rna)
        if j.readid == args.readid
    )
    eng = BandedBatchEngine(model, args.pore, device=args.device)
    out = eng.run([BatchItem(job.signal, job.read)])[0]
    if out.error:
        print(out.error, file=sys.stderr)
        raise SystemExit(1)
    rows = format_segments(
        out.segments, job.sig_offset, len(job.signal) + job.sig_offset,
        job.read, model.kmer_size, rna,
    )
    plot_borders(job.signal, rows, job.read, job.readid, args.out, model)


if __name__ == "__main__":
    main()

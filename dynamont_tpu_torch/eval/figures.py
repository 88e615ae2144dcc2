"""Benchmark figure generators (ref: src/python/misc/compareTools.py:799-1203
plotting sections: found-ratio curves, upset border-agreement plots,
segment-length distributions, segmentation-rate bars).

All functions take plain dicts/arrays so they are testable without the full
harness; matplotlib is imported lazily (plot extra)."""

from __future__ import annotations

import itertools
import sys

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_found_ratios(ratio_by_tool: dict, outfile: str) -> None:
    """Found-changepoint ratio vs distance threshold, one curve per tool
    (ref: compareTools.py result figures)."""
    plt = _plt()
    plt.figure(figsize=(8, 5), dpi=150)
    for tool, ratios in sorted(ratio_by_tool.items()):
        ds = [d for d, _ in ratios]
        rs = [r for _, r in ratios]
        plt.plot(ds, rs, marker=".", label=tool)
    plt.xlabel("Absolute distance to ground-truth changepoint")
    plt.ylabel("Found ratio")
    plt.ylim(0, 1.02)
    plt.grid(alpha=0.3)
    plt.legend()
    plt.title("Changepoints found within distance threshold")
    plt.tight_layout()
    plt.savefig(outfile)
    plt.close()
    print(f"wrote {outfile}", file=sys.stderr)


def border_agreement_sets(tools: dict, gts: dict, max_distance: int) -> dict:
    """For every ground-truth changepoint, the subset of tools that place a
    border within max_distance; counts per subset (the upset-plot input,
    ref: compareTools.py upset sections).

    tools: {tool: {readid: sorted border array}}; gts: {readid: array}.
    """
    names = sorted(tools)
    counts: dict[tuple, int] = {}
    for rid, gt in gts.items():
        per_tool_hits = []
        for name in names:
            borders = tools[name].get(rid)
            if borders is None or len(borders) == 0:
                per_tool_hits.append(np.zeros(len(gt), bool))
                continue
            b = np.sort(np.asarray(borders))
            idx = np.searchsorted(b, gt)
            lo = np.abs(gt - b[np.clip(idx - 1, 0, len(b) - 1)])
            hi = np.abs(gt - b[np.clip(idx, 0, len(b) - 1)])
            per_tool_hits.append(np.minimum(lo, hi) <= max_distance)
        hits = np.stack(per_tool_hits, axis=1)  # (n_gt, n_tools)
        for row in hits:
            key = tuple(n for n, h in zip(names, row) if h)
            counts[key] = counts.get(key, 0) + 1
    return counts


def plot_border_upset(tools: dict, gts: dict, max_distance: int,
                      outfile: str) -> None:
    """Upset-style plot of which tool combinations found each ground-truth
    border (bar chart of intersection sizes + membership matrix)."""
    counts = border_agreement_sets(tools, gts, max_distance)
    if not counts:
        return
    names = sorted(tools)
    subsets = sorted(counts, key=lambda k: -counts[k])[:20]
    plt = _plt()
    fig, (ax_bar, ax_mat) = plt.subplots(
        2, 1, figsize=(max(6, len(subsets) * 0.6), 6), dpi=150,
        gridspec_kw={"height_ratios": [3, 1]}, sharex=True,
    )
    xs = np.arange(len(subsets))
    ax_bar.bar(xs, [counts[s] for s in subsets], color="#444")
    for x, s in zip(xs, subsets):
        ax_bar.text(x, counts[s], str(counts[s]), ha="center", va="bottom",
                    fontsize=7)
    ax_bar.set_ylabel("ground-truth borders")
    ax_bar.set_title(f"Border agreement (±{max_distance} samples)")
    for x, s in zip(xs, subsets):
        for y, name in enumerate(names):
            ax_mat.plot(x, y, "o",
                        color="#222" if name in s else "#ddd", ms=6)
        members = [names.index(n) for n in s]
        if members:
            ax_mat.plot([x, x], [min(members), max(members)], "-",
                        color="#222", lw=1.5)
    ax_mat.set_yticks(range(len(names)))
    ax_mat.set_yticklabels(names, fontsize=8)
    ax_mat.set_xticks([])
    ax_mat.invert_yaxis()
    fig.tight_layout()
    fig.savefig(outfile)
    plt.close(fig)
    print(f"wrote {outfile}", file=sys.stderr)


def plot_segment_length_distributions(lengths_by_tool: dict,
                                      outfile: str, max_len: int = 200) -> None:
    """Per-tool segment-length histograms (ref: compareTools.py
    distribution figures)."""
    plt = _plt()
    plt.figure(figsize=(8, 5), dpi=150)
    bins = np.arange(0, max_len + 2)
    for tool, lengths in sorted(lengths_by_tool.items()):
        lengths = np.asarray(lengths)
        if lengths.size == 0:
            continue
        plt.hist(np.clip(lengths, 0, max_len), bins=bins, histtype="step",
                 density=True, label=f"{tool} (n={lengths.size})")
    plt.xlabel("segment length (samples)")
    plt.ylabel("density")
    plt.legend(fontsize=8)
    plt.title("Segment length distributions")
    plt.tight_layout()
    plt.savefig(outfile)
    plt.close()
    print(f"wrote {outfile}", file=sys.stderr)


def plot_segmentation_rate(n_segmented: dict, n_total: int,
                           outfile: str) -> None:
    """Ratio of successfully segmented reads per tool
    (ref: compareTools.py:1029-1060 plotSegmentationRate)."""
    plt = _plt()
    names = sorted(n_segmented)
    ratios = [n_segmented[n] / max(1, n_total) for n in names]
    plt.figure(figsize=(6, 4), dpi=150)
    plt.bar(names, ratios, color="#346")
    for i, r in enumerate(ratios):
        plt.text(i, r, f"{r:.3f}", ha="center", va="bottom", fontsize=8)
    plt.xticks(rotation=45, ha="right")
    plt.ylabel("Segmented reads ratio")
    plt.title("Ratio of segmented reads per tool")
    plt.tight_layout()
    plt.savefig(outfile)
    plt.close()
    print(f"wrote {outfile}", file=sys.stderr)

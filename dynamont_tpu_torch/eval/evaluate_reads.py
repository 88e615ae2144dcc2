"""Basecall-vs-segmentation read statistics (ref: src/python/misc/
evaluateReads.py): presence, identity, truncation, banded edit distance,
N50, length distribution; JSON report.
"""

from __future__ import annotations

import json
import sys
from argparse import ArgumentParser

import numpy as np


def global_alignment(a: str, b: str) -> int:
    """Banded semi-global edit distance (ref: evaluateReads.py:74-103)."""
    n, m = len(a), len(b)
    # the reference's 20% band collapses to zero on very short sequences;
    # clamp so short inputs still produce a defined distance
    band = max(1, max(n, m) // 5)
    prev = np.zeros(m + 1, dtype=int)
    curr = np.zeros(m + 1, dtype=int)
    for i in range(1, n + 1):
        curr[0] = i
        lo = max(1, i - band)
        hi = min(m + 1, i + band + 1)
        for j in range(lo, hi):
            match = prev[j - 1] + (a[i - 1] != b[j - 1])
            delete = prev[j] + 1
            insert = curr[j - 1] + 1
            curr[j] = min(match, delete, insert)
        prev, curr = curr, prev
    return int(prev[m])


def compute_n50(lengths) -> int:
    """(ref: evaluateReads.py:153-173)."""
    if not len(lengths):
        return 0
    s = np.sort(np.asarray(lengths))[::-1]
    half = s.sum() / 2
    c = np.cumsum(s)
    return int(s[np.searchsorted(c, half)])


def compute_stats(basecalls: dict, segmented: dict) -> dict:
    """(ref: evaluateReads.py:105-151)."""
    stats = {
        "total": len(basecalls), "present": 0, "identical": 0,
        "truncated": 0, "nt_changed": 0, "missing": 0, "lengths": [],
    }
    for rid, seq in basecalls.items():
        if rid not in segmented:
            stats["missing"] += 1
            continue
        seg = segmented[rid]
        stats["present"] += 1
        stats["lengths"].append(len(seg))
        nt = global_alignment(seq, seg)
        stats["identical"] += not nt
        stats["truncated"] += len(seg) < len(seq)
        stats["nt_changed"] += nt
    return stats


def report(stats: dict) -> dict:
    lengths = stats.pop("lengths")
    out = dict(stats)
    out["N50"] = compute_n50(lengths)
    out["mean_length"] = float(np.mean(lengths)) if lengths else 0.0
    out["median_length"] = float(np.median(lengths)) if lengths else 0.0
    return out


def load_fasta(path: str) -> dict:
    reads = {}
    rid, seq = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if rid is not None:
                    reads[rid] = "".join(seq)
                rid, seq = line[1:].split()[0], []
            else:
                seq.append(line)
    if rid is not None:
        reads[rid] = "".join(seq)
    return reads


def main(argv=None) -> None:
    p = ArgumentParser(prog="dynamont-evaluate-reads")
    p.add_argument("-b", "--basecalls", required=True, help="BAM or FASTA of basecalls")
    p.add_argument("-s", "--segmented", required=True, help="FASTA of segmented reads")
    p.add_argument("-o", "--output", required=True, help="JSON report path")
    args = p.parse_args(argv)

    if args.basecalls.endswith((".bam", ".sam")):
        import pysam

        basecalls = {}
        with pysam.AlignmentFile(args.basecalls, "rb", check_sq=False) as bam:
            for read in bam.fetch(until_eof=True):
                basecalls[read.query_name] = read.query_sequence
    else:
        basecalls = load_fasta(args.basecalls)
    segmented = load_fasta(args.segmented)
    stats = report(compute_stats(basecalls, segmented))
    with open(args.output, "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats), file=sys.stderr)


if __name__ == "__main__":
    main()

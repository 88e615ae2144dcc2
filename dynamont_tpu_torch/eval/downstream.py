"""Downstream-pipeline evaluation: flye assembly + SVIM structural-variant
summaries (ref: src/python/misc/evaluateSubsequentTools.py). The output file
feeds dynamont-collect-metrics --downstream."""

from __future__ import annotations

import os
from argparse import ArgumentParser


def read_flye(path: str) -> dict:
    """Total length, N50, mean coverage from flye assembly_info.txt
    (ref: evaluateSubsequentTools.py:18-71)."""
    if not os.path.exists(path):
        return {"total_length": 0, "n50": 0, "mean_coverage": 0}
    lengths, coverages = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.strip().split("\t")
            lengths.append(int(parts[1]))
            coverages.append(float(parts[2]))
    total = sum(lengths)
    n50 = 0
    cum = 0
    for length in sorted(lengths, reverse=True):
        cum += length
        if cum >= total / 2:
            n50 = length
            break
    mean_cov = sum(coverages) / len(coverages) if coverages else 0
    return {"total_length": total, "n50": n50, "mean_coverage": mean_cov}


def count_structural_variants(vcf_path: str) -> int:
    """SVTYPE records in a SVIM VCF (ref: evaluateSubsequentTools.py:73-98)."""
    if not os.path.exists(vcf_path):
        return 0
    n = 0
    with open(vcf_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.strip().split("\t")
            if len(parts) > 7 and "SVTYPE" in parts[7]:
                n += 1
    return n


def main(argv=None) -> None:
    p = ArgumentParser(prog="dynamont-evaluate-downstream")
    p.add_argument("flye", help="Path to the flye/assembly_info.txt output")
    p.add_argument("svim", help="Path to the svim variants.vcf output")
    p.add_argument("outfile")
    args = p.parse_args(argv)
    flye = read_flye(args.flye)
    svs = count_structural_variants(args.svim)
    with open(args.outfile, "w") as f:
        f.write(f"Total length: {flye['total_length']}\n")
        f.write(f"N50: {flye['n50']}\n")
        f.write(f"Mean coverage: {flye['mean_coverage']}\n")
        f.write(f"Number of structural variants: {svs}\n")


if __name__ == "__main__":
    main()

"""Format converters (ref: src/python/misc/segToFasta.py, tomboToFasta.py,
extractDoradoMoves.py)."""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser


def detect_format(header: list[str]) -> str:
    """Autodetect segmentation file flavor (ref: segToFasta.py:24-38)."""
    hs = {h.strip().lower() for h in header}
    if {"readid", "motif"}.issubset(hs):
        return "dynamont"
    if {"read_id", "kmer_idx", "start_raw_idx", "end_raw_idx"}.issubset(hs):
        return "f5c_resquiggle"
    if {"model_kmer", "read_index", "start_idx", "end_idx"}.issubset(hs):
        return "f5c_eventalign"
    if {"aln.read_id", "seq.kmer", "dtw.start", "dtw.length"}.issubset(hs):
        return "uncalled4"
    raise ValueError(f"Unsupported or unrecognized segmentation file format: {header}")


def _load_read_map(summary_file: str) -> dict:
    """f5c eventalign .sum sidecar: read_index -> read_name
    (ref: segToFasta.py:40-50)."""
    read_map = {}
    with open(summary_file) as f:
        for line in f:
            if line.startswith("read_index"):
                continue
            cols = line.strip().split("\t")
            if len(cols) >= 2:
                read_map[cols[0]] = cols[1]
    return read_map


def seg_to_fasta(seg_file: str, basecalls: dict, rna: bool, outfile: str) -> int:
    """Emit per-read FASTA of the segmented bases, ordered by signal start,
    for any of the four tool flavors (ref: segToFasta.py:72-141).
    basecalls: {readid: sequence 5'->3'} (needed by the f5c_resquiggle
    flavor, which records base indices only). Returns reads written."""
    import csv

    from dynamont_tpu_torch.plot.readers import _open_maybe_zst

    with _open_maybe_zst(seg_file) as f:
        header = f.readline().strip()
        delimiter = "\t" if "\t" in header else ","
        fmt = detect_format(header.split(delimiter))

    read_map = {}
    if fmt == "f5c_eventalign":
        read_map = _load_read_map(os.path.splitext(seg_file)[0] + ".sum")

    segments: dict[str, list] = {}
    with _open_maybe_zst(seg_file) as f:
        for row in csv.DictReader(f, delimiter=delimiter):
            if fmt == "dynamont":
                rid = row["readid"]
                start = int(row["start"])
                base = row["base"].replace("U", "T")
            elif fmt == "f5c_resquiggle":
                rid = row["read_id"]
                seq = basecalls.get(rid)
                if seq is None:
                    continue
                base = seq[int(row["kmer_idx"])].replace("U", "T")
                try:
                    start = int(row["start_raw_idx"])
                except ValueError:
                    continue
            elif fmt == "f5c_eventalign":
                rid = read_map.get(row["read_index"])
                try:
                    start = int(row["start_idx"])
                except ValueError:
                    continue
                motif = row["model_kmer"].replace("U", "T")
                base = motif[len(motif) // 2]
            else:  # uncalled4
                rid = row["aln.read_id"]
                try:
                    start = int(row["dtw.start"])
                except ValueError:
                    continue
                motif = row["seq.kmer"].replace("U", "T")
                base = motif[len(motif) // 2]
            segments.setdefault(rid, []).append((start, base))

    n = 0
    with open(outfile, "w") as out:
        for rid, segs in segments.items():
            segs.sort()
            seq = "".join(b for _, b in segs)
            if rna:
                seq = seq[::-1]
            out.write(f">{rid}\n{seq}\n")
            n += 1
    print(f"wrote {n} reads to {outfile}", file=sys.stderr)
    return n


def extract_dorado_moves(bam_file: str, outfile: str) -> None:
    """mv:B:c move table -> per-base signal segment TSV
    (ref: extractDoradoMoves.py:18-68)."""
    import pysam

    with pysam.AlignmentFile(bam_file, "rb", check_sq=False) as bam, open(
        outfile, "w"
    ) as out:
        out.write("readid\tsignalid\tposition\tbase\tmotif\tstart\tend\n")
        for read in bam.fetch(until_eof=True):
            if not read.has_tag("mv"):
                continue
            mv = read.get_tag("mv")
            stride, moves = mv[0], mv[1:]
            ts = read.get_tag("ts") if read.has_tag("ts") else 0
            seq = read.query_sequence
            signalid = read.get_tag("pi") if read.has_tag("pi") else read.query_name
            pos = -1
            starts = []
            for i, m in enumerate(moves):
                if m:
                    starts.append(ts + i * stride)
            for j, start in enumerate(starts):
                pos += 1
                if pos >= len(seq):
                    break
                end = starts[j + 1] if j + 1 < len(starts) else ts + len(moves) * stride
                motif = seq[max(0, pos - 2): pos + 3]
                out.write(
                    f"{read.query_name}\t{signalid}\t{pos}\t{seq[pos]}\t{motif}\t{start}\t{end}\n"
                )


def tombo_to_fasta(seg_dir: str, rna: bool, outfile: str) -> int:
    """Rebuild each read's sequence from tombo single-fast5 Events
    (ref: misc/tomboToFasta.py:44-77): events sorted by start, bases
    concatenated (U->T), reversed for RNA. Returns #reads written."""
    import h5py

    from dynamont_tpu_torch.plot.readers import tombo_fast5s

    out = outfile if outfile.endswith(".fasta") else outfile + ".fasta"
    n = 0
    with open(out, "w") as fasta:
        for path in tombo_fast5s(seg_dir):
            readid = os.path.basename(path).rsplit(".", 1)[0]
            with h5py.File(path, "r") as f5:
                try:
                    events = f5[
                        "Analyses/RawGenomeCorrected_000/BaseCalled_template/Events"
                    ][:]
                except KeyError:
                    continue
            segs = sorted(
                (ev["start"], ev["base"].decode().replace("U", "T"))
                for ev in events
            )
            seq = "".join(b for _, b in segs)
            if rna:
                seq = seq[::-1]
            fasta.write(f">{readid}\n{seq}\n")
            n += 1
    return n


def main(argv=None) -> None:
    p = ArgumentParser(prog="dynamont-convert")
    sub = p.add_subparsers(dest="cmd", required=True)
    s1 = sub.add_parser("seg-to-fasta")
    s1.add_argument("-i", "--input", required=True)
    s1.add_argument("-b", "--basecalls", required=True, help="BAM or FASTA")
    s1.add_argument("-o", "--output", required=True)
    s1.add_argument("--rna", action="store_true")
    s2 = sub.add_parser("dorado-moves")
    s2.add_argument("-i", "--input", required=True, help="BAM with mv tags")
    s2.add_argument("-o", "--output", required=True)
    s3 = sub.add_parser("tombo-to-fasta")
    s3.add_argument("-i", "--input", required=True, help="tombo single-fast5 dir")
    s3.add_argument("-o", "--output", required=True)
    s3.add_argument("--rna", action="store_true")
    args = p.parse_args(argv)

    if args.cmd == "tombo-to-fasta":
        tombo_to_fasta(args.input, args.rna, args.output)
        return

    if args.cmd == "seg-to-fasta":
        from dynamont_tpu_torch.eval.evaluate_reads import load_fasta

        if args.basecalls.endswith((".bam", ".sam")):
            import pysam

            basecalls = {}
            with pysam.AlignmentFile(args.basecalls, "rb", check_sq=False) as bam:
                for read in bam.fetch(until_eof=True):
                    basecalls[read.query_name] = read.query_sequence
        else:
            basecalls = load_fasta(args.basecalls)
        seg_to_fasta(args.input, basecalls, args.rna, args.output)
    else:
        extract_dorado_moves(args.input, args.output)


if __name__ == "__main__":
    main()

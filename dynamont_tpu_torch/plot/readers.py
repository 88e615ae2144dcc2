"""Per-tool segmentation readers for overlay plots
(ref: src/python/plot/plotToolSegments.py:33-160).

Each reader returns [(start, end, base, motif)] for one read id.
"""

from __future__ import annotations

import io
import os
import sys

import numpy as np


def _open_maybe_zst(path: str):
    if path.endswith(".zst"):
        import zstandard as zstd

        raw = open(path, "rb")
        return io.TextIOWrapper(zstd.ZstdDecompressor().stream_reader(raw))
    return open(path)


def read_dynamont(path: str, readid: str) -> list:
    """(ref: plotToolSegments.py:33-47). Accepts plain or zstd CSV."""
    segments = []
    with _open_maybe_zst(path) as f:
        next(f)  # header
        for line in f:
            if not line.startswith(readid):
                continue
            try:
                _, _, start, end, _, base, motif, *_ = line.strip().split(",")
                segments.append((int(start), int(end), base, motif))
            except ValueError:
                pass
    return segments


def read_uncalled4(path: str, readid: str) -> list:
    """(ref: plotToolSegments.py:95-108)."""
    segments = []
    with open(path) as f:
        next(f)
        for line in f:
            _, _, _, _, kmer, rid, start, length, *_ = line.strip().split("\t")
            if rid != readid or start == "*":
                continue
            segments.append(
                (int(start), int(start) + int(length), kmer[len(kmer) // 2], kmer)
            )
    return segments


def read_f5c_resquiggle(path: str, readid: str, read: str, kmer_size: int = 5) -> list:
    """(ref: plotToolSegments.py:110-124)."""
    half = kmer_size // 2
    segments = []
    with open(path) as f:
        next(f)
        for line in f:
            if not line.startswith(readid):
                continue
            _, kmer_idx, start, end = line.strip().split("\t")
            if start == "." or end == ".":
                continue
            i = int(kmer_idx)
            segments.append(
                (int(start), int(end), read[i + half], read[i: i + kmer_size])
            )
    return segments


def read_f5c_eventalign(path: str, summary: str, readid: str) -> list:
    """(ref: plotToolSegments.py:126-146)."""
    read_num = None
    with open(summary) as f:
        for line in f:
            rid, read_name, *_ = line.strip().split("\t")
            if read_name == readid:
                read_num = rid
                break
    segments = []
    if read_num is None:
        return segments
    with open(path) as f:
        next(f)
        for line in f:
            _, _, _, rnum, _, _, _, _, _, kmer, _, _, _, start, end = (
                line.strip().split("\t")
            )
            if rnum != read_num:
                continue
            segments.append((int(start), int(end), kmer[len(kmer) // 2], kmer))
    return segments


def read_dorado(path: str, readid: str) -> list:
    """Dorado move-table TSV (ref: plotToolSegments.py:148-160; produced by
    the extract-moves converter)."""
    segments = []
    with open(path) as f:
        next(f)
        for line in f:
            if not line.startswith(readid):
                continue
            rid, signalid, _, base, motif, start, end = line.strip().split("\t")
            segments.append((int(start), int(end), base, motif))
    return segments


def tombo_fast5s(directory: str) -> list:
    """Recursively collect single-read .fast5 files (ref:
    compareTools.py:190-213 getFast5s)."""
    from pathlib import Path

    return sorted(str(p) for p in Path(directory).rglob("*.fast5"))


def read_tombo_borders(directory: str) -> dict:
    """Tombo resquiggle borders per read from a single-fast5 directory
    (ref: compareTools.py:215-243 readTombo). Tombo stores RNA events in
    genome direction, so border indices are mirrored back into sequencing
    time with signalLen - border - 1.

    Returns {readid: sorted np.ndarray of signal border positions}."""
    import h5py

    out = {}
    for path in tombo_fast5s(directory):
        readid = os.path.basename(path).split(".")[0]
        with h5py.File(path, "r") as h5:
            try:
                grp = h5["Analyses/RawGenomeCorrected_000/BaseCalled_template"]
                if grp.attrs.get("status") == "Alignment not produced":
                    continue
                raw = h5["Raw/Reads"]
                signal_len = len(raw[list(raw.keys())[0]]["Signal"][:])
                events = grp["Events"]
                starts = events[:]["start"] + events.attrs["read_start_rel_to_raw"]
                ends = starts + events[:]["length"]
                borders = np.unique((starts, ends))
                borders = signal_len - borders - 1  # RNA mirror
            except KeyError:
                continue
        out.setdefault(readid, set()).update(borders.tolist())
    return {rid: np.asarray(sorted(b)) for rid, b in out.items()}

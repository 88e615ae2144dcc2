"""Segmentation output formatting.

Two layers, mirroring the reference contract:
  * the per-read *segment string* `"M<basepos>,<start>,<prob>[,<polish>];…"`
    printed by the single-read CLIs (ref: NT_main.cpp:219-223),
  * the parsed CSV rows `[start,end,basepos,base,motif,state,prob,polish]`
    with motif windows and RNA coordinate mirroring
    (ref: FileIO.py:402-483 formatSegmentationOutput/formatSegmentation).
"""

from __future__ import annotations

import numpy as np

CSV_HEADER = b"readid,signalid,start,end,basepos,base,motif,state,posterior_probability,polish\n"


def segments_to_string(segments) -> str:
    """segments: iterable of (state, basepos, start, median_prob[, polish])."""
    parts = []
    for seg in segments:
        state, basepos, start, prob = seg[0], seg[1], seg[2], seg[3]
        polish = seg[4] if len(seg) > 4 else None
        s = f"{state}{basepos},{start},{prob:.5f}"
        if polish is not None:
            s += f",{polish}"
        parts.append(s + ";")
    return "".join(parts)


def parse_segment_string(output: str):
    """Inverse of segments_to_string: -> list of (state, basepos, start, prob, polish|None)."""
    out = []
    for chunk in output.split(";")[:-1]:
        state = chunk[0]
        fields = chunk[1:].split(",")
        basepos = int(fields[0])
        start = int(fields[1])
        prob = float(fields[2])
        polish = fields[3] if len(fields) > 3 else None
        out.append((state, basepos, start, prob, polish))
    return out


def format_segmentation_output(
    output: str,
    sig_offset: int,
    last_index: int,
    read: str,
    kmer_size: int,
    rna: bool,
) -> np.ndarray:
    """Parse a segment string into CSV rows (ref: FileIO.py:402-460).

    read is in sequencing direction (DNA 5'->3', RNA 3'->5' with polyA
    prefix already applied). For RNA, motif is reversed and basepos is
    mirrored back into 5'->3' coordinates.
    """
    segs = parse_segment_string(output)
    n = len(segs)
    rows = np.empty((n, 8), dtype=object)
    half = kmer_size // 2
    for i, (state, basepos, start, prob, polish) in enumerate(segs):
        start_off = start + sig_offset
        end = (segs[i + 1][2] + sig_offset) if i < n - 1 else last_index
        motif = read[max(0, basepos - half) : min(len(read), basepos + half + 1)]
        base = read[basepos]
        if rna:
            motif = motif[::-1]
            basepos = len(read) - basepos - 1
        rows[i] = [start_off, end, basepos, base, motif, state, prob, polish if polish is not None else "NA"]
    return rows


def format_segmentation(readid: str, signalid: str, segmentation: np.ndarray) -> bytes:
    """CSV rows -> bytes for the output stream (ref: FileIO.py:462-483)."""
    prefix = f"{readid},{signalid},"
    return (
        "\n".join(prefix + ",".join(map(str, row)) for row in segmentation) + "\n"
    ).encode("utf-8")

"""Segmentation result formatting and the compressed CSV writer.

Equivalent of the reference's formatSegmentationOutput/formatSegmentation
(ref: src/python/segmentation/FileIO.py:402-483) and the listener process
(ref: segment.py:75-115) — here a writer thread fed by a queue, producing
the same zstd-compressed CSV and `.errors` sidecar.
"""

from __future__ import annotations

import os
import queue as _queue
import sys
import threading
from os.path import splitext

import numpy as np

CSV_HEADER = b"readid,signalid,start,end,basepos,base,motif,state,posterior_probability,polish\n"


def format_segments(
    segments: list,
    sig_offset: int,
    last_index: int,
    read: str,
    kmer_size: int,
    rna: bool,
) -> np.ndarray:
    """Segment tuples -> output rows [start, end, basepos, base, motif,
    state, prob, polish] (ref: FileIO.py:402-460).

    segments: [(state, basepos, start_t, prob[, polish])] in read order,
    coordinates in processing orientation. `read` is the processing-
    orientation read (RNA: 3'->5' with polyA prefix).
    """
    n = len(segments)
    rows = np.empty((n, 8), dtype=object)
    half = kmer_size // 2
    for i, seg in enumerate(segments):
        state, basepos, start_t = seg[0], seg[1], seg[2]
        prob = seg[3]
        polish = seg[4] if len(seg) > 4 else "NA"
        start = start_t + sig_offset
        if i < n - 1:
            end = segments[i + 1][2] + sig_offset
        else:
            end = last_index
        motif = read[max(0, basepos - half): min(len(read), basepos + half + 1)]
        base = read[basepos]
        if rna:
            motif = motif[::-1]
            basepos = len(read) - basepos - 1
        rows[i] = [start, end, basepos, base, motif, state, prob, polish]
    return rows


def rows_to_csv_bytes(readid: str, signalid: str, rows: np.ndarray) -> bytes:
    """(ref: FileIO.py:462-483)."""
    prefix = f"{readid},{signalid},"
    return (
        "\n".join(prefix + ",".join(map(str, row)) for row in rows) + "\n"
    ).encode("utf-8")


def format_segments_csv(
    readid: str,
    signalid: str,
    segments: list,
    sig_offset: int,
    last_index: int,
    read: str,
    kmer_size: int,
    rna: bool,
) -> bytes:
    """Fused format_segments + rows_to_csv_bytes: one pass from segment
    tuples straight to CSV bytes (byte-identical to the two-step path; the
    intermediate object-array rows cost ~5 ms per read at production N)."""
    n = len(segments)
    half = kmer_size // 2
    L = len(read)
    prefix = f"{readid},{signalid},"
    lines = []
    for i, seg in enumerate(segments):
        state, basepos, start_t, prob = seg[0], seg[1], seg[2], seg[3]
        polish = seg[4] if len(seg) > 4 else "NA"
        start = start_t + sig_offset
        end = segments[i + 1][2] + sig_offset if i < n - 1 else last_index
        lo = basepos - half
        motif = read[lo if lo > 0 else 0: basepos + half + 1]
        base = read[basepos]
        if rna:
            motif = motif[::-1]
            basepos = L - basepos - 1
        lines.append(
            f"{prefix}{start},{end},{basepos},{base},{motif},{state},"
            f"{prob},{polish}"
        )
    return ("\n".join(lines) + "\n").encode("utf-8")


class SegmentationWriter:
    """Queue-fed writer thread: zstd CSV + `.errors` sidecar
    (ref: segment.py:75-115). Error entries are strings; results bytes."""

    def __init__(self, outfile: str, queue_size: int = 1000,
                 append: bool = False):
        import zstandard as zstd

        self.outfile = outfile
        self.errfile = splitext(splitext(outfile)[0])[0] + ".errors"
        self.queue: _queue.Queue = _queue.Queue(maxsize=queue_size)
        self.num_reads = 0
        self.num_errors = 0
        self._zstd = zstd
        self._append = append  # resume: new zstd frame, no header
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        compressor = self._zstd.ZstdCompressor(level=3)
        try:
            from tqdm import tqdm

            # live bar: reads/s from tqdm's rate, error count as postfix
            # (ref: segment.py:89-107)
            pbar = tqdm(desc="Segmented", unit=" reads", dynamic_ncols=False,
                        mininterval=0.5, file=sys.stderr)
        except ImportError:
            pbar = None
        mode = "ab" if self._append else "wb"
        with open(self.outfile, mode) as raw:
            with compressor.stream_writer(raw) as out:
                if not self._append:
                    out.write(CSV_HEADER)
                while True:
                    item = self.queue.get()
                    if item is None:
                        break
                    if isinstance(item, str):
                        with open(self.errfile, "a") as err:
                            err.write(item + "\n")
                        self.num_errors += 1
                        if pbar is not None:
                            pbar.set_postfix(errors=self.num_errors)
                    else:
                        out.write(item)
                        self.num_reads += 1
                        if pbar is not None:
                            pbar.update(1)
        if pbar is not None:
            pbar.close()

    def put_result(self, data: bytes):
        self.queue.put(data)

    def put_error(self, msg: str):
        self.queue.put(msg)

    def close(self):
        self.queue.put(None)
        self._thread.join()
        print(
            f"Reads segmented: {self.num_reads} Errors: {self.num_errors}",
            file=sys.stderr,
        )


def prepare_resume(outfile: str) -> set:
    """Skip set for a resumed run; repairs the file after a hard kill.

    Decodes the (possibly multi-frame) zstd CSV. A clean close decodes to
    EOF without error and the full read-id set is returned untouched. A
    SIGKILL/OOM mid-write leaves a truncated final frame: appending a new
    frame after it would make everything unreachable to decompressors, and
    the final read's rows may be partially flushed. In that case the file
    is REWRITTEN as one fresh frame holding only the complete lines minus
    the trailing (possibly incomplete) read, which is then re-segmented."""
    import zstandard as zstd

    try:
        with open(outfile, "rb") as f:
            rest = f.read()
    except OSError:
        return set()

    # frame-by-frame decode: `eof` distinguishes a cleanly closed frame
    # from a truncated one (a truncated frame yields NO output and NO
    # error from a plain stream read — it must be detected structurally)
    decoded = b""
    truncated = False
    while rest:
        obj = zstd.ZstdDecompressor().decompressobj()
        try:
            decoded += obj.decompress(rest)
        except zstd.ZstdError:
            truncated = True
            break
        if not obj.eof:
            truncated = True
            break
        rest = obj.unused_data

    lines = decoded.split(b"\n")
    tail = lines.pop()  # b"" after a complete final row
    if tail:
        truncated = True  # decoded text ends mid-line

    def rid_of(line: bytes):
        i = line.find(b",")
        return line[:i].decode() if i > 0 else None

    if truncated:
        # drop the trailing read entirely (its rows are contiguous and may
        # be incomplete), then rewrite the file as one clean frame
        last = rid_of(lines[-1]) if lines else None
        while lines and rid_of(lines[-1]) == last:
            lines.pop()
        tmp = outfile + ".repair"
        with open(tmp, "wb") as f:
            with zstd.ZstdCompressor(level=3).stream_writer(f) as out:
                out.write(b"\n".join(lines) + b"\n" if lines else CSV_HEADER)
        os.replace(tmp, outfile)
        print(f"resume: repaired truncated output (kept {len(lines)} rows, "
              f"re-segmenting read {last})", file=sys.stderr)

    done = {rid_of(line) for line in lines}
    done.discard(None)
    done.discard("readid")
    return done

"""Minimal internal multi-read fast5 reader (h5py).

Fallback raw-signal backend for environments without read5_ont (which
wraps pod5/fast5/slow5; ref: segment.py:117-130 uses read5_ont.read).
Implements exactly the surface `materialize_bam_job` consumes:

    r = Fast5Reader(path)
    r.getSignal(readid)    -> raw DAC values (int16 as stored)
    r.getpASignal(readid)  -> calibrated picoamps:
                              (sig + offset) * range / digitisation
    r.close()

Multi-read fast5 layout (ONT standard): one HDF5 group `read_<readid>`
per read with `Raw/Signal` (int16 DACs) and a `channel_id` subgroup
whose attrs carry the calibration (digitisation, offset, range).
"""

from __future__ import annotations

import numpy as np


class Fast5Reader:
    def __init__(self, path: str):
        import h5py

        self._h5 = h5py.File(path, "r")
        # map readid -> group name ("read_<id>"; single-read files keep
        # their one read under Raw/Reads/Read_<n> and are not supported
        # here — read5_ont handles those where it is installed)
        self._groups = {}
        for name in self._h5:
            if name.startswith("read_"):
                self._groups[name[len("read_"):]] = name

    def _group(self, readid: str):
        try:
            return self._h5[self._groups[readid]]
        except KeyError:
            raise KeyError(
                f"read {readid!r} not in fast5 (has "
                f"{sorted(self._groups)[:3]}...)") from None

    def getSignal(self, readid: str) -> np.ndarray:
        """Raw DAC values as stored (ref: read5_ont getSignal)."""
        return np.asarray(self._group(readid)["Raw/Signal"][:])

    def getpASignal(self, readid: str) -> np.ndarray:
        """Calibrated pA: (sig + offset) * range / digitisation."""
        g = self._group(readid)
        ch = g["channel_id"].attrs
        sig = np.asarray(g["Raw/Signal"][:], dtype=np.float64)
        return ((sig + float(ch["offset"]))
                * float(ch["range"]) / float(ch["digitisation"]))

    def close(self) -> None:
        self._h5.close()


def write_fast5(path: str, reads: dict, digitisation: float = 8192.0,
                offset: float = 10.0, rng: float = 1467.61) -> None:
    """Write a multi-read fast5 (testing helper; the layout the reader
    above and ONT tooling expect). `reads`: {readid: int16 DAC array}."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["file_version"] = "2.0"
        for readid, dacs in reads.items():
            g = f.create_group(f"read_{readid}")
            raw = g.create_group("Raw")
            raw.create_dataset(
                "Signal", data=np.asarray(dacs, dtype=np.int16),
                compression="gzip")
            ch = g.create_group("channel_id")
            ch.attrs["digitisation"] = digitisation
            ch.attrs["offset"] = offset
            ch.attrs["range"] = rng
            ch.attrs["sampling_rate"] = 4000.0

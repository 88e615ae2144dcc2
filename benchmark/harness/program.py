"""The system under test, as the benchmark drives it: the engine that
`dynamont_tpu_torch/cli/resquiggle.py` builds for a configuration, and each
read's CSV row formatted in memory by the program's own formatter.

This module is the only one of the harness that imports the program, and
it imports it only inside its functions.
"""

from __future__ import annotations

# the engine's always-on totals that the run reports, by mode: the walls,
# and the reads each rung of the mode's escalation took
ENGINE_COUNTERS = {
    "basic": ("reads", "buckets", "dispatch_s", "collect_s", "z_retries"),
    "resquiggle": ("reads", "buckets", "dispatch_s", "collect_s",
                   "wide_retries", "exact_retries"),
}


class Program:
    """One configuration's engine on `device` ("cuda" for every visible
    GPU, as the CLI's default), as the CLI builds it for the configuration's
    mode: the banded engine with its bucket size, band and precision in
    basic mode, the NTC engine with its bucket size and precision (the
    packaged 5-mer table, no native 9-mer) in resquiggle mode; and the
    formatter the CLI's `_emit` uses."""

    def __init__(self, config: dict, root: str, device: str = "cuda"):
        import os

        import torch

        from dynamont_tpu_torch.models.registry import load_model_for_pore
        from dynamont_tpu_torch.parallel.mesh import local_devices

        self.config = config
        eng = config["engine"]
        self.pore = config["pore"]
        self.mode = config["mode"]
        self.model = load_model_for_pore(self.pore,
                                         os.path.join(root, config["table"]))
        self.rna = bool(self.model.rna)
        dtype = getattr(torch, eng["dtype"])
        devices = local_devices(device)
        if self.mode == "basic":
            from dynamont_tpu_torch.models.batch import BandedBatchEngine

            self.engine = BandedBatchEngine(
                self.model, self.pore, devices=devices, dtype=dtype,
                batch_size=eng["batch_size"], band=eng["band"])
        elif self.mode == "resquiggle":
            from dynamont_tpu_torch.models.ntc_batch import NTCBatchEngine

            self.engine = NTCBatchEngine(
                self.model, self.pore, devices=devices, dtype=dtype,
                batch_size=eng["batch_size"], native_kmer=False)
        else:
            raise ValueError(f"no cell runs mode {self.mode!r}")

    def items(self, reads, ids):
        """The engine's items of pool reads `ids`, each carrying its pool
        index."""
        from dynamont_tpu_torch.models.batch import BatchItem

        return [BatchItem(reads[i][0], reads[i][1], i) for i in ids]

    def dispatch(self, items):
        return self.engine.dispatch(items)

    def collect(self, handle):
        return self.engine.collect(handle)

    def format(self, out) -> bytes:
        """One read's CSV rows, as the CLI's `_emit` makes them: the native
        formatter straight from the device summaries, else the Python
        one."""
        from dynamont_tpu_torch.io.output import format_segments_csv
        from dynamont_tpu_torch.native import summaries_csv_native

        it = out.item
        rid = f"r{it.meta}"
        last = len(it.signal)
        if out.summaries is not None:
            starts_row, medians_row, N, kmer_size = out.summaries
            data = summaries_csv_native(f"{rid},{rid},", starts_row,
                                        medians_row, N, it.read, kmer_size,
                                        self.rna, 0, last)
            if data is not None:
                return data
        return format_segments_csv(rid, rid, out.segments, 0, last, it.read,
                                   self.model.kmer_size, self.rna)

    def counters(self) -> dict:
        return {k: self.engine.profile.get(k, 0)
                for k in ENGINE_COUNTERS[self.mode]}

    def close(self):
        self.engine = None

"""Share, in %, of the NTC buckets' padded samples in the traced window
that hold no read's sample: 1 - the reads' samples (each read's T) over the
padded samples (reads x the bucket's T_pad on `models/packing.t_pad_ladder`),
summed over the program's `ntc.bucket` spans (dynamont_tpu_torch/
tracing.py). The pre-pass and lattice kernels run every padded row.
Nothing where the program records no spans."""

SPAN = "ntc.bucket"


def read(run):
    try:
        from dynamont_tpu_torch import tracing
    except ImportError:
        return None
    t = tracing.totals().get(SPAN)
    padded = t.counts.get("padded_samples", 0) if t is not None else 0
    if not padded:
        return None
    return 100.0 * (1.0 - t.counts["samples"] / padded)

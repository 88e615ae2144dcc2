"""Reads a bucket of the NTC engine in the traced window: the reads over
the number of the program's `ntc.bucket` spans (dynamont_tpu_torch/
tracing.py), each of which counts the reads of one bucket as the packer
(`models/packing.pack_buckets`, group 1, called by `NTCBatchEngine._buckets`)
made it, the wide rung's buckets included. A bucket's reads run on as many
of the card's SMs. Nothing where the program records no spans."""

SPAN = "ntc.bucket"


def read(run):
    try:
        from dynamont_tpu_torch import tracing
    except ImportError:
        return None
    t = tracing.totals().get(SPAN)
    if t is None or not t.n:
        return None
    return t.counts["reads"] / t.n

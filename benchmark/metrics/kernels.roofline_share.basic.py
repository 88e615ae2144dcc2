"""Share, in %, of K1-K3's device time in the traced window that the work
of the reads completed there would take at the card's peak: the larger of
their operations over the fp32 peak and their bytes over the HBM peak
(`benchmark/roofline/banded.py`, from each read's own sizes), over the
summed device time of the three kernels. Nothing where the card is not in
the table of peaks or the trace holds none of the kernels."""

ROOFLINE = "banded"


def read(run):
    peaks, group = run["peaks"], run["roofline"](ROOFLINE)
    if not peaks or not run["sizes"]:
        return None
    seconds = run["kernel_time"](group.KERNELS)
    if seconds <= 0:
        return None
    eng = run["config"]["engine"]
    itemsize = 8 if eng["dtype"] == "float64" else 4
    ops = nbytes = 0
    for T, N in run["sizes"]:
        o, b = group.counts(T, N, eng["band"], itemsize)
        ops += o
        nbytes += b
    flops = peaks[f"{eng['dtype']}_flop_per_s"]
    least = max(ops / flops, nbytes / peaks["hbm_byte_per_s"])
    return 100.0 * least / seconds

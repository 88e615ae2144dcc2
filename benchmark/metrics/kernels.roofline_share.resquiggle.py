"""Share, in %, of K7-K16's device time in the traced window that the work
of the reads completed there would take at the card's peak: the larger of
their operations over the working precision's peak and their bytes over
the HBM peak (`benchmark/roofline/ntc.py`, from each read's own sizes), over
the summed device time of the NTC kernels. Nothing where the card is not in
the table of peaks or the trace holds none of the kernels."""

ROOFLINE = "ntc"


def read(run):
    peaks, group = run["peaks"], run["roofline"](ROOFLINE)
    if not peaks or not run["sizes"]:
        return None
    seconds = run["kernel_time"](group.KERNELS)
    if seconds <= 0:
        return None
    dtype = run["config"]["engine"]["dtype"]
    itemsize = 8 if dtype == "float64" else 4
    K = len(run["table"].means)
    ops = nbytes = 0
    for T, N in run["sizes"]:
        o, b = group.counts(T, N, K, itemsize)
        ops += o
        nbytes += b
    least = max(ops / peaks[f"{dtype}_flop_per_s"], nbytes / peaks["hbm_byte_per_s"])
    return 100.0 * least / seconds

"""Rung retries of the NTC engine in the traced window, in % of its reads:
(wide_retries + exact_retries) / reads from the engine's always-on counters
(a read that the wide rung does not repair counts on both rungs). Reads
the main rung cannot take cost a second bucket on the card (the wide rung)
or the exact per-read float64 path. Nothing where the engine counted no
reads."""


def read(run):
    c = run["counters"]
    if not c.get("reads"):
        return None
    return 100.0 * (c.get("wide_retries", 0) + c.get("exact_retries", 0)) / c["reads"]

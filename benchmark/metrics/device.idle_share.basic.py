"""Share, in %, of the traced window in which no kernel, copy or set ran on
the card: 1 - the union of the device events over the window span (the
copy of `tools/main_path_profile.trace_summary` in `harness/trace.py`)."""


def read(run):
    tr = run["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

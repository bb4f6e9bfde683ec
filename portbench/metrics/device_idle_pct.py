"""The share of the traced window in which no kernel, copy or memset ran
on the card (the union of the trace's device intervals)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

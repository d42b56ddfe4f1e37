"""Share (%) of the traced window in which no operation ran on the
device: 1 − busy / window, from the profiler's device events."""


def read(sources):
    trace = sources.get("trace")
    window_s = sources.get("window_s") or 0.0
    if not trace or window_s <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / window_s)

"""A kernel's share of its roofline over a traced window.

Bound: the sum over the launches recorded while the profiler ran of each
launch's byte bound.  Time: the kernel's device seconds in the trace
(events whose name holds the kernel's ``device_name`` and no longer
listed kernel's, and those of the further kernels a launch makes, its
``device_names_also``), scaled by launches recorded over the events of
``device_name`` seen (one a launch; a trace can lose device events late
in a process; the mean event time times the launches is what they
took)."""


def share(sources, kernel: str, bound_s):
    """``bound_s(launch, bytes_per_s)`` → one launch's least seconds."""
    trace = sources.get("trace")
    launches = sources.get("launches", {}).get(kernel)
    peak = sources.get("bytes_per_s")
    if not trace or not launches or not peak:
        return None
    names = [n for s in sources["kernels"].values()
             for n in [s["device_name"], *s.get("device_names_also", [])]]
    spec = sources["kernels"][kernel]
    mine, also = spec["device_name"], spec.get("device_names_also", [])

    def owner(event: str):
        hits = [n for n in names if n in event]
        return max(hits, key=len) if hits else None

    seen = {k: s for k, s in trace["by_name"].items() if owner(k) == mine}
    events = sum(trace["count"][k] for k in seen)
    device_s = sum(seen.values()) + sum(
        s for k, s in trace["by_name"].items() if owner(k) in also)
    if events == 0 or device_s <= 0:
        return None
    device_s *= len(launches) / events
    bound = sum(bound_s(x, peak) for x in launches)
    return 100.0 * bound / device_s

"""The device trace of a traced window, reduced to what the metrics read.

``torch.profiler`` records the window's host operations and device
activities (kernels, copies, fills); ``summarize`` turns its events into
the device's busy seconds (the union of device intervals), seconds by
device operation name, event counts by name, and the idle gaps between
device intervals labelled by the innermost host operation running at
each gap's middle on the busiest host thread.  A program's profiler
ranges are no work: their host events label no gap, and the device
rows that copy them (user annotations) are no device time.
"""

from __future__ import annotations

import collections


def profiler(with_host: bool):
    """A profiler of the card's activities, and of the host's operations
    too with ``with_host`` (which slows the host: the device's busy
    share is read without it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if with_host or not torch.cuda.is_available():
        activities.append(ProfilerActivity.CPU)
    return profile(activities=activities)


def _merge(intervals: list) -> list:
    merged: list = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def _innermost(host: list, points: list) -> list:
    """For each point (ascending), the name of the innermost host event
    covering it, from events (start, end, name) of one thread, which
    nest."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else "no host operation")
    return out


def summarize(events, top: int = 10) -> dict:
    """``events``: the profiler's ``events()``, of which profiler ranges
    and their device copies (both user annotations) are left out.
    Returns ``busy_s``, ``by_name``
    {name: seconds}, ``count`` {name: events}, and the ``device_ops``
    and ``idle_gaps`` breakdowns ([name, seconds], the largest ``top``
    of each)."""
    from torch.autograd import DeviceType

    device, host = [], collections.defaultdict(list)
    by_name: dict = collections.defaultdict(float)
    count: dict = collections.defaultdict(int)
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            device.append((start, end))
            by_name[e.name] += (end - start) / 1e6
            count[e.name] += 1
        elif e.device_type == DeviceType.CPU:
            host[e.thread].append((start, end, e.name))
    merged = _merge(device)
    busy_s = sum(end - start for start, end in merged) / 1e6
    gaps = [(merged[j][1], merged[j + 1][0]) for j in range(len(merged) - 1)]
    labels: dict = collections.defaultdict(float)
    if gaps and host:
        thread = max(host, key=lambda t: len(host[t]))
        names = _innermost(host[thread], [(a + b) / 2 for a, b in gaps])
        for (a, b), name in zip(gaps, names):
            labels[name] += (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(labels.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_s, "by_name": dict(by_name), "count": dict(count),
            "device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[name[:160], s] for name, s in idle]}


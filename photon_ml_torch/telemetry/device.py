"""Device accounting: analytic chunk-program costs, device memory,
rooflines.

Counterpart of ``photon_ml_tpu/telemetry/device.py``.  XLA's
``cost_analysis()`` has no PyTorch counterpart, so a program's cost here
is analytic, from the tensors it is given:

- **bytes** = every input tensor read once plus every output written
  once (the definition of the kernel bounds in ``PERF.md``);
- **flops** = 2 · the stored slots of each sparse product the program
  runs (``X·w`` through ``gather_rowsum``, ``Xᵀr`` through the scatter),
  times its lanes.

The **roofline** is those bytes at the card's peak memory rate, from a
small table keyed by ``torch.cuda.get_device_name()``, each entry with
its source; a CPU run gets a labelled nominal figure, which sizes
nothing.  **Device memory** comes from ``torch.cuda.memory_stats()``
(allocated, reserved and peak bytes of the session's device; none of
them synchronizes); a session on the CPU reports the process's resident
set under a label that says so.

Capture is once a session a program name (``maybe_capture``), at the
program's first instrumented chunk, and writes one ``device_cost``
event.  With telemetry off every helper is one global read.

**Device time by span** (``device_s_by_span``) reads a ``torch.profiler``
trace taken in a session, where every span is the range
``photon::<name>``: each kernel, copy or fill goes to the CUDA call that
launched it (the profiler's launch correlation), then to every span
around that call.
"""

from __future__ import annotations

import torch

from photon_ml_torch import telemetry

# Peak memory rate by card name, GB/s, with the source of each figure.
CARD_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": (3350.0, "H100 SXM5 data sheet, 3.35 TB/s "
                                      "HBM3"),
    "NVIDIA H100 PCIe": (2000.0, "H100 PCIe data sheet, 2.0 TB/s HBM2e"),
    "NVIDIA H100 NVL": (3900.0, "H100 NVL data sheet, 3.9 TB/s HBM3"),
}
# A CPU run still emits an estimate so the plumbing is exercised end to
# end; the figure is a nominal label, not a measurement.
CPU_PEAK_GBPS = (25.6, "nominal dual-channel DDR4 (CPU run; sizes "
                       "nothing)")


def tensor_bytes(tensors) -> int:
    """Σ numel · element size over ``tensors``."""
    return int(sum(t.numel() * t.element_size() for t in tensors))


def peak_gbps(device) -> tuple[str, float | None, str]:
    """(platform, peak GB/s or None, source) of ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu", CPU_PEAK_GBPS[0], CPU_PEAK_GBPS[1]
    name = torch.cuda.get_device_name(dev)
    peak = CARD_PEAK_GBPS.get(name)
    if peak is None:
        return "gpu", None, f"no peak listed for {name!r}"
    return "gpu", peak[0], f"{name}: {peak[1]}"


def program_cost(inputs, output_bytes: int, flops: float,
                 device) -> dict:
    """Analytic cost of one chunk program: ``inputs`` are the tensors it
    reads, ``output_bytes`` what it writes, ``flops`` its arithmetic."""
    in_bytes = tensor_bytes(inputs)
    byts = float(in_bytes + int(output_bytes))
    out = {
        "cost_source": "analytic",
        "flops": float(flops),
        "bytes_accessed": byts,
        "input_bytes": in_bytes,
        "output_bytes": int(output_bytes),
        "bytes_per_flop": (round(byts / flops, 4) if flops > 0 else None),
    }
    platform, gbps, source = peak_gbps(device)
    out["platform"] = platform
    out["peak_source"] = source
    if gbps is not None and byts > 0:
        out["peak_gbps"] = gbps
        out["roofline_est_ms"] = round(byts / (gbps * 1e9) * 1e3, 6)
    return out


def maybe_capture(name: str, make_cost, span: str | None = None) -> bool:
    """Once a session a program ``name``: ``make_cost()`` (a
    ``program_cost`` dict) is written as a ``device_cost`` event and kept
    for the summary.  ``span`` names the stage span whose time the
    report compares the roofline with.  True when this call captured."""
    t = telemetry.active()
    if t is None:
        return False
    with t._lock:
        if name in t._device_programs:
            return False
        t._device_programs[name] = None   # reserve: capture once
    cost = make_cost()
    if span is not None:
        cost["span"] = span
    with t._lock:
        t._device_programs[name] = cost
    t._log.event("device_cost", program=name, **cost)
    return True


def memory_snapshot(device) -> dict:
    """Current memory occupancy of the run's ``device``.  A CUDA device:
    ``torch.cuda.memory_stats`` of that device, which raises rather than
    return nothing.  A CPU device: the process's resident set, labelled
    as a host figure."""
    dev = torch.device(device)
    if dev.type == "cuda":
        ms = torch.cuda.memory_stats(dev)
        return {"source": "torch.cuda.memory_stats",
                "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
                "reserved_bytes": int(ms.get("reserved_bytes.all.current", 0)),
                "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak",
                                                0))}
    mb = telemetry._RssSampler.rss_mb()
    return {"source": "host_rss (CPU device)",
            "bytes_in_use": int((mb or 0.0) * 1024 * 1024)}


def device_s_by_span(events) -> dict:
    """Device seconds under each span of a ``torch.profiler`` trace
    (``prof.events()``) taken while a session was open.

    A device activity (kernel, copy, fill) carries the id of the CUDA
    call that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
    ``cuLaunchKernel``, ...), and that call sits
    inside the host's operations and ranges, so a kernel launched
    outside any PyTorch operation (B1's, through ``ctypes``) is found
    too.  Returns ``busy_s`` (the union of the device's intervals),
    ``spans`` {span: device seconds launched inside it, nested spans
    included}, ``innermost`` {span: those whose innermost span it is},
    ``outside_s`` (launched under no span) and ``unlinked_s`` (no launch
    found).  The device's own copies of the profiler ranges
    (``gpu_user_annotation``) are no device work and are left out."""
    from torch.autograd import DeviceType

    prefix = telemetry.PROFILER_PREFIX
    launches, work = {}, []
    for e in events:
        if e.device_type == DeviceType.CPU:
            if e.name.startswith("cu"):
                launches[e.id] = e
        elif not (e.name.startswith(prefix)
                  or getattr(e, "is_user_annotation", False)):
            work.append(e)
    intervals, spans, innermost = [], {}, {}
    outside = unlinked = 0.0
    for e in work:
        start, end = e.time_range.start, e.time_range.end
        intervals.append((start, end))
        s = (end - start) / 1e6
        node = launches.get(e.id)
        if node is None:
            unlinked += s
            continue
        names = []
        while node is not None:
            name = node.name
            if name.startswith(prefix) and name[len(prefix):] not in names:
                names.append(name[len(prefix):])
            node = node.cpu_parent
        for name in names:
            spans[name] = spans.get(name, 0.0) + s
        if names:
            innermost[names[0]] = innermost.get(names[0], 0.0) + s
        else:
            outside += s
    busy = reach = 0.0
    for a, b in sorted(intervals):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    return {"busy_s": busy / 1e6, "spans": spans, "innermost": innermost,
            "outside_s": outside, "unlinked_s": unlinked}

"""Readings of the port's own spans and counters, taken in the traced
window's session span, while the port's telemetry session was open
(``span_device_s``, ``span_busy_s``, ``counters``)."""


def share(sources, names) -> float | None:
    """The device seconds launched under any of the spans ``names`` (%
    of the span's device-busy seconds), or None where none ran."""
    by_span = sources.get("span_device_s")
    busy = sources.get("span_busy_s") or 0.0
    if not by_span or busy <= 0:
        return None
    device_s = sum(by_span.get(n, 0.0) for n in names)
    return 100.0 * device_s / busy if device_s > 0 else None


def counter(sources, name: str) -> float | None:
    """The counter's change a fit over the span's fits, or None."""
    return (sources.get("counters") or {}).get(name)

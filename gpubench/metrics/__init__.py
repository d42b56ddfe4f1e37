"""One reader a metric, end-to-end or per-layer: ``read(sources) →
float | None``.

``sources`` is the run's registry of named readings: ``setup_s``,
``prepare_s``, ``fit_s``, ``peak_bytes``, ``fits`` (each fit's
``start``, ``end``, ``span`` (the profiled span it ran in, ``device``,
``host`` or ``session``, or None), ``evaluations``, ``eval_bytes``
(None where an evaluation's layout has no byte count)),
``trace`` (``gpubench.trace.summarize`` of the device-only span, or
None), ``window_s``, ``idle_gaps`` (of the host-and-device span),
``launches`` (kernel name → its recorded launches,
``port.Instruments.resolve``), ``kernels`` (the specs of
``gpubench/kernels/``), ``bytes_per_s`` (the card's memory peak),
``config``, ``traffic``, and whatever the entry's ``sources()`` adds.

From the session span, the one part of a traced window in which the
port's telemetry session is open, traced with the host's operations
(None in an untraced run): ``span_device_s`` (span → device seconds
launched under each of the port's spans, nested spans included;
``port.span_device_s``), ``span_busy_s`` (the span's device-busy
seconds, the ranges' device copies left out) and ``counters`` (each of
the port's counters' change over the span's fits, divided by those
fits).  A reader that finds nothing to read returns None and the metric
is left out of the result line; a share of a bound is never reported as
0 for want of a reading.
"""

"""One reader a metric, end-to-end or per-layer: ``read(sources) →
float | None``.

``sources`` is the run's registry of named readings: ``setup_s``,
``prepare_s``, ``fit_s``, ``peak_bytes``, ``fits`` (each fit's
``start``, ``end``, ``profiled``, ``evaluations``, ``eval_bytes``),
``trace`` (``gpubench.trace.summarize`` of the device-only span, or
None), ``window_s``, ``idle_gaps``, ``launches`` (kernel name → its
recorded launches, ``port.Instruments.resolve``), ``kernels`` (the
specs of ``gpubench/kernels/``), ``bytes_per_s`` (the card's memory
peak), ``config``, ``traffic``, and whatever the entry's ``sources()``
adds.  A reader that finds nothing to read returns None and the metric
is left out of the result line; a share of a bound is never reported as
0 for want of a reading.
"""

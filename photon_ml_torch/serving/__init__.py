"""Online serving tier (counterpart of ``photon_ml_tpu.serving``).

- ``serving.http``: threaded HTTP core + warming/ready readiness and
  the trace-header echo.
- ``serving.tracing``: request tracing (trace context, per-request and
  per-batch stage marks, tail sampling).
- ``serving.entity_store``: random-effect rows from an mmap'd chunked
  disk store behind an id join.
- ``serving.engine``: the model-only scoring plan; one fused
  ``run_chunk`` call per padded micro-batch, on the GPU by default;
  projected random effects fold in on the host.
- ``serving.batcher``: the deadline micro-batcher.
- ``serving.server``: ``ModelServer`` — load, warm, serve, hot swap,
  ``/status`` and ``/metrics``; run it with
  ``python -m photon_ml_torch.serving --config serve.json``.

Not ported yet: the replica fleet and its frontend (ROADMAP D5).
"""

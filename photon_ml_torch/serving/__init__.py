"""Online serving tier (counterpart of ``photon_ml_tpu.serving``).

- ``serving.http``: threaded HTTP core + warming/ready readiness.
- ``serving.entity_store``: random-effect rows from an mmap'd chunked
  disk store behind an id join.
- ``serving.engine``: the model-only scoring plan; one fused
  ``run_chunk`` call per padded micro-batch, on the GPU by default.
- ``serving.batcher``: the deadline micro-batcher.
- ``serving.server``: ``ModelServer`` — load, warm, serve, hot swap;
  run it with ``python -m photon_ml_torch.serving --config serve.json``.

Not ported yet (ROADMAP D): ``/metrics``, telemetry, monitor, tracing,
the replica fleet and its frontend, fault seams, projected random
effects.
"""

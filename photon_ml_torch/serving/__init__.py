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
- ``serving.fleet`` / ``serving.frontend``: the supervised fleet — N
  replica ``ModelServer`` subprocesses (probed, restarted with backoff
  and a circuit breaker, rolled one at a time on a new manifest) behind
  one health-routed frontend (least-outstanding routing, one retry,
  shedding, the fleet's ``/status``); ``replicas > 1`` runs it from the
  same CLI.
"""

# No eager submodule imports: ``telemetry.monitor`` imports the HTTP
# core from ``serving.http``, and an eager ``server`` import here would
# close an import cycle through the telemetry package.


def __getattr__(name: str):
    if name == "ModelServer":
        from photon_ml_torch.serving.server import ModelServer

        return ModelServer
    if name == "FleetServer":
        from photon_ml_torch.serving.fleet import FleetServer

        return FleetServer
    raise AttributeError(name)

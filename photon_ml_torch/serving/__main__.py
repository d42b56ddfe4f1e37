"""Model-server CLI: ``python -m photon_ml_torch.serving --config
serve.json``.

Counterpart of ``photon_ml_tpu/serving/__main__.py`` with the same
flags plus ``--device``.  Runs the scoring process until SIGTERM/SIGINT,
then drains (queued requests finish, then the endpoint closes).  The
last stdout line is one JSON object with the final serving status and
the exit code.  ``--info-file`` writes ``{"port", "pid", "url"}`` as
soon as the socket binds (atomic tmp + replace), so a supervisor can
find an ephemeral port and poll ``/healthz`` for warming → ready.

The config's ``telemetry``, ``monitor`` and ``trace`` keys select the
tiers, with the reference's defaults: telemetry ``metrics`` (the
registry behind ``GET /metrics``), monitor ``on`` (progress, alert
rules and ``GET /status``) and trace ``on`` (request traces, the input
of ``python -m photon_ml_torch.telemetry serve-report``).  Their events
go to the run log at the config's ``log_path`` (JSONL; without one, to
the stdlib logger).

With ``replicas`` > 1 (config or ``--replicas``) the process runs the
supervised fleet instead: N replica server subprocesses, each on the
config's ``device``, behind one health-routed frontend on the
configured port.  Replicas take ephemeral ports, are restarted on an
exit or a wedge with backoff and a circuit breaker, and a newly
published manifest rolls through them one at a time.  ``--fleet-dir``
holds the replicas' configs, run logs, output and info files.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

from photon_ml_torch.config import load_serving_config
from photon_ml_torch.utils.run_log import DEFAULT_FLUSH_EVERY_S, RunLogger


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m photon_ml_torch.serving",
        description="photon-ml online model server (PyTorch/CUDA)")
    p.add_argument("--config", required=True,
                   help="serving config JSON (ServingConfig)")
    p.add_argument("--port", type=int, default=None,
                   help="override config port (0 = ephemeral)")
    p.add_argument("--model-dir", default=None,
                   help="override config model_dir")
    p.add_argument("--spill-dir", default=None,
                   help="override config spill_dir (entity store disk "
                        "tier)")
    p.add_argument("--hot-swap-poll-s", type=float, default=None,
                   dest="hot_swap_poll_s",
                   help="override config hot_swap_poll_s (0 = off)")
    p.add_argument("--replicas", type=int, default=None,
                   help="override config replicas (>1 = supervised "
                        "fleet behind one frontend)")
    p.add_argument("--fleet-dir", default=None,
                   help="fleet workdir (replica configs, logs and info "
                        "files; default: a temporary dir)")
    p.add_argument("--device", default=None,
                   help="override config device: cuda (default) or cpu")
    p.add_argument("--info-file", default=None,
                   help="write {port, pid, url} JSON here once the "
                        "socket binds (atomic)")
    args = p.parse_args(argv)
    config = load_serving_config(args.config)
    for name in ("port", "model_dir", "spill_dir", "hot_swap_poll_s",
                 "replicas", "device"):
        val = getattr(args, name)
        if val is not None:
            setattr(config, name, val)
    config.validate()

    log = RunLogger(config.log_path,
                    run_info={"driver": "serving",
                              "model_dir": config.model_dir,
                              "replicas": config.replicas},
                    flush_every_s=DEFAULT_FLUSH_EVERY_S)
    if config.replicas > 1:
        from photon_ml_torch.serving.fleet import FleetServer

        server = FleetServer(config, run_logger=log,
                             workdir=args.fleet_dir)
    else:
        from photon_ml_torch.serving.server import ModelServer

        server = ModelServer(config, run_logger=log)
    if args.info_file:
        info = {"port": server.port, "pid": os.getpid(),
                "url": f"http://{config.host}:{server.port}"}
        tmp = args.info_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(info, f)
        os.replace(tmp, args.info_file)

    def _stop(signum, frame):
        server._stop_evt.set()   # the drain runs in the main thread

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    rc = 0
    try:
        server.start()
        server.serve_forever()
    except Exception as e:
        print(f"serving failed: {type(e).__name__}: {e}", file=sys.stderr)
        rc = 1
    finally:
        status = server.serving_status()
        server.stop()
        log.close()
        print(json.dumps({"serving": status, "rc": rc}))
    return rc


if __name__ == "__main__":
    sys.exit(main())

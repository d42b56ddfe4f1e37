"""GAME training driver: config file → trained, evaluated, saved models.

Counterpart of ``photon_ml_tpu/cli/game_training_driver.py``: read the
config, index and read the training and validation data (Avro, JSONL or
LIBSVM), fit the regularization grid with ``GameEstimator`` (or tune it:
``"tuning": {...}`` runs ``GameEstimator.fit_tuned``), select and save
the models (the format the port's server loads) with the index
maps, a ``summary.json`` and the effective ``config.json``.

Usage::

    python -m photon_ml_torch.cli.game_training_driver --config cfg.json \\
        [--output-dir DIR] [--device cuda|cpu] [--spill-dir S] \\
        [--host-max-resident N] [--prefetch-depth N] \\
        [--re-chunk-entities N] [--re-retirement on|off] \\
        [--cd-fused on|off] \\
        [--checkpoint-dir D] [--checkpoint-every-sweeps N] \\
        [--checkpoint-every-solver-iters N] [--resume] \\
        [--telemetry off|metrics|trace] [--telemetry-dir DIR] \\
        [--monitor on|off] [--monitor-every-s S] [--status-port P]

The run is on the card unless ``--device cpu`` (or ``"device": "cpu"``
in the config) asks for the CPU; without CUDA it raises.  A chunked fit
(``chunk_rows``) spills its fixed effect to ``--spill-dir``;
``--re-chunk-entities`` streams each random effect from the spill dir in
entity chunks (retiring converged entities unless ``--re-retirement
off``), and ``--cd-fused on`` makes each coordinate-descent cycle one
store pass over the chunked fixed effect and every random effect; with
``--checkpoint-dir`` it snapshots, and ``--resume`` continues from the
most advanced snapshot, appending to the run log.  ``--telemetry
metrics|trace`` opens a telemetry session over the whole run, sharing
the run log (``python -m photon_ml_torch.telemetry report
<out>/run_log.jsonl`` reads it; trace mode also writes
``<telemetry_dir or out>/trace.json``), and the config's ``profile_dir``
runs the fit phase under ``torch.profiler``.  ``--monitor on`` opens
the live monitor over the whole pipeline: progress, ETA and alert
events in the run log (``python -m photon_ml_torch.telemetry watch
<out>/run_log.jsonl`` follows it); ``--status-port P`` (which implies
it) serves ``GET /status`` and ``/metrics`` on 127.0.0.1.

Launched as one host of a multi-host training fleet (the
``PHOTON_FLEET_NUM_HOSTS`` / ``PHOTON_FLEET_HOST_ID`` /
``PHOTON_FLEET_COORDINATOR`` trio, with a ``parallel.fleet``
``ReduceCoordinator`` run by the launcher), the run streams only its
host's chunk shard, reduces every chunk step over tcp, and writes its
outputs under ``host_NNN/`` of the output dir; its run log's
``run_info`` carries ``fleet_host``, ``fleet_hosts`` and
``fleet_transport``.  ``n_devices`` shards the fit over a mesh
(``parallel.mesh``).  ``distributed_init`` first joins a
``torch.distributed`` process group from ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` (the JAX package's names, so
one launcher serves both packages; NCCL on the card, gloo on the CPU);
under a world of more than one process the fleet then reduces over
``torch.distributed`` (the psum transport).
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from photon_ml_torch import telemetry
from photon_ml_torch.cache import enable_compilation_cache
from photon_ml_torch.telemetry import monitor as _mon
from photon_ml_torch.config import (
    CoordinateKind,
    TrainingConfig,
    config_to_json,
    load_training_config,
)
from photon_ml_torch.estimators.game_estimator import FitResult, GameEstimator
from photon_ml_torch.game.dataset import GameDataset
from photon_ml_torch.io.dataset import (
    build_index_maps,
    detect_format,
    read_game_dataset,
)
from photon_ml_torch.io.index_map import load_index_maps, save_index_maps
from photon_ml_torch.io.libsvm import read_libsvm
from photon_ml_torch.io.model_io import save_game_model
from photon_ml_torch.utils.run_log import DEFAULT_FLUSH_EVERY_S, RunLogger

logger = logging.getLogger(__name__)


def _read_libsvm_dataset(path: str, config: TrainingConfig,
                         n_features: int | None = None) -> GameDataset:
    """LIBSVM → a one-shard GameDataset (one fixed-effect coordinate)."""
    fixed = [c for c in config.coordinates
             if c.kind == CoordinateKind.FIXED_EFFECT]
    if len(config.coordinates) != 1 or not fixed:
        raise ValueError(
            "LIBSVM input supports exactly one fixed-effect coordinate; "
            "use JSONL or Avro records for GAME configs")
    shard = fixed[0].feature_shard
    rows, labels, dim = read_libsvm(path, n_features=n_features)
    return GameDataset(labels=labels, features={shard: rows}, entity_ids={},
                       feature_dims={shard: dim})


def prepare_data(config: TrainingConfig, log: RunLogger):
    """Read (and index) the training and validation data → (train,
    validation, feature_maps, entity_maps); the maps are None for
    LIBSVM input (its indices are literal)."""
    fmt = detect_format(config.input_path, config.input_format)
    feature_maps = entity_maps = None
    if fmt == "libsvm":
        with log.timed("read_training_data", format=fmt):
            train = _read_libsvm_dataset(config.input_path, config)
        valid = None
        if config.validation_path:
            with log.timed("read_validation_data", format=fmt):
                valid = _read_libsvm_dataset(
                    config.validation_path, config,
                    n_features=train.feature_dim(next(iter(train.features))))
    else:
        shards = sorted({c.feature_shard for c in config.coordinates})
        entity_keys = sorted({c.entity_key for c in config.coordinates
                              if c.entity_key})
        with log.timed("prepare_feature_maps"):
            if config.index_dir:
                feature_maps, entity_maps = load_index_maps(config.index_dir)
            else:
                feature_maps, entity_maps = build_index_maps(
                    config.input_path, shards, entity_keys)
        dense = tuple(config.dense_feature_shards)
        with log.timed("read_training_data", format=fmt):
            # Training extends the entity maps with ids the prebuilt
            # maps miss; the extended maps are the ones saved.
            train = read_game_dataset(
                config.input_path, feature_maps, entity_maps,
                dense_shards=dense, extend_entity_maps=True)
        valid = None
        if config.validation_path:
            with log.timed("read_validation_data", format=fmt):
                valid = read_game_dataset(
                    config.validation_path, feature_maps, entity_maps,
                    dense_shards=dense)

    if valid is None and config.validation_fraction > 0.0:
        rng = np.random.default_rng(config.seed)
        perm = rng.permutation(train.n)
        n_valid = int(round(train.n * config.validation_fraction))
        valid = train.take(perm[:n_valid])
        train = train.take(perm[n_valid:])
        log.event("validation_split", n_train=train.n, n_valid=valid.n)
    return train, valid, feature_maps, entity_maps


def _save_result(result: FitResult, estimator: GameEstimator,
                 model_dir: str) -> dict:
    save_game_model(result.model, estimator.task, model_dir)
    return {
        "model_dir": model_dir,
        "reg_weights": result.reg_weights,
        "evaluations": {ev.value: v for ev, v in result.evaluations.items()},
        "validation_history": [
            {str(getattr(ev, "value", ev)): float(v)
             for ev, v in entry.items()} if isinstance(entry, dict)
            else float(entry)
            for entry in result.validation_history],
    }


def distributed_init_from_env(device=None) -> bool:
    """Join a ``torch.distributed`` process group before the fit: the
    coordinator address, world size and rank come from
    ``JAX_COORDINATOR_ADDRESS`` (``host:port``; a free local port for a
    world of one), ``JAX_NUM_PROCESSES`` (default 1) and
    ``JAX_PROCESS_ID`` (default 0).  The backend follows the run's
    device: ``"nccl"`` on CUDA, ``"gloo"`` on the CPU.  Returns at once
    (False) if a group is already initialized; True when it made one."""
    import socket

    import torch
    import torch.distributed as dist

    from photon_ml_torch.config import read_env
    from photon_ml_torch.device import resolve_device

    if dist.is_initialized():
        return False
    world = int(read_env("JAX_NUM_PROCESSES") or 1)
    rank = int(read_env("JAX_PROCESS_ID") or 0)
    address = read_env("JAX_COORDINATOR_ADDRESS")
    if not address:
        if world > 1:
            raise ValueError(
                "distributed_init with JAX_NUM_PROCESSES > 1 needs "
                "JAX_COORDINATOR_ADDRESS (host:port)")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            address = f"127.0.0.1:{s.getsockname()[1]}"
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank)
    logger.info("distributed: rank %d of %d (%s, %s)", rank, world,
                backend, address)
    return True


def _distributed_info() -> dict:
    """The run log's record of an initialized process group: backend,
    world size and rank."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return {}
    return {"distributed": {"backend": dist.get_backend(),
                            "world": dist.get_world_size(),
                            "rank": dist.get_rank()}}


def run(config: TrainingConfig, log: RunLogger | None = None) -> dict:
    """The whole training pipeline; returns the written summary."""
    config.validate()
    # The kernel build cache first, before any kernel builds
    # (cache.compile_cache; falls back to $PHOTON_ML_TPU_COMPILE_CACHE,
    # no-op when neither is set).
    enable_compilation_cache(config.compilation_cache_dir)
    made_group = (distributed_init_from_env(config.device)
                  if config.distributed_init else False)
    try:
        return _run_joined(config, log)
    finally:
        if made_group:
            import torch.distributed as dist

            from photon_ml_torch.parallel import fleet

            fleet.deactivate()
            dist.destroy_process_group()


def _run_joined(config: TrainingConfig, log: RunLogger | None) -> dict:
    # A host of a multi-host fleet (the PHOTON_FLEET_* trio, or a world
    # of processes) joins it and writes its own output tree (run log,
    # summary, model, telemetry) under host_NNN/; `telemetry
    # fleet-report` joins the hosts' logs.
    from photon_ml_torch.parallel import fleet

    fctx = fleet.initialize_from_env()
    in_fleet = fctx is not None and fctx.is_fleet
    if in_fleet:
        config.output_dir = fleet.host_dir(config.output_dir, fctx)
    os.makedirs(config.output_dir, exist_ok=True)
    # A resumed run appends: the log then holds both runs, each opening
    # with its run_header.
    # The telemetry session shares the logger, so spans and heartbeats
    # land in the JSONL the report reads.
    with (log or RunLogger(os.path.join(config.output_dir, "run_log.jsonl"),
                           mode=("a" if config.resume else "w"),
                           header=True,
                           run_info={"driver": "game_training",
                                     "device": config.device,
                                     "telemetry": config.telemetry,
                                     "resume": config.resume,
                                     **({"fleet_host": fctx.host_id,
                                         "fleet_hosts": fctx.n_hosts,
                                         "fleet_transport": fctx.transport}
                                        if in_fleet else {}),
                                     **_distributed_info()},
                           flush_every_s=DEFAULT_FLUSH_EVERY_S)) as log, \
            telemetry.maybe_session(
                config.telemetry,
                config.telemetry_dir or config.output_dir,
                run_logger=log, device=config.device), \
            _mon.maybe_monitor(
                config.monitor == "on", run_logger=log,
                status_port=config.status_port,
                every_s=config.monitor_every_s):
        # The monitor spans the whole pipeline (the data phases too);
        # the estimator's own maybe_monitor then adds nothing.
        return _run(config, log)


def _run(config: TrainingConfig, log: RunLogger) -> dict:
    log.event("config", config=json.loads(config_to_json(config)))
    estimator = GameEstimator(config)      # resolves (and checks) the device
    train, valid, feature_maps, entity_maps = prepare_data(config, log)
    log.event("datasets", n_train=train.n,
              n_valid=(valid.n if valid is not None else 0))
    if config.tuning is not None:
        if valid is None:
            raise ValueError(
                "hyperparameter tuning needs validation data "
                "(validation_path or validation_fraction)")
        with log.timed("fit", profile_dir=config.profile_dir,
                       mode="tuning", trials=config.tuning.n_trials):
            results = estimator.fit_tuned(train, valid, run_logger=log)
    else:
        with log.timed("fit", profile_dir=config.profile_dir):
            results = estimator.fit(train, validation=valid, run_logger=log)
    best = estimator.best(results)
    for i, r in enumerate(results):
        log.event("grid_result", index=i, reg_weights=r.reg_weights,
                  evaluations={ev.value: v
                               for ev, v in r.evaluations.items()},
                  best=(r is best))

    summary = {"models": [],
               "best_index": next(i for i, r in enumerate(results)
                                  if r is best)}
    with log.timed("save_models", mode=config.model_output_mode):
        if config.model_output_mode == "ALL":
            for i, r in enumerate(results):
                summary["models"].append(_save_result(
                    r, estimator,
                    os.path.join(config.output_dir, f"model_{i}")))
        else:  # BEST (EXPLICIT is BEST without a tuning run)
            summary["models"].append(_save_result(
                best, estimator, os.path.join(config.output_dir, "model")))
        if feature_maps is not None:
            save_index_maps(os.path.join(config.output_dir, "index_maps"),
                            feature_maps, entity_maps)
    with open(os.path.join(config.output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    with open(os.path.join(config.output_dir, "config.json"), "w") as f:
        f.write(config_to_json(config))
    log.event("done", best_index=summary["best_index"])
    return summary


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(
        description="photon_ml_torch GAME training driver")
    parser.add_argument("--config", required=True,
                        help="training config JSON file")
    parser.add_argument("--output-dir", default=None,
                        help="override config output_dir")
    parser.add_argument("--device", default=None,
                        help="override config device: cuda (default), "
                             "cuda:<n> or cpu")
    parser.add_argument("--spill-dir", default=None,
                        help="override config spill_dir: out-of-core "
                             "chunk store directory (default also "
                             "$PHOTON_ML_TPU_SPILL_DIR)")
    parser.add_argument("--host-max-resident", type=int, default=None,
                        help="override config host_max_resident: "
                             "decoded chunks kept live in host RAM "
                             "when spilling")
    parser.add_argument("--prefetch-depth", type=int, default=None,
                        help="override config prefetch_depth: chunks "
                             "prefetched disk->host->card ahead of "
                             "compute (0 disables the thread)")
    parser.add_argument("--re-chunk-entities", type=int, default=None,
                        help="override config re_chunk_entities: "
                             "out-of-core random-effect training, "
                             "entities a streamed chunk a size bucket "
                             "(requires a spill dir)")
    parser.add_argument("--re-retirement", choices=("on", "off"),
                        default=None,
                        help="override config re_retirement: freeze "
                             "converged entities between CD sweeps")
    parser.add_argument("--cd-fused", choices=("on", "off"), default=None,
                        help="override config cd_fused: one streamed "
                             "store pass a CD cycle accumulates every "
                             "coordinate's statistics (Jacobi solves "
                             "against cycle-start offsets); requires "
                             "chunk_rows and smooth regularization")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="override config checkpoint_dir: CD sweep "
                             "state and mid-solve solver state land here")
    parser.add_argument("--resume", action="store_true", default=None,
                        help="resume from the most advanced checkpoint "
                             "in checkpoint_dir (the run log appends)")
    parser.add_argument("--checkpoint-every-sweeps", type=int,
                        default=None,
                        help="override config checkpoint_every_sweeps: "
                             "CD sweep-boundary snapshot cadence")
    parser.add_argument("--checkpoint-every-solver-iters", type=int,
                        default=None,
                        help="override config "
                             "checkpoint_every_solver_iters: streaming-"
                             "solver mid-solve snapshot cadence (0 = "
                             "sweep boundaries only)")
    parser.add_argument("--telemetry", choices=("off", "metrics", "trace"),
                        default=None,
                        help="override config telemetry: pipeline "
                             "spans and metrics into the run log (trace "
                             "also writes trace.json); read with "
                             "python -m photon_ml_torch.telemetry report")
    parser.add_argument("--telemetry-dir", default=None,
                        help="override config telemetry_dir (default: "
                             "the output dir)")
    parser.add_argument("--monitor", choices=("off", "on"), default=None,
                        help="override config monitor: live progress/ETA "
                             "snapshots and online alerts in the run log; "
                             "follow with python -m "
                             "photon_ml_torch.telemetry watch "
                             "<run_log.jsonl>")
    parser.add_argument("--monitor-every-s", type=float, default=None,
                        help="override config monitor_every_s: snapshot "
                             "and alert cadence in seconds")
    parser.add_argument("--status-port", type=int, default=None,
                        help="serve GET /status (JSON) and /metrics "
                             "(Prometheus text) on 127.0.0.1 at this port "
                             "(0 = ephemeral, logged as a status_server "
                             "event); implies --monitor on")
    args = parser.parse_args(argv)
    config = load_training_config(args.config)
    if args.output_dir:
        config.output_dir = args.output_dir
    if args.device is not None:
        config.device = args.device
    for field in ("spill_dir", "host_max_resident", "prefetch_depth",
                  "re_chunk_entities", "checkpoint_dir", "resume",
                  "checkpoint_every_sweeps",
                  "checkpoint_every_solver_iters", "telemetry",
                  "telemetry_dir", "monitor", "monitor_every_s",
                  "status_port"):
        if getattr(args, field) is not None:
            setattr(config, field, getattr(args, field))
    for field in ("re_retirement", "cd_fused"):
        if getattr(args, field) is not None:
            setattr(config, field, getattr(args, field) == "on")
    # Re-validated with the overrides applied.
    config.validate()
    summary = run(config)
    # The last line of stdout: the summary, as JSON.
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

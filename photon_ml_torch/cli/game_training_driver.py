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
        [--checkpoint-every-solver-iters N] [--resume]

The run is on the card unless ``--device cpu`` (or ``"device": "cpu"``
in the config) asks for the CPU; without CUDA it raises.  A chunked fit
(``chunk_rows``) spills its fixed effect to ``--spill-dir``;
``--re-chunk-entities`` streams each random effect from the spill dir in
entity chunks (retiring converged entities unless ``--re-retirement
off``), and ``--cd-fused on`` makes each coordinate-descent cycle one
store pass over the chunked fixed effect and every random effect; with
``--checkpoint-dir`` it snapshots, and ``--resume`` continues from the
most advanced snapshot, appending to the run log.  The fleet and
multi-host bootstrap (ROADMAP A7), telemetry and the monitor (ROADMAP
A8b, D3) are not ported: their config fields must stay at their
defaults.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

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


def run(config: TrainingConfig, log: RunLogger | None = None) -> dict:
    """The whole training pipeline; returns the written summary."""
    config.validate()
    os.makedirs(config.output_dir, exist_ok=True)
    # A resumed run appends: the log then holds both runs, each opening
    # with its run_header.
    with (log or RunLogger(os.path.join(config.output_dir, "run_log.jsonl"),
                           mode=("a" if config.resume else "w"),
                           header=True,
                           run_info={"driver": "game_training",
                                     "device": config.device,
                                     "resume": config.resume},
                           flush_every_s=DEFAULT_FLUSH_EVERY_S)) as log:
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
        with log.timed("fit", mode="tuning", trials=config.tuning.n_trials):
            results = estimator.fit_tuned(train, valid, run_logger=log)
    else:
        with log.timed("fit"):
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
    args = parser.parse_args(argv)
    config = load_training_config(args.config)
    if args.output_dir:
        config.output_dir = args.output_dir
    if args.device is not None:
        config.device = args.device
    for field in ("spill_dir", "host_max_resident", "prefetch_depth",
                  "re_chunk_entities", "checkpoint_dir", "resume",
                  "checkpoint_every_sweeps",
                  "checkpoint_every_solver_iters"):
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

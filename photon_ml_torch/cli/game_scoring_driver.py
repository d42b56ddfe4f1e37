"""GAME scoring driver: saved model + data → scores (+ evaluation).

Counterpart of ``photon_ml_tpu/cli/game_scoring_driver.py``, its
resident path: load the model, read the data with the training run's
index maps, ``GameTransformer.transform`` (B1 on the card for the fixed
effect), write the scores, evaluate against the labels.

Usage::

    python -m photon_ml_torch.cli.game_scoring_driver --config score.json \\
        [--device cuda|cpu]

The output is an ``.npz`` with the raw margins (``scores``), mean-space
``predictions`` and the ``labels``, plus ``evaluation.json`` beside it
when evaluators are configured; an ``output_path`` ending in ``.avro``
writes ``ScoringResultAvro`` records instead; both through the chunked
sinks of ``io.score_sink`` (the reference writes its resident ``.npz``
with ``np.savez``; ``np.load`` reads either alike).  The
run is on the card unless ``--device cpu`` (or ``"device": "cpu"``)
asks for the CPU; without CUDA it raises.  The streamed pipeline
(``score_chunk_rows`` and its knobs) is ROADMAP A5b, telemetry A8b and
the monitor D3: ``ScoringConfig.validate`` raises on them.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from photon_ml_torch.config import ScoringConfig, load_scoring_config
from photon_ml_torch.device import resolve_device
from photon_ml_torch.estimators.game_transformer import GameTransformer
from photon_ml_torch.evaluation.evaluators import evaluate
from photon_ml_torch.game.dataset import GameDataset
from photon_ml_torch.io.dataset import detect_format, read_game_dataset
from photon_ml_torch.io.index_map import load_index_maps
from photon_ml_torch.io.libsvm import read_libsvm
from photon_ml_torch.io.model_io import load_game_model
from photon_ml_torch.models.game import FixedEffectModel, RandomEffectModel
from photon_ml_torch.utils.run_log import DEFAULT_FLUSH_EVERY_S, RunLogger

# Rows a chunk of the mean function and of the Avro sink's blocks.
_MEAN_CHUNK = 1 << 20


def _read_data(config: ScoringConfig, model, log: RunLogger) -> GameDataset:
    fmt = detect_format(config.input_path, config.input_format)
    if fmt == "libsvm":
        fixed = [m for m in model.models.values()
                 if isinstance(m, FixedEffectModel)]
        if len(model.models) != 1 or not fixed:
            raise ValueError("LIBSVM scoring needs a single fixed-effect "
                             "model; use JSONL records for GAME models")
        shard = fixed[0].feature_shard
        # The model's width fixes the feature space (less the intercept
        # column the estimator appended).
        dim = len(fixed[0].coefficients.means)
        if fixed[0].intercept:
            dim -= 1
        with log.timed("read_scoring_data", format=fmt):
            rows, labels, _ = read_libsvm(config.input_path, n_features=dim)
        return GameDataset(labels=labels, features={shard: rows},
                           entity_ids={}, feature_dims={shard: dim})

    index_dir = config.index_dir or os.path.join(
        os.path.dirname(os.path.abspath(config.model_dir)), "index_maps")
    with log.timed("prepare_feature_maps"):
        feature_maps, entity_maps = load_index_maps(index_dir)
    # Non-projected random effects score a dense per-entity shard; the
    # model knows which those are.
    dense = set(config.dense_feature_shards)
    dense.update(m.feature_shard for m in model.models.values()
                 if isinstance(m, RandomEffectModel) and m.projection is None)
    with log.timed("read_scoring_data", format=fmt):
        return read_game_dataset(config.input_path, feature_maps,
                                 entity_maps, dense_shards=tuple(dense))


def _mean_chunked(task, margins: np.ndarray, device) -> np.ndarray:
    """Mean-space predictions, a device chunk at a time."""
    out = np.empty(len(margins), np.float32)
    for lo in range(0, len(margins), _MEAN_CHUNK):
        hi = min(lo + _MEAN_CHUNK, len(margins))
        out[lo:hi] = task.loss.mean(torch.from_numpy(
            margins[lo:hi]).to(device)).cpu().numpy()
    return out


def _make_sinks(config: ScoringConfig, n: int, entity_keys) -> list:
    if config.output_path.endswith(".avro"):
        from photon_ml_torch.io.score_sink import AvroScoreSink

        return [AvroScoreSink(config.output_path,
                              ids_keys=tuple(entity_keys))]
    from photon_ml_torch.io.score_sink import NpzScoreSink

    # An extensionless path gets ".npz", as np.savez would give it.
    path = config.output_path
    if not path.endswith(".npz"):
        path += ".npz"
    return [NpzScoreSink(path, n)]


def run(config: ScoringConfig, log: RunLogger | None = None) -> dict:
    """The whole scoring pipeline; returns the output path, the row
    count and the evaluation."""
    config.validate()
    out_dir = os.path.dirname(os.path.abspath(config.output_path))
    os.makedirs(out_dir, exist_ok=True)
    with (log or RunLogger(os.path.join(out_dir, "scoring_log.jsonl"),
                           run_info={"driver": "game_scoring",
                                     "device": config.device},
                           flush_every_s=DEFAULT_FLUSH_EVERY_S)) as log:
        return _run(config, log)


def _run(config: ScoringConfig, log: RunLogger) -> dict:
    dev = resolve_device(config.device)
    out_dir = os.path.dirname(os.path.abspath(config.output_path))
    with log.timed("load_model"):
        model, task = load_game_model(config.model_dir)
    data = _read_data(config, model, log)
    log.event("dataset", n=data.n)

    transformer = GameTransformer(model=model, task=task, device=str(dev))
    with log.timed("transform"):
        margins = transformer.transform(data)
    predictions = _mean_chunked(task, margins, dev)

    # One chunk at a time: an .npz member or an Avro container block.
    sink = _make_sinks(config, data.n, data.entity_ids)[0]
    try:
        for lo in range(0, data.n, _MEAN_CHUNK):
            hi = min(lo + _MEAN_CHUNK, data.n)
            sink.write(lo, hi, margins[lo:hi], predictions[lo:hi],
                       data.labels[lo:hi],
                       ids={k: v[lo:hi] for k, v in data.entity_ids.items()})
        sink.close()
    except BaseException:
        sink.abort()
        raise

    evaluation = {}
    if config.evaluators:
        labels = torch.from_numpy(data.labels.astype(np.float32))
        weights = torch.from_numpy(data.weight_array())
        for ev in config.evaluators:
            scores = margins
            if ev.value in ("RMSE", "SQUARED_LOSS"):
                scores = predictions
            evaluation[ev.value] = float(evaluate(
                ev, torch.from_numpy(scores), labels, weights))
        with open(os.path.join(out_dir, "evaluation.json"), "w") as f:
            json.dump(evaluation, f, indent=2)
        log.event("evaluation", **evaluation)

    log.event("done", output=config.output_path)
    return {"output_path": config.output_path, "n": int(data.n),
            "evaluation": evaluation}


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(
        description="photon_ml_torch GAME scoring driver")
    parser.add_argument("--config", required=True,
                        help="scoring config JSON file")
    parser.add_argument("--device", default=None,
                        help="override config device: cuda (default), "
                             "cuda:<n> or cpu")
    args = parser.parse_args(argv)
    config = load_scoring_config(args.config)
    if args.device is not None:
        config.device = args.device
    result = run(config)      # run() re-validates (the override included)
    # The last line of stdout: the result, as JSON.
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

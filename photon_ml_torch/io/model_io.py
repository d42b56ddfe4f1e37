"""GameModel persistence: save/load a model directory.

Counterpart of ``photon_ml_tpu/io/model_io.py``, in the same two
on-disk layouts, so a directory written by either package loads in the
other:

- ``model_manifest.npz``: the whole model as ONE atomically replaced
  file, encoded with the checkpoint state-tree codec (``flatten_tree``
  + ``atomic_savez``).  It is the server's load and hot-swap unit, and
  ``load_game_model`` prefers it.
- the legacy layout: ``metadata.json`` + one ``<coordinate>.npz`` per
  coordinate, read when there is no manifest.

``game_model_from_tree`` turns the numpy state tree (the manifest's
content, equal to what the JAX package's ``_model_tree`` produces) into
the port's ``(GameModel, TaskType)``: the way weights cross from one
package to the other.  ``export_model_avro`` writes the reference's
``BayesianLinearModelAvro`` files, byte for byte what the JAX package
writes for the same model (given the same container sync marker).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from photon_ml_torch.cache.plan_cache import atomic_savez
from photon_ml_torch.game.dataset import EntityGrouping
from photon_ml_torch.game.projector import SubspaceProjection
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.reliability.checkpoint import (
    flatten_tree,
    unflatten_tree,
)

MODEL_MANIFEST_FILE = "model_manifest.npz"
MODEL_MANIFEST_SCHEMA = 1


def model_manifest_path(model_dir: str) -> str:
    return os.path.join(model_dir, MODEL_MANIFEST_FILE)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def model_tree(model: GameModel, task: TaskType) -> dict:
    """GameModel → checkpoint state tree (the manifest's content)."""
    coords: dict = {}
    for name, comp in model.models.items():
        if isinstance(comp, FixedEffectModel):
            variances = comp.coefficients.variances
            coords[name] = {
                "kind": "FIXED_EFFECT",
                "feature_shard": comp.feature_shard,
                "intercept": bool(comp.intercept),
                "means": _np(comp.coefficients.means),
                "variances": None if variances is None else _np(variances),
            }
        elif isinstance(comp, RandomEffectModel):
            g = comp.grouping
            coords[name] = {
                "kind": "RANDOM_EFFECT",
                "feature_shard": comp.feature_shard,
                "entity_key": comp.entity_key,
                "global_dim": (comp.projection.global_dim
                               if comp.projection else None),
                "grouping": {
                    "entity_ids": np.asarray(g.entity_ids),
                    "entity_counts": np.asarray(g.entity_counts),
                    "entity_bucket": np.asarray(g.entity_bucket),
                    "entity_slot": np.asarray(g.entity_slot),
                    "capacities": [int(c) for c in g.capacities],
                    "n_entities": [int(c) for c in g.n_entities],
                },
                "blocks": [_np(b) for b in comp.coefficient_blocks],
                "variance_blocks": (
                    None if comp.variance_blocks is None
                    else [_np(b) for b in comp.variance_blocks]),
                "proj_feature_ids": (
                    None if comp.projection is None
                    else [np.asarray(f)
                          for f in comp.projection.feature_ids]),
            }
        else:
            raise TypeError(f"unknown component model {type(comp)}")
    return {"task": task.value, "coordinates": coords}


def _grouping(entity_ids, entity_counts, entity_bucket, entity_slot,
              capacities, n_entities) -> EntityGrouping:
    return EntityGrouping(
        n_examples=0,  # example-level maps are training state
        entity_ids=np.asarray(entity_ids),
        entity_counts=np.asarray(entity_counts),
        entity_bucket=np.asarray(entity_bucket),
        entity_slot=np.asarray(entity_slot),
        capacities=[int(x) for x in capacities],
        n_entities=[int(x) for x in n_entities],
        example_bucket=np.empty(0, np.int64),
        example_row=np.empty(0, np.int64),
        example_col=np.empty(0, np.int64),
    )


def game_model_from_tree(tree: dict) -> tuple[GameModel, TaskType]:
    """Checkpoint state tree (numpy leaves) → (GameModel, TaskType)."""
    task = TaskType(tree["task"])
    models: dict = {}
    for name, c in tree["coordinates"].items():
        if c["kind"] == "FIXED_EFFECT":
            models[name] = FixedEffectModel(
                coefficients=Coefficients(
                    means=_tensor(c["means"]),
                    variances=(None if c["variances"] is None
                               else _tensor(c["variances"]))),
                feature_shard=c["feature_shard"],
                intercept=bool(c["intercept"]),
            )
        elif c["kind"] == "RANDOM_EFFECT":
            g = c["grouping"]
            projection = None
            if c["proj_feature_ids"] is not None:
                projection = SubspaceProjection(
                    feature_ids=[np.asarray(f)
                                 for f in c["proj_feature_ids"]],
                    global_dim=int(c["global_dim"]))
            models[name] = RandomEffectModel(
                coefficient_blocks=[_tensor(b) for b in c["blocks"]],
                grouping=_grouping(
                    g["entity_ids"], g["entity_counts"],
                    g["entity_bucket"], g["entity_slot"],
                    g["capacities"], g["n_entities"]),
                feature_shard=c["feature_shard"],
                variance_blocks=(
                    None if c["variance_blocks"] is None
                    else [_tensor(b) for b in c["variance_blocks"]]),
                projection=projection,
                entity_key=c["entity_key"],
            )
        else:
            raise ValueError(f"unknown coordinate kind {c['kind']!r}")
    return GameModel(models=models), task


def save_model_manifest(model: GameModel, task: TaskType,
                        out_dir: str) -> str:
    """Write the one-file manifest (atomic tmp + ``os.replace`` — the
    hot-swap publish primitive).  Returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    tree_meta, arrays = flatten_tree(model_tree(model, task))
    path = model_manifest_path(out_dir)
    atomic_savez(path, {"kind": "game_model",
                        "schema": MODEL_MANIFEST_SCHEMA,
                        "tree": tree_meta}, arrays)
    return path


def load_model_manifest(model_dir: str) -> tuple[GameModel, TaskType]:
    """Load ``<model_dir>/model_manifest.npz``; raises on a missing,
    corrupt or mismatched file (the server's swap watcher catches it
    and keeps the previous good model)."""
    path = model_manifest_path(model_dir)
    with np.load(path, allow_pickle=False) as z:
        if "__meta__" not in z.files:
            raise ValueError(f"model manifest {path}: no __meta__ "
                             "member (not an atomic_savez file)")
        meta = json.loads(bytes(np.asarray(z["__meta__"])).decode())
        arrays = {key: np.asarray(z[key]) for key in z.files
                  if key != "__meta__"}
    if meta.get("kind") != "game_model":
        raise ValueError(f"model manifest {path}: kind "
                         f"{meta.get('kind')!r} != 'game_model'")
    if meta.get("schema") != MODEL_MANIFEST_SCHEMA:
        raise ValueError(f"model manifest {path}: schema "
                         f"{meta.get('schema')!r} != "
                         f"{MODEL_MANIFEST_SCHEMA}")
    return game_model_from_tree(unflatten_tree(meta["tree"], arrays))


def save_game_model(model: GameModel, task: TaskType, out_dir: str) -> None:
    """Write both layouts; the manifest goes last, as the publish
    signal a hot-swap watcher polls."""
    os.makedirs(out_dir, exist_ok=True)
    meta = {"task_type": task.value, "coordinates": {}}
    for name, comp in model.models.items():
        path = os.path.join(out_dir, f"{name}.npz")
        if isinstance(comp, FixedEffectModel):
            meta["coordinates"][name] = {
                "kind": "FIXED_EFFECT", "feature_shard": comp.feature_shard,
                "intercept": comp.intercept,
            }
            arrs = {"means": _np(comp.coefficients.means)}
            if comp.coefficients.variances is not None:
                arrs["variances"] = _np(comp.coefficients.variances)
            np.savez(path, **arrs)
        elif isinstance(comp, RandomEffectModel):
            meta["coordinates"][name] = {
                "kind": "RANDOM_EFFECT", "feature_shard": comp.feature_shard,
                "entity_key": comp.entity_key,
                "n_buckets": len(comp.coefficient_blocks),
                "projected": comp.projection is not None,
                "global_dim": (comp.projection.global_dim
                               if comp.projection else None),
            }
            g = comp.grouping
            arrs = {
                "entity_ids": g.entity_ids,
                "entity_counts": g.entity_counts,
                "entity_bucket": g.entity_bucket,
                "entity_slot": g.entity_slot,
                "capacities": np.asarray(g.capacities),
                "n_entities": np.asarray(g.n_entities),
            }
            for b, blk in enumerate(comp.coefficient_blocks):
                arrs[f"block_{b}"] = _np(blk)
            if comp.variance_blocks is not None:
                for b, blk in enumerate(comp.variance_blocks):
                    arrs[f"variance_block_{b}"] = _np(blk)
            if comp.projection is not None:
                for b, fids in enumerate(comp.projection.feature_ids):
                    arrs[f"proj_feature_ids_{b}"] = fids
            np.savez(path, **arrs)
        else:
            raise TypeError(f"unknown component model {type(comp)}")
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    save_model_manifest(model, task, out_dir)


def load_game_model(model_dir: str) -> tuple[GameModel, TaskType]:
    """Load a model directory: the manifest when present, else the
    legacy metadata.json + per-coordinate npz layout."""
    if os.path.exists(model_manifest_path(model_dir)):
        return load_model_manifest(model_dir)
    with open(os.path.join(model_dir, "metadata.json")) as f:
        meta = json.load(f)
    coords: dict = {}
    for name, info in meta["coordinates"].items():
        with np.load(os.path.join(model_dir, f"{name}.npz")) as data:
            if info["kind"] == "FIXED_EFFECT":
                coords[name] = {
                    "kind": "FIXED_EFFECT",
                    "feature_shard": info["feature_shard"],
                    "intercept": bool(info.get("intercept", False)),
                    "means": data["means"],
                    "variances": (data["variances"]
                                  if "variances" in data else None),
                }
                continue
            nb = int(info["n_buckets"])
            coords[name] = {
                "kind": "RANDOM_EFFECT",
                "feature_shard": info["feature_shard"],
                "entity_key": info.get("entity_key"),
                "global_dim": info.get("global_dim"),
                "grouping": {k: data[k] for k in (
                    "entity_ids", "entity_counts", "entity_bucket",
                    "entity_slot", "capacities", "n_entities")},
                "blocks": [data[f"block_{b}"] for b in range(nb)],
                "variance_blocks": (
                    [data[f"variance_block_{b}"] for b in range(nb)]
                    if "variance_block_0" in data else None),
                "proj_feature_ids": (
                    [data[f"proj_feature_ids_{b}"] for b in range(nb)]
                    if info.get("projected") else None),
            }
    return game_model_from_tree({"task": meta["task_type"],
                                 "coordinates": coords})


def export_model_avro(model: GameModel, task: TaskType, feature_maps: dict,
                      out_dir: str) -> list[str]:
    """Write one ``BayesianLinearModelAvro`` container a coordinate.

    Coefficients are keyed by (name, term), so the file is portable
    across feature-index rebuilds.  A fixed effect is one record; a
    random effect one record an entity (``modelId`` = the entity id).

    ``feature_maps``: feature shard → IndexMap, covering every shard the
    model references; the intercept column the estimator appends is
    written as name="(INTERCEPT)".
    """
    from photon_ml_torch.io.avro import write_container
    from photon_ml_torch.io.avro_schemas import (
        bayesian_linear_model_schema,
        write_model_avro,
    )

    os.makedirs(out_dir, exist_ok=True)
    written = []

    def keyer(imap):
        def index_to_key(i):
            if i >= len(imap):          # the estimator-appended intercept
                return ("(INTERCEPT)", "")
            return imap.feature_at(i)
        return index_to_key

    for name, comp in model.models.items():
        path = os.path.join(out_dir, f"{name}.avro")
        if isinstance(comp, FixedEffectModel):
            means = _np(comp.coefficients.means)
            variances = (None if comp.coefficients.variances is None
                         else _np(comp.coefficients.variances))
            write_model_avro(
                path, name, means, keyer(feature_maps[comp.feature_shard]),
                variances=variances, loss_function=task.value)
        elif isinstance(comp, RandomEffectModel):
            key = keyer(feature_maps[comp.feature_shard])

            def records(comp=comp, key=key):
                for eid in np.asarray(comp.grouping.entity_ids):
                    w = comp.global_coefficients_for(int(eid))
                    if w is None:
                        continue
                    yield {
                        "modelId": str(int(eid)),
                        "modelClass": "",
                        "lossFunction": task.value,
                        "means": [
                            {"name": key(int(i))[0], "term": key(int(i))[1],
                             "value": float(w[i])}
                            for i in np.nonzero(w)[0]],
                        "variances": None,
                    }

            write_container(path, bayesian_linear_model_schema(), records())
        else:
            raise TypeError(f"unknown component model {type(comp)}")
        written.append(path)
    return written

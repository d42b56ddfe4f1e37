"""Photon-ML's Avro schemas + GameDataset/model adapters.

Counterpart of ``photon_ml_tpu/io/avro_schemas.py`` (numpy, copied):
the records of ``photon-avro-schemas`` (``TrainingExampleAvro``,
``ScoringResultAvro``, ``BayesianLinearModelAvro``,
``NameTermValueAvro``, ``FeatureSummarizationResultAvro``) and the
flexible GAME data schema (feature bags as ``array<FeatureAvro>``
fields named per feature shard, random-effect ids as string fields).

The adapters translate between these records and the host-side record
shape of ``io.dataset`` (``{"label", "weight", "offset", "features":
{bag: [(name, term, value), ...]}, "ids": {key: id}}``), so the JSONL
and Avro paths share one index-resolution pipeline.

The records keep the JAX package's namespace (``photon_ml_tpu.avro``):
it is part of every file's schema, and the two packages write the same
files.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator

import numpy as np

from photon_ml_torch.io.avro import Schema, read_container, write_container

NAME_TERM_VALUE = {
    "type": "record",
    "name": "NameTermValueAvro",
    "namespace": "photon_ml_tpu.avro",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string", "default": ""},
        {"name": "value", "type": "double"},
    ],
}


def training_example_schema(
    feature_bags: Iterable[str] = ("features",),
    id_fields: Iterable[str] = (),
) -> Schema:
    """The flexible GAME training-record schema: one ``array<FeatureAvro>``
    field per feature bag, one nullable string field per entity id."""
    fields: list[dict] = [
        {"name": "label", "type": "double"},
        {"name": "weight", "type": "double", "default": 1.0},
        {"name": "offset", "type": "double", "default": 0.0},
    ]
    first = True
    for bag in feature_bags:
        items = NAME_TERM_VALUE if first else "NameTermValueAvro"
        first = False
        fields.append({
            "name": bag,
            "type": {"type": "array", "items": items},
            "default": [],
        })
    for key in id_fields:
        fields.append({
            "name": key, "type": ["null", "string"], "default": None
        })
    return Schema({
        "type": "record",
        "name": "TrainingExampleAvro",
        "namespace": "photon_ml_tpu.avro",
        "fields": fields,
    })


SCORING_RESULT_SCHEMA = Schema({
    "type": "record",
    "name": "ScoringResultAvro",
    "namespace": "photon_ml_tpu.avro",
    "fields": [
        {"name": "uid", "type": "long"},
        {"name": "predictionScore", "type": "double"},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "ids", "type": {"type": "map", "values": "string"},
         "default": {}},
    ],
})


def bayesian_linear_model_schema() -> Schema:
    """Saved-model record: (name, term)-keyed means and optional
    variances — the reference's ``BayesianLinearModelAvro`` shape, which
    is what makes saved models portable across feature-index rebuilds."""
    return Schema({
        "type": "record",
        "name": "BayesianLinearModelAvro",
        "namespace": "photon_ml_tpu.avro",
        "fields": [
            {"name": "modelId", "type": "string"},
            {"name": "modelClass", "type": "string", "default": ""},
            {"name": "lossFunction", "type": "string", "default": ""},
            {"name": "means",
             "type": {"type": "array", "items": NAME_TERM_VALUE}},
            {"name": "variances",
             "type": ["null",
                      {"type": "array", "items": "NameTermValueAvro"}],
             "default": None},
        ],
    })


# ---------------------------------------------------------------------------
# Record-shape adapters (Avro <-> io.dataset record dicts)
# ---------------------------------------------------------------------------


def avro_to_dataset_record(
    rec: dict,
    feature_bags: Iterable[str],
    id_fields: Iterable[str],
) -> dict:
    out: dict[str, Any] = {
        "label": rec.get("label", 0.0),
        "weight": rec.get("weight", 1.0),
        "offset": rec.get("offset", 0.0),
        "features": {
            bag: [(e["name"], e.get("term", ""), e["value"])
                  for e in rec.get(bag, [])]
            for bag in feature_bags
        },
    }
    ids = {k: rec[k] for k in id_fields if rec.get(k) is not None}
    if ids:
        out["ids"] = ids
    return out


def dataset_record_to_avro(
    rec: dict,
    feature_bags: Iterable[str],
    id_fields: Iterable[str],
) -> dict:
    out: dict[str, Any] = {
        "label": float(rec.get("label", 0.0)),
        "weight": float(rec.get("weight", 1.0)),
        "offset": float(rec.get("offset", 0.0)),
    }
    feats = rec.get("features", {})
    for bag in feature_bags:
        out[bag] = [
            {"name": n, "term": t, "value": float(v)}
            for n, t, v in _triples(feats.get(bag, []))
        ]
    ids = rec.get("ids", {})
    for key in id_fields:
        out[key] = str(ids[key]) if key in ids else None
    return out


def _triples(entries):
    for e in entries:
        if isinstance(e, dict):
            yield e["name"], e.get("term", ""), e["value"]
        else:
            yield e


def iter_avro_dataset(
    path: str,
    feature_bags: Iterable[str] | None = None,
    id_fields: Iterable[str] | None = None,
) -> Iterator[dict]:
    """Iterate an Avro training file as ``io.dataset``-shaped records.

    Bags/id fields default to introspection of the writer schema: every
    ``array``-typed field is a feature bag, every (nullable) string field
    is an entity id.
    """
    schema, records = read_container(path)
    if feature_bags is None or id_fields is None:
        bags, ids = [], []
        for f in schema.root["fields"]:
            t = schema.resolve(f["type"])
            if isinstance(t, dict) and t.get("type") == "array":
                bags.append(f["name"])
            elif f["name"] not in ("label", "weight", "offset"):
                branches = t if isinstance(t, list) else [t]
                if "string" in branches:
                    ids.append(f["name"])
        feature_bags = bags if feature_bags is None else feature_bags
        id_fields = ids if id_fields is None else id_fields
    for rec in records:
        yield avro_to_dataset_record(rec, feature_bags, id_fields)


def write_avro_dataset(
    path: str,
    records: Iterable[dict],
    feature_bags: Iterable[str] = ("features",),
    id_fields: Iterable[str] = (),
    codec: str = "deflate",
) -> int:
    """Write ``io.dataset``-shaped records as ``TrainingExampleAvro``."""
    feature_bags = list(feature_bags)
    id_fields = list(id_fields)
    schema = training_example_schema(feature_bags, id_fields)
    return write_container(
        path,
        schema,
        (dataset_record_to_avro(r, feature_bags, id_fields)
         for r in records),
        codec=codec,
    )


# ---------------------------------------------------------------------------
# Model I/O (BayesianLinearModelAvro)
# ---------------------------------------------------------------------------


def write_model_avro(
    path: str,
    model_id: str,
    means: np.ndarray,
    index_to_key,
    variances: np.ndarray | None = None,
    loss_function: str = "",
    sparse: bool = True,
) -> None:
    """Save coefficients keyed by (name, term) — reference model format.

    ``index_to_key(i)`` → ``(name, term)`` for feature index i (the
    feature IndexMap's inverse).  ``sparse=True`` drops exact zeros, as
    the reference does for L1 models.
    """
    means = np.asarray(means)
    idx = np.nonzero(means)[0] if sparse else np.arange(means.size)

    def ntv(values):
        out = []
        for i in idx:
            name, term = index_to_key(int(i))
            out.append({
                "name": name, "term": term, "value": float(values[i])
            })
        return out

    rec = {
        "modelId": model_id,
        "modelClass": "",
        "lossFunction": loss_function,
        "means": ntv(means),
        "variances": None if variances is None else ntv(
            np.asarray(variances)),
    }
    write_container(path, bayesian_linear_model_schema(), [rec])


def read_model_avro(
    path: str,
    key_to_index,
    dim: int,
) -> tuple[str, np.ndarray, np.ndarray | None]:
    """Load a BayesianLinearModelAvro → (model_id, means[dim], variances).

    ``key_to_index(name, term)`` → feature index (or a negative sentinel
    for unknown keys, which are skipped — reference behavior when the
    index map evolved since the model was trained).
    """
    _, records = read_container(path)
    rec = next(iter(records))
    means = np.zeros(dim, np.float32)
    for e in rec["means"]:
        i = key_to_index(e["name"], e.get("term", ""))
        if i is not None and i >= 0:
            means[i] = e["value"]
    variances = None
    if rec.get("variances") is not None:
        variances = np.zeros(dim, np.float32)
        for e in rec["variances"]:
            i = key_to_index(e["name"], e.get("term", ""))
            if i is not None and i >= 0:
                variances[i] = e["value"]
    return rec["modelId"], means, variances

"""Structured training/scoring data: name-term-value records → GameDataset.

Counterpart of ``photon_ml_tpu/io/dataset.py`` (numpy, copied).  Records
carry label / weight / offset, per-shard lists of ``{name, term,
value}`` features and string random-effect ids, in Avro containers or
JSON lines of the same shape:

    {"label": 1.0, "weight": 1.0, "offset": 0.0,
     "features": {"global": [["age", "", 0.5], ["geo", "us", 1.0]]},
     "ids": {"userId": "u42"}}

Feature entries may be ``[name, term, value]`` triples or
``{"name":, "term":, "value":}`` objects.  All string→int resolution
happens here, once, on the host: device code only sees the arrays of
``GameDataset``.
"""

from __future__ import annotations

import json

import numpy as np

from photon_ml_torch.game.dataset import GameDataset
from photon_ml_torch.io.index_map import IndexMap, IndexMapBuilder, feature_key


def _iter_records(path: str):
    """Yield structured records from JSONL or Avro (by extension/magic):
    the two containers carry the same record shape, so everything
    downstream (index building, ETL) is format-blind."""
    if _is_avro(path):
        from photon_ml_torch.io.avro_schemas import iter_avro_dataset

        yield from iter_avro_dataset(path)
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def _is_avro(path: str) -> bool:
    if path.endswith(".avro"):
        return True
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"Obj\x01"
    except OSError:  # photon-lint: disable=swallowed-exception (unreadable file is simply not detected as Avro; the real read errors loudly)
        return False


def _feature_entries(entries):
    """Yield (name, term, value) from triples or Avro-style dicts."""
    for e in entries:
        if isinstance(e, dict):
            yield e["name"], e.get("term", ""), float(e["value"])
        else:
            name, term, value = e
            yield name, term, float(value)


def build_index_maps(
    path: str,
    feature_shards: list[str] | None = None,
    entity_keys: list[str] | None = None,
) -> tuple[dict, dict]:
    """Scan a JSONL dataset and build feature/entity index maps.

    The rebuild's ``FeatureIndexingDriver`` core (reference §3.4): one
    pass collecting distinct (name, term) per shard and distinct entity
    ids per key, frozen into deterministic sorted-order maps.
    """
    f_builders: dict = {}
    e_builders: dict = {}
    for rec in _iter_records(path):
        for shard, entries in rec.get("features", {}).items():
            if feature_shards is not None and shard not in feature_shards:
                continue
            b = f_builders.setdefault(shard, IndexMapBuilder())
            for name, term, _ in _feature_entries(entries):
                b.put_feature(name, term)
        for key, eid in rec.get("ids", {}).items():
            if entity_keys is not None and key not in entity_keys:
                continue
            e_builders.setdefault(key, IndexMapBuilder()).put(str(eid))
    return (
        {s: b.build() for s, b in f_builders.items()},
        {k: b.build() for k, b in e_builders.items()},
    )


def detect_format(path: str, declared: str = "auto") -> str:
    """Shared input-format resolution for the training/scoring drivers."""
    if declared != "auto":
        return declared
    if path.endswith((".jsonl", ".json", ".ndjson")):
        return "jsonl"
    if _is_avro(path):
        return "avro"
    return "libsvm"


def read_game_dataset(
    path: str,
    feature_maps: dict,
    entity_maps: dict | None = None,
    dense_shards: tuple[str, ...] | list[str] = (),
    skip_unindexed: bool = True,
    extend_entity_maps: bool = False,
) -> GameDataset:
    """Read JSONL records into a host-side ``GameDataset``.

    Args:
      feature_maps: shard → IndexMap; features absent from the map are
        dropped (``skip_unindexed=True``, the reference's behavior for
        out-of-vocabulary features at scoring time) or raise.
      entity_maps: entity key → IndexMap.  Entity ids absent from the
        map are handled per ``extend_entity_maps``:
        - True (training): the id is APPENDED to the map in place, so
          the map the driver persists stays the single source of truth
          for id → index resolution;
        - False (scoring): the id maps to the -1 sentinel, which the
          transformer scores as 0 (reference cold-start semantics).
          Fresh dense indices are never invented here — they could
          alias a trained entity's index (silently scoring with the
          wrong entity's coefficients).
      dense_shards: shards materialized as dense [n, d] float arrays
        (small per-entity shards); all others stay sparse row lists.
    """
    from photon_ml_torch.data.sparse_rows import SparseRows

    entity_maps = entity_maps or {}
    labels, weights, offsets = [], [], []
    # Flat per-shard accumulators (counts/cols/vals) — record parsing is
    # inherently a Python loop, but per-example numpy arrays are not:
    # the arrays are materialized ONCE per shard at the end.
    shard_acc: dict = {s: ([], [], []) for s in feature_maps}
    id_cols: dict = {k: [] for k in entity_maps}

    for rec in _iter_records(path):
        labels.append(float(rec.get("label", 0.0)))
        weights.append(float(rec.get("weight", 1.0)))
        offsets.append(float(rec.get("offset", 0.0)))
        feats = rec.get("features", {})
        for shard, imap in feature_maps.items():
            counts, idxs, vals = shard_acc[shard]
            cnt = 0
            for name, term, value in _feature_entries(feats.get(shard, [])):
                i = imap.get(feature_key(name, term))
                if i < 0:
                    if skip_unindexed:
                        continue
                    raise KeyError(
                        f"feature ({name!r}, {term!r}) not in shard "
                        f"{shard!r} index map"
                    )
                idxs.append(i)
                vals.append(value)
                cnt += 1
            counts.append(cnt)
        ids = rec.get("ids", {})
        for key, imap in entity_maps.items():
            eid = str(ids.get(key, ""))
            i = imap.get(eid)
            if i < 0 and extend_entity_maps:
                i = len(imap)
                imap.index[eid] = i
            id_cols[key].append(i)

    n = len(labels)
    features: dict = {}
    for shard, (counts, idxs, vals) in shard_acc.items():
        dim = len(feature_maps[shard])
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.asarray(counts, np.int64), out=indptr[1:])
        rows = SparseRows.from_flat(
            indptr, np.asarray(idxs, np.int64), np.asarray(vals, np.float64)
        )
        features[shard] = (rows.to_dense(dim) if shard in dense_shards
                          else rows)

    w = np.asarray(weights, np.float32)
    o = np.asarray(offsets, np.float32)
    return GameDataset(
        labels=np.asarray(labels, np.float32),
        features=features,
        entity_ids={k: np.asarray(v, np.int64) for k, v in id_cols.items()},
        weights=None if np.all(w == 1.0) else w,
        offsets=None if np.all(o == 0.0) else o,
        feature_dims={s: len(m) for s, m in feature_maps.items()},
    )


def write_game_dataset(
    path: str,
    labels: np.ndarray,
    features: dict,
    ids: dict | None = None,
    weights: np.ndarray | None = None,
    offsets: np.ndarray | None = None,
    feature_names: dict | None = None,
) -> None:
    """Write records back to JSONL (fixture generation, round-trips).

    ``features`` values are dense [n, d] arrays or sparse row lists;
    ``feature_names[shard]`` optionally gives index → name strings
    (defaults to ``f<i>``).
    """
    n = len(labels)
    with open(path, "w") as f:
        for r in range(n):
            rec: dict = {"label": float(labels[r])}
            if weights is not None:
                rec["weight"] = float(weights[r])
            if offsets is not None:
                rec["offset"] = float(offsets[r])
            rec["features"] = {}
            for shard, data in features.items():
                names = (feature_names or {}).get(shard)
                if isinstance(data, np.ndarray):
                    nz = np.nonzero(data[r])[0]
                    entries = [(names[i] if names else f"f{i}", "",
                                float(data[r, i])) for i in nz]
                else:
                    c, v = data[r]
                    entries = [(names[i] if names else f"f{i}", "",
                                float(val)) for i, val in zip(c, v)]
                rec["features"][shard] = entries
            if ids:
                rec["ids"] = {k: str(col[r]) for k, col in ids.items()}
            f.write(json.dumps(rec) + "\n")

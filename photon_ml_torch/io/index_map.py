"""Feature and entity index maps: string keys → dense integer indices.

Counterpart of ``photon_ml_tpu/io/index_map.py`` (stdlib, copied).
Photon-ML maps ``(name, term)`` feature keys to vector indices, one map
per feature shard, and tags examples with string entity ids.  Here a
map is a sorted-key JSON file per shard (deterministic, diffable); all
indexing happens once on the host, producing the integer arrays the
batches consume.
"""

from __future__ import annotations

import dataclasses
import json
import os

# The reference joins (name, term) with a NUL-ish delimiter; use one
# that cannot appear in Avro name/term strings we care about.
_DELIM = "\x1f"


def feature_key(name: str, term: str = "") -> str:
    return f"{name}{_DELIM}{term}" if term else name


@dataclasses.dataclass
class IndexMap:
    """Immutable key → index map (features of one shard, or entity ids)."""

    index: dict  # str key → int

    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, key: str) -> bool:
        return key in self.index

    def get(self, key: str, default: int = -1) -> int:
        return self.index.get(key, default)

    def get_feature(self, name: str, term: str = "", default: int = -1) -> int:
        return self.index.get(feature_key(name, term), default)

    def names(self) -> list[str]:
        """Keys in index order (index i → names()[i])."""
        out = [""] * len(self.index)
        for k, i in self.index.items():
            out[i] = k
        return out

    def feature_at(self, i: int) -> tuple[str, str]:
        """Inverse of ``get_feature``: index → (name, term)."""
        key = self.names()[i]
        name, sep, term = key.partition(_DELIM)
        return (name, term) if sep else (key, "")

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.index, f, indent=0, sort_keys=True)

    @staticmethod
    def load(path: str) -> "IndexMap":
        with open(path) as f:
            return IndexMap(index=json.load(f))


class IndexMapBuilder:
    """Accumulate keys across a data scan, then freeze to an IndexMap.

    Indices are assigned by sorted key order at build time (not first-seen
    order), so the map is deterministic regardless of record order — the
    property the reference gets from its partition-then-sort indexing
    driver (§3.4).
    """

    def __init__(self):
        self._keys: set[str] = set()

    def put(self, key: str) -> None:
        self._keys.add(key)

    def put_feature(self, name: str, term: str = "") -> None:
        self._keys.add(feature_key(name, term))

    def build(self) -> IndexMap:
        return IndexMap(index={k: i for i, k in enumerate(sorted(self._keys))})


# ---------------------------------------------------------------------------
# Directory layout: one JSON per feature shard + one per entity key,
# the rebuild's equivalent of "one PalDB store per (shard, partition)".
# ---------------------------------------------------------------------------

def save_index_maps(
    out_dir: str,
    feature_maps: dict,
    entity_maps: dict | None = None,
) -> None:
    os.makedirs(out_dir, exist_ok=True)
    meta = {
        "feature_shards": sorted(feature_maps),
        "entity_keys": sorted(entity_maps or {}),
    }
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    for shard, imap in feature_maps.items():
        imap.save(os.path.join(out_dir, f"features.{shard}.json"))
    for key, imap in (entity_maps or {}).items():
        imap.save(os.path.join(out_dir, f"entities.{key}.json"))


def load_index_maps(in_dir: str) -> tuple[dict, dict]:
    with open(os.path.join(in_dir, "metadata.json")) as f:
        meta = json.load(f)
    feature_maps = {
        shard: IndexMap.load(os.path.join(in_dir, f"features.{shard}.json"))
        for shard in meta["feature_shards"]
    }
    entity_maps = {
        key: IndexMap.load(os.path.join(in_dir, f"entities.{key}.json"))
        for key in meta["entity_keys"]
    }
    return feature_maps, entity_maps

"""GAME datasets: example arrays, entity grouping and the id joins.

Counterpart of ``photon_ml_tpu/game/dataset.py`` (host numpy, copied):

- ``GameDataset``: per-example labels, weights, offsets, feature shards
  (dense arrays or ``SparseRows``) and per-coordinate entity ids, all
  indexed by example position;
- ``group_by_entity``: the one-time ETL that groups examples by entity
  into size buckets (capacities ``min_capacity·bucket_base^j``, so a
  bucket wastes less than ``bucket_base``× its slots), giving every
  example a (bucket, entity slot, position) coordinate;
- ``scatter_to_blocks``/``gather_from_blocks`` between example space and
  the per-bucket [E_b, cap_b, ...] blocks; ``bucket_occupancy``;
- ``sorted_id_join``/``sorted_key_join``, the joins scoring needs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class EntityGrouping:
    """Host-side grouping of entities into per-bucket padded blocks.

    Per entity (global order = ascending unique ids): its id, example
    count, bucket and slot within the bucket.  Per bucket: capacity and
    entity count.  The per-example maps are training state; a grouping
    loaded from a saved model has them empty.
    """

    n_examples: int
    entity_ids: np.ndarray
    entity_counts: np.ndarray
    entity_bucket: np.ndarray
    entity_slot: np.ndarray
    capacities: list[int]
    n_entities: list[int]
    example_bucket: np.ndarray
    example_row: np.ndarray
    example_col: np.ndarray
    example_entity: np.ndarray | None = None

    @property
    def n_total_entities(self) -> int:
        return len(self.entity_ids)

    def entity_index(self) -> dict:
        """original entity id → (bucket, slot)."""
        return {
            int(e): (int(b), int(s))
            for e, b, s in zip(self.entity_ids, self.entity_bucket,
                               self.entity_slot)
        }

    def join_ids(self, query_ids: np.ndarray) -> np.ndarray:
        """id → global entity index (into ``entity_ids``), −1 for
        unseen.  ``entity_ids`` must be strictly ascending."""
        ids = np.asarray(self.entity_ids)
        if ids.size > 1 and not bool((np.diff(ids) > 0).all()):
            raise ValueError(
                "EntityGrouping.entity_ids must be strictly ascending "
                "and unique for join_ids (np.unique order)")
        return sorted_id_join(ids, query_ids)

    def entity_row_map(self) -> np.ndarray:
        """Dense (bucket, slot) → global entity index map
        [n_buckets, max entities a bucket], −1 for empty slots."""
        n_buckets = len(self.capacities)
        max_ne = max(self.n_entities) if self.n_entities else 1
        out = np.full((n_buckets, max(max_ne, 1)), -1, np.int64)
        out[self.entity_bucket, self.entity_slot] = np.arange(
            self.n_total_entities)
        return out


def sorted_key_join(keys: np.ndarray, vals: np.ndarray,
                    query_keys: np.ndarray, presorted: bool = False
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Value of each query key under the unique-keyed ``keys → vals``
    map: ``(values, hit)``, with ``hit[i]`` False (and the value
    meaningless) for absent keys.  ``presorted`` skips the argsort."""
    nq = len(query_keys)
    if len(keys) == 0:
        return (np.zeros(nq, vals.dtype if len(vals) else np.float64),
                np.zeros(nq, bool))
    if presorted:
        ks, vs = keys, vals
    else:
        order = np.argsort(keys)
        ks, vs = keys[order], vals[order]
    p = np.minimum(np.searchsorted(ks, query_keys), len(ks) - 1)
    return vs[p], ks[p] == query_keys


def sorted_id_join(sorted_ids: np.ndarray,
                   query_ids: np.ndarray) -> np.ndarray:
    """Each query id's position in ``sorted_ids`` (ascending, unique),
    −1 where absent."""
    if len(sorted_ids) == 0:
        return np.full(len(query_ids), -1, np.int64)
    ids = np.asarray(query_ids, sorted_ids.dtype)
    pos = np.searchsorted(sorted_ids, ids)
    pos_c = np.minimum(pos, len(sorted_ids) - 1)
    return np.where(sorted_ids[pos_c] == ids, pos_c, -1)


def group_by_entity(entity_ids: np.ndarray, bucket_base: int = 4,
                    min_capacity: int = 4) -> EntityGrouping:
    """Group example indices by entity into size buckets of capacity
    ``min_capacity·bucket_base^j``.  Deterministic: entities in ascending
    id order, examples in their original order within an entity."""
    entity_ids = np.asarray(entity_ids)
    n = len(entity_ids)
    uniq, inverse, counts = np.unique(entity_ids, return_inverse=True,
                                      return_counts=True)
    E = len(uniq)
    caps_needed = np.maximum(counts, 1)
    cap = min_capacity
    cap_list = [min_capacity]
    while cap < caps_needed.max(initial=1):
        cap *= bucket_base
        cap_list.append(cap)
    cap_arr = np.asarray(cap_list)
    bucket_of_entity = np.searchsorted(cap_arr, caps_needed, side="left")

    # Only non-empty buckets, re-indexed densely; all vectorized.
    used = np.unique(bucket_of_entity)
    bucket_of_entity = np.searchsorted(used, bucket_of_entity)
    capacities = [int(cap_arr[b]) for b in used]
    n_buckets = len(used)
    order_e = np.argsort(bucket_of_entity, kind="stable")
    sorted_b = bucket_of_entity[order_e]
    bucket_starts = np.searchsorted(sorted_b, np.arange(n_buckets))
    slot_of_entity = np.empty(E, np.int64)
    slot_of_entity[order_e] = (np.arange(E, dtype=np.int64)
                               - bucket_starts[sorted_b])
    n_entities = np.bincount(bucket_of_entity,
                             minlength=n_buckets).tolist()

    # Position within its entity: a stable sort keeps example order.
    order = np.argsort(inverse, kind="stable")
    entity_starts = np.zeros(E, np.int64)
    np.cumsum(counts[:-1], out=entity_starts[1:])
    col = np.empty(n, np.int64)
    col[order] = np.arange(n, dtype=np.int64) - entity_starts[inverse[order]]
    return EntityGrouping(
        n_examples=n, entity_ids=uniq, entity_counts=counts,
        entity_bucket=bucket_of_entity, entity_slot=slot_of_entity,
        capacities=capacities, n_entities=n_entities,
        example_bucket=bucket_of_entity[inverse],
        example_row=slot_of_entity[inverse], example_col=col,
        example_entity=inverse)


def bucket_occupancy(grouping: EntityGrouping) -> dict:
    """Per-bucket occupancy and padding waste of one grouping:
    ``{"entities", "examples", "total_slots", "padded_slots",
    "padded_slot_ratio", "buckets": [{"capacity", "entities",
    "examples", "fill_fraction"}, ...]}``."""
    counts = np.asarray(grouping.entity_counts, np.int64)
    bucket = np.asarray(grouping.entity_bucket)
    n_buckets = len(grouping.capacities)
    ex_per_bucket = np.bincount(bucket, weights=counts,
                                minlength=n_buckets).astype(np.int64)
    buckets = []
    total_slots = 0
    for b, (cap, ne) in enumerate(zip(grouping.capacities,
                                      grouping.n_entities)):
        slots = int(cap) * int(ne)
        total_slots += slots
        buckets.append({
            "capacity": int(cap), "entities": int(ne),
            "examples": int(ex_per_bucket[b]),
            "fill_fraction": (round(float(ex_per_bucket[b]) / slots, 4)
                              if slots else 0.0),
        })
    n = int(grouping.n_examples)
    return {
        "entities": int(grouping.n_total_entities), "examples": n,
        "total_slots": total_slots, "padded_slots": total_slots - n,
        "padded_slot_ratio": (round((total_slots - n) / total_slots, 4)
                              if total_slots else 0.0),
        "buckets": buckets,
    }


def scatter_to_blocks(grouping: EntityGrouping, values: np.ndarray,
                      fill: float = 0.0) -> list[np.ndarray]:
    """Per-example values [n, ...] → per-bucket blocks [E_b, cap_b, ...]."""
    out = []
    trailing = values.shape[1:]
    for b, (cap, ne) in enumerate(zip(grouping.capacities,
                                      grouping.n_entities)):
        blk = np.full((ne, cap) + trailing, fill, values.dtype)
        sel = grouping.example_bucket == b
        blk[grouping.example_row[sel], grouping.example_col[sel]] = values[sel]
        out.append(blk)
    return out


def gather_from_blocks(grouping: EntityGrouping,
                       blocks: list[np.ndarray]) -> np.ndarray:
    """Inverse of ``scatter_to_blocks`` (real example slots only)."""
    trailing = blocks[0].shape[2:]
    out = np.zeros((grouping.n_examples,) + trailing, blocks[0].dtype)
    for b, blk in enumerate(blocks):
        sel = grouping.example_bucket == b
        out[sel] = blk[grouping.example_row[sel], grouping.example_col[sel]]
    return out


@dataclasses.dataclass
class GameDataset:
    """Host-side GAME data, indexed by example position.

    ``features``: shard name → dense [n, d] float array or ``SparseRows``
    (a ``list[(col_ids, values)]`` is converted at construction);
    ``entity_ids``: random-effect entity key → [n] integer ids;
    ``feature_dims``: widths of sparse shards."""

    labels: np.ndarray
    features: dict
    entity_ids: dict
    weights: np.ndarray | None = None
    offsets: np.ndarray | None = None
    feature_dims: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        from photon_ml_torch.data.sparse_rows import SparseRows

        # A copy: the caller's dict is left as it was.
        self.features = dict(self.features)
        for s, f in self.features.items():
            if not isinstance(f, (np.ndarray, SparseRows)):
                self.features[s] = SparseRows.from_rows(f)

    @property
    def n(self) -> int:
        return len(self.labels)

    def feature_dim(self, shard: str) -> int:
        feats = self.features[shard]
        if isinstance(feats, np.ndarray):
            return feats.shape[1]
        if shard in self.feature_dims:
            return int(self.feature_dims[shard])
        return feats.max_col + 1

    def weight_array(self) -> np.ndarray:
        return (np.ones(self.n, np.float32) if self.weights is None
                else self.weights.astype(np.float32))

    def offset_array(self) -> np.ndarray:
        return (np.zeros(self.n, np.float32) if self.offsets is None
                else self.offsets.astype(np.float32))

    def take(self, idx) -> "GameDataset":
        """Row subset.  A slice, or an index array that is one ascending
        contiguous range (what every train/validation split gives),
        subsets by basic slicing, i.e. as views; other index arrays
        copy."""
        if not isinstance(idx, slice):
            idx = np.asarray(idx)
            if idx.dtype == bool:
                idx = np.flatnonzero(idx)
            idx = idx.astype(np.int64)
            if idx.size and idx[0] >= 0 and bool(
                    (np.diff(idx) == 1).all() if idx.size > 1 else True):
                idx = slice(int(idx[0]), int(idx[-1]) + 1)
        return GameDataset(
            labels=self.labels[idx],
            features={s: f[idx] for s, f in self.features.items()},
            entity_ids={k: v[idx] for k, v in self.entity_ids.items()},
            weights=None if self.weights is None else self.weights[idx],
            offsets=None if self.offsets is None else self.offsets[idx],
            feature_dims=dict(self.feature_dims))

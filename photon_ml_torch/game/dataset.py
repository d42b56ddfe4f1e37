"""Entity grouping and the id joins scoring needs.

Counterpart of the host-side part of ``photon_ml_tpu/game/dataset.py``:
``EntityGrouping`` (how a random effect's entities sit in size-bucketed
coefficient blocks), ``sorted_id_join`` and ``sorted_key_join``.  The
training-time ``GameDataset`` and the block scatter/gather come with the
training path.
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

"""Per-entity linear subspace projection of a sparse random-effect shard.

Counterpart of ``photon_ml_tpu/game/projector.py`` (host numpy, copied).
A random-effect shard may be wide while each entity sees a few of its
features; each entity's problem is solved in the subspace of the
features it observed.  The projection happens once, in the host ETL:
each entity's distinct global feature ids become its local columns
(``feature_ids`` [E_b, p_b] per bucket, −1 padding) and its examples are
densified into [cap_b, p_b] blocks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from photon_ml_torch.game.dataset import EntityGrouping


@dataclasses.dataclass
class SubspaceProjection:
    """``feature_ids[b]`` is [E_b, p_b]: the global feature id of each
    local column of each entity in bucket b (−1 padding)."""

    feature_ids: list[np.ndarray]
    global_dim: int


def build_subspace_projection(
    grouping: EntityGrouping,
    rows: list[tuple[np.ndarray, np.ndarray]],
    global_dim: int,
) -> tuple[SubspaceProjection, list[np.ndarray]]:
    """Build per-entity subspaces + projected dense feature blocks.

    Args:
      grouping: entity grouping of the n examples.
      rows: per-example sparse (col_ids, values) in the GLOBAL space.
      global_dim: width of the global space.

    Returns:
      (projection, x_blocks) where ``x_blocks[b]`` is a dense
      [E_b, cap_b, p_b] array of projected features.
    """
    from photon_ml_torch.data.sparse_rows import SparseRows

    rows = SparseRows.from_rows(rows)
    n_buckets = len(grouping.capacities)
    E = grouping.n_total_entities

    # Global entity index per example (stored by group_by_entity; rebuilt
    # from (bucket, slot) for a grouping without it).
    ex_entity = grouping.example_entity
    if ex_entity is None:
        ent_of = grouping.entity_row_map()
        ex_entity = ent_of[grouping.example_bucket, grouping.example_row]

    # Distinct (entity, global feature) pairs, sorted — each entity's
    # subspace is its run of distinct features; the run offset is the
    # feature's LOCAL column.  All vectorized.
    row_of = rows.row_of()
    ent_nnz = np.asarray(ex_entity)[row_of]
    order = np.lexsort((rows.cols, ent_nnz))
    e_s = ent_nnz[order]
    c_s = rows.cols[order].astype(np.int64)
    nnz = len(e_s)
    if nnz:
        new_g = np.empty(nnz, bool)
        new_g[0] = True
        np.logical_or(e_s[1:] != e_s[:-1], c_s[1:] != c_s[:-1],
                      out=new_g[1:])
        gid_s = np.cumsum(new_g) - 1
        starts = np.flatnonzero(new_g)
        ge = e_s[starts]                    # entity of each distinct feat
        gc = c_s[starts]                    # global col of each
    else:
        gid_s = np.zeros(0, np.int64)
        ge = np.zeros(0, np.int64)
        gc = np.zeros(0, np.int64)
    ent_feat_count = np.bincount(ge, minlength=E)
    ent_feat_start = np.zeros(E, np.int64)
    np.cumsum(ent_feat_count[:-1], out=ent_feat_start[1:])
    loc_of_group = np.arange(len(ge), dtype=np.int64) - ent_feat_start[ge]
    # Local column of every stored entry, in original nnz order.
    loc = np.empty(nnz, np.int64)
    loc[order] = loc_of_group[gid_s]

    feature_ids = []
    x_blocks = []
    ent_bucket = np.asarray(grouping.entity_bucket)
    ent_slot = np.asarray(grouping.entity_slot)
    for b in range(n_buckets):
        ne = grouping.n_entities[b]
        members = ent_bucket == b
        p = int(ent_feat_count[members].max()) if members.any() else 1
        p = max(p, 1)
        fids = np.full((ne, p), -1, np.int32)
        gsel = ent_bucket[ge] == b
        fids[ent_slot[ge[gsel]], loc_of_group[gsel]] = gc[gsel]
        feature_ids.append(fids)

        cap = grouping.capacities[b]
        xb = np.zeros((ne, cap, p), np.float32)
        nsel = ent_bucket[ent_nnz] == b
        ex = row_of[nsel]
        xb[grouping.example_row[ex], grouping.example_col[ex],
           loc[nsel]] = rows.vals[nsel]
        x_blocks.append(xb)

    return SubspaceProjection(feature_ids=feature_ids,
                              global_dim=global_dim), x_blocks

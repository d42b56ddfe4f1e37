"""Per-entity ("sharded") evaluators: a metric per entity, averaged.

Counterpart of ``photon_ml_tpu/evaluation/sharded.py`` (the reference's
``AreaUnderROCCurveMultiEvaluator`` and ``PrecisionAtKMultiEvaluator``).
Scores are grouped by entity with the GAME entity grouping
(``group_by_entity`` + padded [E_b, cap_b] blocks), and each bucket's
metric runs batched over its entity rows: one sort (AUC) or one
``topk`` (precision@k) along the last axis, no loop over entities.

Entities that cannot support the metric (one class only for AUC, no
examples for precision@k) are left out of the average, as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_torch.device import resolve_device
from photon_ml_torch.game.dataset import group_by_entity, scatter_to_blocks

Tensor = torch.Tensor


def _blocks(values: np.ndarray, grouping, dev) -> list[Tensor]:
    return [torch.from_numpy(b).to(dev)
            for b in scatter_to_blocks(grouping, values)]


def _row_auc(s: Tensor, y: Tensor, w: Tensor) -> Tensor:
    """Weighted, tie-aware AUC of every row of [E, cap] blocks (the
    evaluators' ``auc``, batched over the leading axis)."""
    e, cap = s.shape
    order = torch.argsort(s, dim=1, stable=True)
    s_sorted = torch.gather(s, 1, order)
    w_sorted = torch.gather(w, 1, order)
    wy_sorted = torch.gather(w * y, 1, order)
    new_group = torch.ones((e, cap), dtype=torch.int64, device=s.device)
    new_group[:, 1:] = (s_sorted[:, 1:] != s_sorted[:, :-1]).to(torch.int64)
    gid = torch.cumsum(new_group, 1) - 1
    cw = torch.cumsum(w_sorted, 1)
    group_total = torch.zeros_like(w_sorted).scatter_add(1, gid, w_sorted)
    group_end = torch.zeros_like(w_sorted).scatter_reduce(
        1, gid, cw, "amax", include_self=False)
    group_rank = group_end - 0.5 * group_total
    pos_rank_sum = (wy_sorted * torch.gather(group_rank, 1, gid)).sum(1)
    w_pos = (w * y).sum(1)
    w_neg = (w * (1.0 - y)).sum(1)
    denom = w_pos * w_neg
    return torch.where(denom > 0.0,
                       (pos_rank_sum - 0.5 * w_pos * w_pos) / denom,
                       torch.full_like(denom, 0.5))


def sharded_auc(
    scores: np.ndarray,
    labels: np.ndarray,
    entity_ids: np.ndarray,
    weights: np.ndarray | None = None,
    device=None,
) -> float:
    """Mean per-entity AUC over the entities with both classes present
    (on ``device``: default CUDA, ``"cpu"`` when asked)."""
    dev = resolve_device(device)
    grouping = group_by_entity(np.asarray(entity_ids))
    scores = np.asarray(scores, np.float32)
    labels = np.asarray(labels, np.float32)
    weights = (np.ones_like(scores) if weights is None
               else np.asarray(weights, np.float32))
    total, count = 0.0, 0
    for s, y, w, m in zip(_blocks(scores, grouping, dev),
                          _blocks(labels, grouping, dev),
                          _blocks(weights, grouping, dev),
                          _blocks(np.ones_like(scores), grouping, dev)):
        wm = w * m
        per_entity = _row_auc(s, y, wm)
        valid = (((y > 0.5) & (wm > 0)).any(1)
                 & ((y < 0.5) & (wm > 0)).any(1))
        total += float(per_entity[valid].double().sum())
        count += int(valid.sum())
    return total / count if count else 0.5


def sharded_precision_at_k(
    scores: np.ndarray,
    labels: np.ndarray,
    entity_ids: np.ndarray,
    k: int,
    device=None,
) -> float:
    """Mean per-entity precision@k: the share of positives among an
    entity's k highest-scored examples (all of them when it has fewer
    than k)."""
    dev = resolve_device(device)
    grouping = group_by_entity(np.asarray(entity_ids))
    scores = np.asarray(scores, np.float32)
    labels = np.asarray(labels, np.float32)
    total, count = 0.0, 0
    for s, y, m in zip(_blocks(scores, grouping, dev),
                       _blocks(labels, grouping, dev),
                       _blocks(np.ones_like(scores), grouping, dev)):
        kk = min(k, s.shape[1])
        masked = torch.where(m > 0, s, torch.full_like(s, -float("inf")))
        top = torch.topk(masked, kk, dim=1).indices
        picked = torch.gather(y, 1, top) * torch.gather(m, 1, top)
        denom = torch.clamp(m.sum(1), max=float(kk))
        vals = picked.sum(1) / torch.clamp(denom, min=1.0)
        nonempty = m.sum(1) > 0
        total += float(vals[nonempty].double().sum())
        count += int(nonempty.sum())
    return total / count if count else 0.0

"""Evaluators: AUC, RMSE and the mean losses.

Counterpart of ``photon_ml_tpu/evaluation/evaluators.py``.  Every metric
is a function of flat ``(scores, labels, weights, mask)`` tensors on one
device; AUC is one sort plus cumulative sums, tie-aware and weighted.
"""

from __future__ import annotations

import enum

import torch

Tensor = torch.Tensor


class EvaluatorType(str, enum.Enum):
    AUC = "AUC"
    RMSE = "RMSE"
    LOGISTIC_LOSS = "LOGISTIC_LOSS"
    POISSON_LOSS = "POISSON_LOSS"
    SQUARED_LOSS = "SQUARED_LOSS"


def _masked_weights(scores: Tensor, weights: Tensor | None,
                    mask: Tensor | None) -> Tensor:
    w = torch.ones_like(scores) if weights is None else weights
    return w if mask is None else w * mask


def auc(scores: Tensor, labels: Tensor, weights: Tensor | None = None,
        mask: Tensor | None = None) -> Tensor:
    """Weighted, tie-aware area under the ROC curve:
    P(score⁺ > score⁻) + ½·P(score⁺ = score⁻) over weighted pairs, from
    each example's tie-averaged weighted rank.  Masked examples weigh 0."""
    n = scores.shape[0]
    w = _masked_weights(scores, weights, mask)
    y = labels
    order = torch.argsort(scores, stable=True)
    s_sorted = scores[order]
    w_sorted = w[order]
    wy_sorted = (w * y)[order]
    new_group = torch.ones(n, dtype=torch.int64, device=scores.device)
    new_group[1:] = (s_sorted[1:] != s_sorted[:-1]).to(torch.int64)
    gid = torch.cumsum(new_group, 0) - 1
    cw = torch.cumsum(w_sorted, 0)
    group_total = torch.zeros(n, dtype=w.dtype, device=w.device).index_add(
        0, gid, w_sorted)
    group_end = torch.zeros(n, dtype=w.dtype, device=w.device).scatter_reduce(
        0, gid, cw, "amax", include_self=False)
    group_rank = group_end - 0.5 * group_total
    pos_rank_sum = (wy_sorted * group_rank[gid]).sum()
    w_pos = (w * y).sum()
    w_neg = (w * (1.0 - y)).sum()
    numer = pos_rank_sum - 0.5 * w_pos * w_pos
    denom = w_pos * w_neg
    return torch.where(denom > 0.0, numer / denom,
                       torch.full_like(denom, 0.5))


def _mean(w: Tensor, x: Tensor) -> Tensor:
    return (w * x).sum() / w.sum().clamp(min=1e-30)


def rmse(scores: Tensor, labels: Tensor, weights: Tensor | None = None,
         mask: Tensor | None = None) -> Tensor:
    w = _masked_weights(scores, weights, mask)
    return _mean(w, (scores - labels) ** 2).sqrt()


def logistic_loss(scores: Tensor, labels: Tensor,
                  weights: Tensor | None = None,
                  mask: Tensor | None = None) -> Tensor:
    """Mean weighted logistic loss of raw margins."""
    w = _masked_weights(scores, weights, mask)
    z, y = scores, labels
    return _mean(w, z.clamp(min=0.0) + torch.log1p(torch.exp(-z.abs()))
                 - y * z)


def poisson_loss(scores: Tensor, labels: Tensor,
                 weights: Tensor | None = None,
                 mask: Tensor | None = None) -> Tensor:
    w = _masked_weights(scores, weights, mask)
    return _mean(w, torch.exp(scores.clamp(max=30.0)) - labels * scores)


def squared_loss(scores: Tensor, labels: Tensor,
                 weights: Tensor | None = None,
                 mask: Tensor | None = None) -> Tensor:
    w = _masked_weights(scores, weights, mask)
    return _mean(w, 0.5 * (scores - labels) ** 2)


_EVALUATOR_FNS = {
    EvaluatorType.AUC: auc,
    EvaluatorType.RMSE: rmse,
    EvaluatorType.LOGISTIC_LOSS: logistic_loss,
    EvaluatorType.POISSON_LOSS: poisson_loss,
    EvaluatorType.SQUARED_LOSS: squared_loss,
}


def evaluate(evaluator: EvaluatorType, scores: Tensor, labels: Tensor,
             weights: Tensor | None = None,
             mask: Tensor | None = None) -> Tensor:
    """Dispatch an ``EvaluatorType``: raw margins for AUC and the
    losses, mean-space predictions for RMSE and squared loss."""
    return _EVALUATOR_FNS[evaluator](scores, labels, weights, mask)

"""Evaluators: AUC, RMSE and loss metrics, their streaming forms and
the per-entity (sharded) variants (counterpart of
``photon_ml_tpu/evaluation``)."""

from photon_ml_torch.evaluation.sharded import (
    sharded_auc,
    sharded_precision_at_k,
)
from photon_ml_torch.evaluation.evaluators import (
    EvaluatorType,
    auc,
    better_than,
    evaluate,
    logistic_loss,
    poisson_loss,
    rmse,
    squared_loss,
)
from photon_ml_torch.evaluation.streaming import (
    StreamingAUC,
    StreamingMeanLoss,
    StreamingRMSE,
    make_streaming_evaluator,
)

__all__ = [
    "EvaluatorType",
    "StreamingAUC",
    "StreamingMeanLoss",
    "StreamingRMSE",
    "auc",
    "better_than",
    "evaluate",
    "logistic_loss",
    "make_streaming_evaluator",
    "poisson_loss",
    "rmse",
    "squared_loss",
    "sharded_auc",
    "sharded_precision_at_k",
]

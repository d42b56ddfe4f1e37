"""The estimator and transformer API (counterpart of
``photon_ml_tpu/estimators``)."""

from photon_ml_torch.estimators.game_estimator import FitResult, GameEstimator
from photon_ml_torch.estimators.game_transformer import GameTransformer
from photon_ml_torch.estimators.streaming_scorer import StreamingGameScorer

__all__ = ["FitResult", "GameEstimator", "GameTransformer",
           "StreamingGameScorer"]

"""Streaming (chunk-accumulated) evaluators for the scoring pipeline.

Counterpart of ``photon_ml_tpu/evaluation/streaming.py``: host float64
folds over numpy chunks, so the streamed scorer never keeps an
``[n]``-sized score array to evaluate it.

- **Mean losses / RMSE** (logistic, Poisson, squared, RMSE): exact;
  ``Σ w·f(score, y)`` and ``Σ w`` accumulate in float64 across chunks
  (the one-shot evaluators reduce in float32, so the two agree to float
  tolerance).
- **AUC**: ``StreamingAUC`` buffers the raw chunks while the row count
  is at most ``exact_below`` and then answers with the one-shot
  evaluator (``evaluation.evaluators.auc``) over the buffer, exactly.
  Past the threshold it folds the buffer into two fixed-bin weighted
  histograms of ``sigmoid(score)`` (a monotone squash, so ranks are
  kept up to binning) and accumulates into them from then on.  Pairs in
  one bin get the tie credit ½, so the error is at most half the
  same-bin cross-class pair mass: about 1e-3 at the default 8,192 bins,
  exact when scores fall in distinct bins.
"""

from __future__ import annotations

import numpy as np

from photon_ml_torch.evaluation.evaluators import EvaluatorType

# Histogram resolution and exactness threshold defaults (StreamingAUC).
AUC_BINS = 8192
AUC_EXACT_BELOW = 1_000_000


def _as64(a) -> np.ndarray:
    return np.asarray(a, np.float64)


class StreamingMeanLoss:
    """Σ w·loss(score, y) / Σ w accumulated in float64 over chunks.

    ``kind``: "logistic" | "poisson" | "squared", the one-shot
    evaluators' formulas over raw margins."""

    def __init__(self, kind: str):
        self.kind = kind
        self._num = 0.0
        self._den = 0.0

    def update(self, scores, labels, weights) -> None:
        z, y, w = _as64(scores), _as64(labels), _as64(weights)
        if self.kind == "logistic":
            ll = np.maximum(z, 0.0) + np.log1p(np.exp(-np.abs(z))) - y * z
        elif self.kind == "poisson":
            ll = np.exp(np.minimum(z, 30.0)) - y * z
        elif self.kind == "squared":
            ll = 0.5 * (z - y) ** 2
        else:
            raise ValueError(f"unknown loss kind {self.kind!r}")
        self._num += float(np.sum(w * ll))
        self._den += float(np.sum(w))

    def result(self) -> float:
        return self._num / max(self._den, 1e-30)


class StreamingRMSE:
    """sqrt(Σ w·(score−y)² / Σ w) over chunks (float64)."""

    def __init__(self):
        self._num = 0.0
        self._den = 0.0

    def update(self, scores, labels, weights) -> None:
        s, y, w = _as64(scores), _as64(labels), _as64(weights)
        self._num += float(np.sum(w * (s - y) ** 2))
        self._den += float(np.sum(w))

    def result(self) -> float:
        return float(np.sqrt(self._num / max(self._den, 1e-30)))


class StreamingAUC:
    """Weighted AUC over chunks: exact up to ``exact_below`` rows, a
    fixed-bin histogram (tie-aware, of squashed scores) past them.

    Its state is either the buffered chunks or two ``[n_bins]`` float64
    weight histograms, never both past the threshold: memory is
    O(min(n, exact_below) + n_bins)."""

    def __init__(self, n_bins: int = AUC_BINS,
                 exact_below: int = AUC_EXACT_BELOW):
        self.n_bins = int(n_bins)
        self.exact_below = int(exact_below)
        self._rows = 0
        self._buf: list | None = []          # exact regime
        self._w_pos: np.ndarray | None = None
        self._w_neg: np.ndarray | None = None
        self.exact = True

    def _bin(self, scores: np.ndarray) -> np.ndarray:
        # Any strictly increasing map keeps the AUC; the sigmoid bounds
        # the bins' domain without a min/max pass over the stream.
        p = 1.0 / (1.0 + np.exp(-_as64(scores)))
        return np.minimum((p * self.n_bins).astype(np.int64),
                          self.n_bins - 1)

    def _to_histogram(self) -> None:
        self._w_pos = np.zeros(self.n_bins, np.float64)
        self._w_neg = np.zeros(self.n_bins, np.float64)
        self.exact = False
        buf, self._buf = self._buf, None
        for s, y, w in buf:
            self._accumulate(s, y, w)

    def _accumulate(self, scores, labels, weights) -> None:
        b = self._bin(scores)
        y, w = _as64(labels), _as64(weights)
        self._w_pos += np.bincount(b, weights=w * y,
                                   minlength=self.n_bins)
        self._w_neg += np.bincount(b, weights=w * (1.0 - y),
                                   minlength=self.n_bins)

    def update(self, scores, labels, weights) -> None:
        scores = np.asarray(scores, np.float32)
        labels = np.asarray(labels, np.float32)
        weights = np.asarray(weights, np.float32)
        self._rows += len(scores)
        if self._buf is not None and self._rows <= self.exact_below:
            self._buf.append((scores.copy(), labels.copy(),
                              weights.copy()))
            return
        if self._buf is not None:
            self._buf.append((scores, labels, weights))
            self._to_histogram()
        else:
            self._accumulate(scores, labels, weights)

    def result(self) -> float:
        if self._buf is not None:
            # Exact regime: the one-shot evaluator over the buffer.
            import torch

            from photon_ml_torch.evaluation.evaluators import auc

            if not self._buf:
                return 0.5
            s, y, w = (torch.from_numpy(np.concatenate([b[j]
                                                        for b in self._buf]))
                       for j in range(3))
            return float(auc(s, y, w))
        w_pos, w_neg = self._w_pos, self._w_neg
        total_pos = float(w_pos.sum())
        total_neg = float(w_neg.sum())
        if total_pos <= 0.0 or total_neg <= 0.0:
            return 0.5
        # Per bin: each positive outranks the negative mass below the bin
        # and ties (½ credit) the negative mass within it.
        neg_below = np.concatenate(([0.0], np.cumsum(w_neg)[:-1]))
        num = float(np.sum(w_pos * (neg_below + 0.5 * w_neg)))
        return num / (total_pos * total_neg)


class _EvaluatorAdapter:
    """One ``EvaluatorType`` bound to its streaming metric and its score
    convention (margins or mean-space predictions, as the one-shot
    driver path chooses per evaluator)."""

    def __init__(self, ev: EvaluatorType, metric, use_predictions: bool):
        self.type = ev
        self.metric = metric
        self.use_predictions = use_predictions

    def update(self, margins, predictions, labels, weights) -> None:
        scores = predictions if self.use_predictions else margins
        self.metric.update(scores, labels, weights)

    def result(self) -> float:
        return float(self.metric.result())


def make_streaming_evaluator(
    ev: EvaluatorType,
    auc_bins: int = AUC_BINS,
    auc_exact_below: int = AUC_EXACT_BELOW,
) -> _EvaluatorAdapter:
    """Streaming counterpart of ``evaluation.evaluators.evaluate``."""
    if ev == EvaluatorType.AUC:
        return _EvaluatorAdapter(
            ev, StreamingAUC(auc_bins, auc_exact_below), False)
    if ev == EvaluatorType.RMSE:
        return _EvaluatorAdapter(ev, StreamingRMSE(), True)
    if ev == EvaluatorType.LOGISTIC_LOSS:
        return _EvaluatorAdapter(ev, StreamingMeanLoss("logistic"), False)
    if ev == EvaluatorType.POISSON_LOSS:
        return _EvaluatorAdapter(ev, StreamingMeanLoss("poisson"), False)
    if ev == EvaluatorType.SQUARED_LOSS:
        return _EvaluatorAdapter(ev, StreamingMeanLoss("squared"), True)
    raise ValueError(f"no streaming evaluator for {ev!r}")

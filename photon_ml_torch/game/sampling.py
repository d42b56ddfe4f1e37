"""Down-sampling for fixed-effect training data.

Counterpart of ``photon_ml_tpu/game/sampling.py`` (host numpy, copied).
Semantics (Photon-ML's ``DownSampler`` family):

- ``BinaryClassificationDownSampler``: keep ALL positives, keep each
  negative with probability ``rate``, multiply kept negatives' weights
  by ``1/rate`` so the objective stays unbiased.
- ``DefaultDownSampler`` (non-binary tasks): keep each example with
  probability ``rate``, reweight by ``1/rate``.

Host-side (numpy): down-sampling decides WHICH examples form the
fixed-effect batch, so it runs once in the ETL before device upload —
the reference likewise samples RDDs before optimization, not inside it.
"""

from __future__ import annotations

import numpy as np


def binary_classification_down_sample(
    labels: np.ndarray,
    weights: np.ndarray,
    rate: float,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Keep-indices + adjusted weights for negative down-sampling.

    Returns (indices, new_weights_for_those_indices).
    """
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"down-sampling rate must be in (0, 1], got {rate}")
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    weights = np.asarray(weights, np.float64)
    is_pos = labels > 0.5
    keep = is_pos | (rng.uniform(size=len(labels)) < rate)
    idx = np.where(keep)[0]
    new_w = weights[idx].copy()
    new_w[~is_pos[idx]] /= rate
    return idx, new_w.astype(np.float32)


def default_down_sample(
    n: int,
    weights: np.ndarray,
    rate: float,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Uniform down-sampling with 1/rate reweighting."""
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"down-sampling rate must be in (0, 1], got {rate}")
    rng = np.random.default_rng(seed)
    keep = rng.uniform(size=n) < rate
    idx = np.where(keep)[0]
    new_w = (np.asarray(weights, np.float64)[idx] / rate).astype(np.float32)
    return idx, new_w

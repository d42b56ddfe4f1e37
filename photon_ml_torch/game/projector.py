"""Per-entity subspace projection of a random effect.

Counterpart of the ``SubspaceProjection`` container of
``photon_ml_tpu/game/projector.py``, so that projected models load.
Building projections and scoring projected effects come later.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SubspaceProjection:
    """``feature_ids[b]`` is [E_b, p_b]: the global feature id of each
    local column of each entity in bucket b (−1 padding)."""

    feature_ids: list[np.ndarray]
    global_dim: int

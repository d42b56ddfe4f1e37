"""GAME model containers: fixed-effect + random-effect + composite.

Counterpart of ``photon_ml_tpu/models/game.py``.  Coefficients are torch
tensors held on the host: the serving engine places the fixed effects on
its device itself, and random-effect rows reach the device only as
per-batch mini-tables (``serving.engine``).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from photon_ml_torch.models.coefficients import Coefficients

if TYPE_CHECKING:
    from photon_ml_torch.game.dataset import EntityGrouping
    from photon_ml_torch.game.projector import SubspaceProjection


@dataclasses.dataclass
class FixedEffectModel:
    """Global coefficients for one feature shard.  ``intercept``: the
    last coefficient is an intercept (scorers add it as a constant)."""

    coefficients: Coefficients
    feature_shard: str = "global"
    intercept: bool = False


@dataclasses.dataclass
class RandomEffectModel:
    """Per-entity coefficients, stored as size-bucketed blocks.

    ``coefficient_blocks[b]`` is [E_b, p_b] for bucket b of the
    grouping; ``grouping`` maps original entity ids to (bucket, slot).
    Entities never seen in training score zero.
    """

    coefficient_blocks: list[torch.Tensor]
    grouping: "EntityGrouping"
    feature_shard: str
    variance_blocks: list[torch.Tensor] | None = None
    projection: "SubspaceProjection | None" = None
    # Which request id tags examples for this model; None → the
    # coordinate name.
    entity_key: str | None = None

    @property
    def n_entities(self) -> int:
        return self.grouping.n_total_entities

    def all_coefficients(self) -> torch.Tensor:
        """[E_total, p] in global entity order (ascending ids), the
        gatherable form scoring uses; unprojected models only (every
        bucket has one width)."""
        if self.projection is not None:
            raise ValueError("all_coefficients is width-uniform; use "
                             "global_coefficients_for on projected models")
        first = self.coefficient_blocks[0]
        out = torch.zeros((self.n_entities, first.shape[-1]),
                          dtype=first.dtype, device=first.device)
        for b, blk in enumerate(self.coefficient_blocks):
            idx = np.flatnonzero(self.grouping.entity_bucket == b)
            out[torch.from_numpy(idx).to(out.device)] = blk[: len(idx)]
        return out

    def coefficients_for(self, entity_id) -> np.ndarray | None:
        """Per-entity coefficients in the entity's LOCAL space."""
        idx = self.grouping.entity_index().get(int(entity_id))
        if idx is None:
            return None
        b, s = idx
        return np.asarray(self.coefficient_blocks[b][s])

    def global_coefficients_for(self, entity_id) -> np.ndarray | None:
        """Per-entity coefficients scattered into the global feature
        space (identity when unprojected)."""
        local = self.coefficients_for(entity_id)
        if local is None or self.projection is None:
            return local
        b, s = self.grouping.entity_index()[int(entity_id)]
        fids = self.projection.feature_ids[b][s]
        out = np.zeros(self.projection.global_dim, local.dtype)
        valid = fids >= 0
        out[fids[valid]] = local[valid]
        return out


@dataclasses.dataclass
class GameModel:
    """Ordered coordinate name → component model."""

    models: dict

    def __getitem__(self, name: str):
        return self.models[name]

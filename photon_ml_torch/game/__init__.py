"""GAME: generalized additive mixed effects — datasets, coordinates and
coordinate descent (counterpart of ``photon_ml_tpu/game``)."""

from photon_ml_torch.game.coordinate_descent import (
    CoordinateDescentResult,
    run_coordinate_descent,
)
from photon_ml_torch.game.coordinates import (
    Coordinate,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
    StreamedRandomEffectCoordinate,
    build_random_effect_coordinate,
    build_random_effect_coordinate_sparse,
    build_streamed_random_effect_coordinate,
)
from photon_ml_torch.game.projector import (
    SubspaceProjection,
    build_subspace_projection,
)
from photon_ml_torch.game.sampling import (
    binary_classification_down_sample,
    default_down_sample,
)
from photon_ml_torch.game.dataset import (
    EntityGrouping,
    GameDataset,
    gather_from_blocks,
    group_by_entity,
    scatter_to_blocks,
)

__all__ = [
    "CoordinateDescentResult",
    "run_coordinate_descent",
    "Coordinate",
    "FixedEffectCoordinate",
    "RandomEffectCoordinate",
    "StreamedRandomEffectCoordinate",
    "build_random_effect_coordinate",
    "build_random_effect_coordinate_sparse",
    "build_streamed_random_effect_coordinate",
    "SubspaceProjection",
    "build_subspace_projection",
    "binary_classification_down_sample",
    "default_down_sample",
    "EntityGrouping",
    "GameDataset",
    "gather_from_blocks",
    "group_by_entity",
    "scatter_to_blocks",
]

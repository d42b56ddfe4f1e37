"""GAME: generalized additive mixed effects — datasets, coordinates and
coordinate descent (counterpart of ``photon_ml_tpu/game``)."""

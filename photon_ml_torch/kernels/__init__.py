"""Build/load machinery of the hand-written CUDA kernels (``_build``);
the sources live in ``photon_ml_torch/csrc/``."""

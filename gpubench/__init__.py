"""The benchmark of ``photon_ml_torch`` on an NVIDIA H100 (see README.md)."""

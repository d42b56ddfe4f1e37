"""Persistent artifact cache: the on-disk GRR plan cache (counterpart
of ``photon_ml_tpu/cache``).  The reference's XLA compilation cache has
no counterpart: the port's CUDA kernels are cached under
``build/kernels/`` by source hash."""

from photon_ml_torch.cache.plan_cache import (
    atomic_savez,
    dataset_fingerprint,
    load_plan,
    plan_cache_path,
    plan_config_key,
    save_plan,
)

__all__ = [
    "atomic_savez",
    "dataset_fingerprint",
    "load_plan",
    "plan_cache_path",
    "plan_config_key",
    "save_plan",
]

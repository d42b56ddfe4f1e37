"""Persistent artifact cache (counterpart of ``photon_ml_tpu/cache``):
the on-disk GRR plan cache (``plan_cache``) and the kernel build cache
(``compile_cache``), the counterpart of XLA's compilation cache: the
CUDA kernel libraries, named by source hash, build into and load from
``<cache_dir>/kernels``.

Layout on disk (one directory, safe to delete wholesale)::

    <cache_dir>/
      plans/grr-<fp16>-<cfg12>-v<F>.<P>.npz   # serialized plans
      kernels/<name>-<hash16>.so               # built CUDA kernels
"""

from photon_ml_torch.cache.compile_cache import enable_compilation_cache
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
    "enable_compilation_cache",
    "load_plan",
    "plan_cache_path",
    "plan_config_key",
    "save_plan",
]

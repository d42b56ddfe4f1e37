"""Persistent kernel build cache wiring.

Counterpart of ``photon_ml_tpu/cache/compile_cache.py``.  The port's
compiled artifacts are its CUDA kernel libraries (``kernels._build``:
one ``nvcc`` build a source, named by a hash of the source and flags),
so the counterpart of XLA's persistent compilation cache is the
directory those libraries are built into and loaded from.  By default
that is ``build/kernels/`` beside the package; a run that names a cache
directory builds into, and reuses, ``<cache_dir>/kernels`` instead --
which also lets an install whose package directory is read-only build
its kernels.

``enable_compilation_cache`` is the single switch the drivers, the
estimator and the server call.  It is idempotent, resolves its default
from ``PHOTON_ML_TPU_COMPILE_CACHE``, and keeps the default directory
when the cache directory cannot be made -- a cache must never be able
to make a run fail.  A library already loaded in the process stays
loaded: the setting places the builds and loads that come after it.
"""

from __future__ import annotations

import logging
import os

from photon_ml_torch.config import read_env
from photon_ml_torch.kernels import _build

logger = logging.getLogger(__name__)

ENV_VAR = "PHOTON_ML_TPU_COMPILE_CACHE"

_enabled_dir: str | None = None


def enable_compilation_cache(cache_dir: str | None = None) -> str | None:
    """Point the kernels' build directory at ``<cache_dir>/kernels``.

    ``cache_dir`` None falls back to ``$PHOTON_ML_TPU_COMPILE_CACHE``;
    if that is unset too, this is a no-op (returns None).  Where the
    directory cannot be made or written, a warning is logged, the
    default directory stays, and None is returned.  Returns the
    directory in effect."""
    global _enabled_dir
    cache_dir = cache_dir or read_env(ENV_VAR)
    if not cache_dir:
        return None
    kernels_dir = os.path.join(os.path.abspath(cache_dir), "kernels")
    if _enabled_dir == kernels_dir:
        return kernels_dir
    try:
        os.makedirs(kernels_dir, exist_ok=True)
        if not os.access(kernels_dir, os.W_OK | os.X_OK):
            raise PermissionError(f"{kernels_dir} is not writable")
    except OSError as e:
        logger.warning(
            "kernel build cache unavailable (%r); kernels build into %s",
            e, _build.build_dir())
        return None
    _build.set_build_dir(kernels_dir)
    _enabled_dir = kernels_dir
    logger.info("kernel build cache at %s", kernels_dir)
    return kernels_dir

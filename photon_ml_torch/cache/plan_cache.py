"""The atomic ``.npz`` write shared by model manifests and chunk stores.

Counterpart of ``atomic_savez`` in ``photon_ml_tpu/cache/plan_cache.py``
(same file format: the arrays plus a JSON ``__meta__`` member).  The GRR
plan cache itself comes with the training path.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def atomic_savez(path: str, meta, arrays: dict) -> None:
    """Write one uncompressed ``.npz`` holding ``arrays`` plus a JSON
    ``__meta__`` member, atomically (tmp sibling + ``os.replace``):
    readers never see a partial file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(meta).encode(), np.uint8), **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise

"""State-tree codec shared with ``photon_ml_tpu/reliability/checkpoint.py``.

``flatten_tree`` turns a nested tree of dicts, lists, scalars and arrays
into a JSON-able manifest plus a flat ``{key: ndarray}`` dict, ready for
``cache.plan_cache.atomic_savez``; ``unflatten_tree`` inverts it.  The
encoding is the JAX package's, byte for byte, so a model manifest
written by either package loads in the other.  The run checkpointer
itself comes with the training path.
"""

from __future__ import annotations

import numpy as np
import torch


def _host_array(node) -> np.ndarray:
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().numpy()
    return np.asarray(node)


def flatten_tree(tree) -> tuple[dict, dict]:
    """Encode a nested state tree (dict[str]/list/tuple/None/bool/int/
    float/str leaves + numpy/torch array leaves) as (manifest, arrays)."""
    arrays: dict = {}

    def enc(node):
        if node is None:
            return {"k": "none"}
        if isinstance(node, bool):
            return {"k": "b", "v": bool(node)}
        if isinstance(node, int) and not isinstance(node, np.generic):
            return {"k": "i", "v": int(node)}
        if isinstance(node, float) and not isinstance(node, np.generic):
            return {"k": "f", "v": float(node)}
        if isinstance(node, str):
            return {"k": "s", "v": node}
        if isinstance(node, dict):
            for key in node:
                if not isinstance(key, str):
                    raise TypeError(
                        f"checkpoint tree keys must be str, got {key!r}")
            return {"k": "d", "v": {key: enc(v)
                                    for key, v in node.items()}}
        if isinstance(node, (list, tuple)):
            return {"k": "l", "v": [enc(v) for v in node]}
        key = f"a{len(arrays)}"
        arrays[key] = _host_array(node)
        return {"k": "a", "ref": key}

    return enc(tree), arrays


def unflatten_tree(meta: dict, arrays) -> object:
    """Inverse of ``flatten_tree``; array leaves come back as numpy."""
    k = meta["k"]
    if k == "none":
        return None
    if k in ("b", "i", "f", "s"):
        return meta["v"]
    if k == "d":
        return {key: unflatten_tree(v, arrays)
                for key, v in meta["v"].items()}
    if k == "l":
        return [unflatten_tree(v, arrays) for v in meta["v"]]
    if k == "a":
        return np.asarray(arrays[meta["ref"]])
    raise ValueError(f"unknown checkpoint tree node kind {k!r}")

"""The on-disk GRR plan cache and the atomic ``.npz`` write it shares.

Counterpart of ``photon_ml_tpu/cache/plan_cache.py``, in the same file
format and with the same keys, so a plan written by either package loads
in the other (the sharded builder's list-of-plans files too).
``data.grr.build_grr_pair`` resolves ``cache_dir=None`` through
``$PHOTON_ML_TPU_PLAN_CACHE``.  A compiled plan (``GrrPair`` /
``GrrDirection`` / ``GrrRangeSplit``) is a pure function of the ELL arrays, the table width
and the plan-affecting build options; its cache key is a content
fingerprint of (cols, vals, dim) × a config key × the planner version.

Format: one uncompressed ``.npz`` per plan, every array leaf under a
tree-path key, plus a JSON ``__meta__`` manifest of the node structure
and static fields.  Writes go through ``atomic_savez`` (tmp sibling +
``os.replace``); any load failure returns None and the caller rebuilds.
Model manifests and chunk stores use ``atomic_savez`` too.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile

import numpy as np

logger = logging.getLogger(__name__)

# Serialization-format version: bump when the on-disk layout changes.
FORMAT_VERSION = 1

_DIR_ARRAYS = ("g1", "g2", "g3", "vals", "gw_of_st", "ow_of_st",
               "first_of_ow", "spill_idx", "spill_seg", "spill_val")
_DIR_STATIC = ("table_len", "n_segments", "cap", "n_gw", "n_ow",
               "dense_grid")


# -- keys ---------------------------------------------------------------------


def dataset_fingerprint(cols, vals, dim: int, extra: tuple = ()) -> str:
    """Content hash of the exact plan inputs (shapes and dtypes folded
    in, so a reshape or retype cannot collide)."""
    h = hashlib.blake2b(digest_size=16)
    for a in (cols, vals) + tuple(extra):
        a = np.ascontiguousarray(a)
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    h.update(str(int(dim)).encode())
    return h.hexdigest()


def plan_config_key(**options) -> str:
    """Hash of the plan-affecting build options (None-valued options
    included: the auto heuristics are part of plan semantics)."""
    blob = json.dumps({k: options[k] for k in sorted(options)},
                      sort_keys=True, default=str)
    return hashlib.blake2b(blob.encode(), digest_size=6).hexdigest()


def plan_cache_path(cache_dir: str, fingerprint: str,
                    config_key: str) -> str:
    """File path for a (dataset, config) plan under ``cache_dir``; the
    planner version rides in the name, so a bump is a clean miss."""
    from photon_ml_torch.data.grr import PLANNER_VERSION

    return os.path.join(
        cache_dir, "plans",
        f"grr-{fingerprint}-{config_key}"
        f"-v{FORMAT_VERSION}.{PLANNER_VERSION}.npz")


# -- encode / decode ----------------------------------------------------------


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _encode_node(node, prefix: str, arrays: dict, raw: bool = False):
    """Plan node → manifest fragment; array leaves land in ``arrays``
    under tree-path keys, as host numpy (``raw``: as the node holds
    them, e.g. a spilled chunk's memory-mapped members)."""
    from photon_ml_torch.data.grr import GrrDirection, GrrPair, GrrRangeSplit

    def leaf(a):
        return a if raw else _host(a)

    if node is None:
        return None
    if isinstance(node, GrrDirection):
        for f in _DIR_ARRAYS:
            arrays[prefix + f] = leaf(getattr(node, f))
        meta = {"kind": "dir"}
        meta.update({f: getattr(node, f) for f in _DIR_STATIC})
        meta["overflow"] = _encode_node(node.overflow, prefix + "o.",
                                        arrays, raw)
        return meta
    if isinstance(node, GrrRangeSplit):
        return {
            "kind": "split",
            "bounds": list(node.bounds),
            "table_len": node.table_len,
            "n_segments": node.n_segments,
            "parts": [_encode_node(p, f"{prefix}p{i}.", arrays, raw)
                      for i, p in enumerate(node.parts)],
        }
    if isinstance(node, GrrPair):
        arrays[prefix + "hot_ids"] = leaf(node.hot_ids)
        arrays[prefix + "x_hot"] = leaf(node.x_hot)
        if node.mid_ids is not None:
            arrays[prefix + "mid_ids"] = leaf(node.mid_ids)
        return {
            "kind": "pair",
            "row": _encode_node(node.row_dir, prefix + "r.", arrays, raw),
            "col": _encode_node(node.col_dir, prefix + "c.", arrays, raw),
            "mid": _encode_node(node.col_mid, prefix + "m.", arrays, raw),
            "has_mid_ids": node.mid_ids is not None,
        }
    raise TypeError(f"cannot serialize plan node {type(node)!r}")


def _decode_node(meta, prefix: str, arrays):
    """Manifest fragment → plan node with the leaves of ``arrays`` (host
    numpy, or tensors already placed)."""
    from photon_ml_torch.data.grr import GrrDirection, GrrPair, GrrRangeSplit

    if meta is None:
        return None
    kind = meta["kind"]
    if kind == "dir":
        kw = {f: arrays[prefix + f] for f in _DIR_ARRAYS}
        kw.update({f: meta[f] for f in _DIR_STATIC})
        kw["overflow"] = _decode_node(meta["overflow"], prefix + "o.",
                                      arrays)
        return GrrDirection(**kw)
    if kind == "split":
        return GrrRangeSplit(
            parts=tuple(_decode_node(p, f"{prefix}p{i}.", arrays)
                        for i, p in enumerate(meta["parts"])),
            bounds=tuple(meta["bounds"]),
            table_len=meta["table_len"],
            n_segments=meta["n_segments"],
        )
    if kind == "pair":
        return GrrPair(
            row_dir=_decode_node(meta["row"], prefix + "r.", arrays),
            col_dir=_decode_node(meta["col"], prefix + "c.", arrays),
            hot_ids=arrays[prefix + "hot_ids"],
            x_hot=arrays[prefix + "x_hot"],
            mid_ids=(arrays[prefix + "mid_ids"]
                     if meta["has_mid_ids"] else None),
            col_mid=_decode_node(meta["mid"], prefix + "m.", arrays),
        )
    raise ValueError(f"unknown plan node kind {kind!r}")


# -- save / load --------------------------------------------------------------


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
        except OSError:  # photon-lint: disable=swallowed-exception (tmp-orphan cleanup; the primary write error re-raises below)
            pass
        raise


def save_plan(path: str, plan) -> None:
    """Serialize a plan (or a list of plans, the sharded builder's) to
    ``path`` atomically.  Leaves may be numpy arrays or tensors on any
    device."""
    arrays: dict = {}
    if isinstance(plan, (list, tuple)):
        meta = {"kind": "list",
                "items": [_encode_node(p, f"s{i}.", arrays)
                          for i, p in enumerate(plan)]}
    else:
        meta = _encode_node(plan, "", arrays)
    atomic_savez(path, meta, arrays)


def load_plan(path: str):
    """Deserialize a plan with host numpy leaves, or None when the file
    is absent, truncated or structurally stale (the caller rebuilds)."""
    if not os.path.exists(path):
        return None
    z = None
    try:
        z = np.load(path, allow_pickle=False)
        meta = json.loads(bytes(z["__meta__"]).decode())
        if isinstance(meta, dict) and meta.get("kind") == "list":
            return [_decode_node(m, f"s{i}.", z)
                    for i, m in enumerate(meta["items"])]
        return _decode_node(meta, "", z)
    except Exception as e:  # corrupt, partial or stale: rebuild
        logger.warning("plan cache: unreadable entry %s (%r); rebuilding",
                       path, e)
        return None
    finally:
        if z is not None:
            z.close()

"""Coordinate-descent checkpoints in the legacy format.

Counterpart of ``photon_ml_tpu/utils/checkpoint.py``: one
``cd_iter_<k>.npz`` a completed iteration (plain ``np.savez``, no
manifest) plus a ``latest`` text pointer.  Fixed-effect coefficients
are flat arrays (``<name>__flat``), random-effect ones per-bucket block
lists (``<name>__nblocks``, ``<name>__block_<b>``), score planes
``<name>__score``.  ``reliability.checkpoint.RunCheckpointer`` writes a
superset of this layout and reads it back (``_load_legacy_cd``).
Arrays come back as CPU tensors.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _flatten(coefs: dict) -> dict:
    """coordinate → tensor | list[tensor]  ⇒  flat npz-key dict."""
    arrs = {}
    for name, w in coefs.items():
        if isinstance(w, (list, tuple)):
            arrs[f"{name}__nblocks"] = np.asarray(len(w))
            for b, blk in enumerate(w):
                arrs[f"{name}__block_{b}"] = _host(blk)
        else:
            arrs[f"{name}__flat"] = _host(w)
    return arrs


def _unflatten(data) -> dict:
    coefs: dict = {}
    for key in data.files:
        name, kind = key.rsplit("__", 1)
        if kind == "flat":
            coefs[name] = torch.from_numpy(np.array(data[key]))
        elif kind == "nblocks":
            coefs[name] = [
                torch.from_numpy(np.array(data[f"{name}__block_{b}"]))
                for b in range(int(data[key]))
            ]
    return coefs


def save_checkpoint(ckpt_dir: str, iteration: int, coefs: dict,
                    scores: dict | None = None) -> str:
    """Persist state after completed CD iteration ``iteration``
    (1-based).  ``scores`` (coordinate → [n]) makes a resumed run's
    offsets bitwise those of the uninterrupted run."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"cd_iter_{iteration}.npz")
    tmp = path + ".tmp"
    arrs = _flatten(coefs)
    for name, s in (scores or {}).items():
        arrs[f"{name}__score"] = _host(s)
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
        f.write(str(iteration))
    os.replace(os.path.join(ckpt_dir, "latest.tmp"),
               os.path.join(ckpt_dir, "latest"))
    return path


def load_latest_checkpoint(ckpt_dir: str) -> tuple[int, dict, dict] | None:
    """(completed_iteration, coefficients, scores) or None; ``scores``
    is empty for files written without them."""
    latest = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        iteration = int(f.read().strip())
    path = os.path.join(ckpt_dir, f"cd_iter_{iteration}.npz")
    with np.load(path) as data:
        scores = {key.rsplit("__", 1)[0]: torch.from_numpy(np.array(data[key]))
                  for key in data.files if key.endswith("__score")}
        coefs = _unflatten(_NpzView({k: data[k] for k in data.files
                                     if not k.endswith("__score")}))
        return iteration, coefs, scores


class _NpzView:
    """files/getitem adapter so ``_unflatten`` reads a dict."""

    def __init__(self, data: dict):
        self._data = data
        self.files = list(data)

    def __getitem__(self, key):
        return self._data[key]

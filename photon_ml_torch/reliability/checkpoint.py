"""Checkpoint/resume: atomic run-state snapshots.

Counterpart of ``photon_ml_tpu/reliability/checkpoint.py``, in the same
file format (``CHECKPOINT_SCHEMA``, key scheme, ``atomic_savez``), so a
snapshot written by either package resumes in the other.  Three
granularities:

- **CD level** (``save_cd`` / ``save_cd_partial``): completed sweeps,
  the position within a sweep, per-coordinate coefficients, the score
  planes plus the running total (restoring them makes a resumed run's
  offsets bitwise the uninterrupted run's), and the history.
- **Solver level** (``maybe_save_solver``): the streaming solvers' loop
  state every ``every_solver_iters`` iterations, under labels scoped by
  the CD loop (iteration × coordinate).
- **Stage level** (``save_stage``): the swept fit's lane matrix between
  sweeps, the tuner's per-round history.

Format: one uncompressed ``.npz`` a snapshot with a JSON ``__meta__``
manifest, and a ``latest`` text pointer; the CD layout is a superset of
``utils.checkpoint``'s.  An unreadable snapshot degrades to the
previous good one with a warning.

``flatten_tree`` turns a nested tree of dicts, lists, scalars and arrays
(numpy or torch, on any device) into a JSON-able manifest plus a flat
``{key: ndarray}`` dict; ``unflatten_tree`` inverts it, array leaves
coming back as numpy.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import re
import threading

import numpy as np
import torch

from photon_ml_torch.utils.checkpoint import _flatten, _NpzView, _unflatten

logger = logging.getLogger(__name__)

# Rides in every manifest; a mismatch is a clean miss.
CHECKPOINT_SCHEMA = 1

# Reserved npz-key prefix for state-tree arrays (disjoint from the
# utils.checkpoint coefficient/score keys).
_TREE_PREFIX = "__x__"


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


def _slug(label: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", label)


def _load_npz_manifest(path: str):
    """(manifest, {key: array}) of an ``atomic_savez`` file, or None when
    absent, unreadable, of another schema or without a manifest (a
    legacy ``utils.checkpoint`` file): a checkpoint read never crashes
    a run."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if "__meta__" not in z.files:
                logger.info("checkpoint %s: no manifest (legacy format)",
                            path)
                return None
            meta = json.loads(bytes(np.asarray(z["__meta__"])).decode())
            arrays = {key: np.asarray(z[key]) for key in z.files
                      if key != "__meta__"}
        if meta.get("schema") != CHECKPOINT_SCHEMA:
            logger.warning("checkpoint %s: schema %r != %d; ignoring",
                           path, meta.get("schema"), CHECKPOINT_SCHEMA)
            return None
        return meta, arrays
    except Exception as e:  # corrupt or torn: the previous one serves
        logger.warning("checkpoint %s unreadable (%r); ignoring", path, e)
        return None


class RunCheckpointer:
    """One training run's checkpoint directory and cadence.

    ``every_sweeps``: CD sweep-boundary cadence (the final sweep always
    snapshots).  ``every_solver_iters``: mid-solve cadence of the
    streaming solvers (0 = off); nonzero also turns on mid-sweep
    coordinate-boundary snapshots.  ``resume``: only a run launched to
    resume adopts solver state, and only a fresh run claims (empties)
    the directory at its first write.  Snapshots are written from the
    driving thread; ``session`` exposes the checkpointer to the
    streaming solvers (``active()``).
    """

    def __init__(self, ckpt_dir: str, every_sweeps: int = 1,
                 every_solver_iters: int = 0, run_logger=None,
                 resume: bool = False):
        if every_sweeps < 1:
            raise ValueError("every_sweeps must be >= 1")
        if every_solver_iters < 0:
            raise ValueError("every_solver_iters must be >= 0")
        self.dir = ckpt_dir
        self.every_sweeps = int(every_sweeps)
        self.every_solver_iters = int(every_solver_iters)
        self.resume = bool(resume)
        self._log = run_logger
        self._scope: list[str] = []
        self._claimed = False

    # -- shared write/read plumbing -----------------------------------------

    def _claim_dir(self) -> None:
        """A fresh run removes an earlier run's snapshots at its first
        write, so a later resume adopts only what this run wrote."""
        removed = 0
        for pattern in ("cd_iter_*.npz", "solver_*.npz", "stage_*.npz"):
            for path in glob.glob(os.path.join(self.dir, pattern)):
                with contextlib.suppress(OSError):
                    os.remove(path)
                    removed += 1
        for path in (os.path.join(self.dir, "latest"), self._partial_path):
            with contextlib.suppress(OSError):
                os.remove(path)
                removed += 1
        if removed:
            logger.info("checkpoint dir %s: fresh run removed %d stale "
                        "snapshot file(s) from a previous run",
                        self.dir, removed)
            self._event("checkpoint_dir_claimed", removed=removed)

    def _write(self, path: str, manifest: dict, arrays: dict,
               kind: str) -> None:
        from photon_ml_torch.cache.plan_cache import atomic_savez

        if not self._claimed:
            self._claimed = True
            if not self.resume:
                self._claim_dir()
        atomic_savez(path, {"schema": CHECKPOINT_SCHEMA, **manifest},
                     arrays)
        self._event("checkpoint_saved", level=kind, path=path)

    def _event(self, kind: str, **fields) -> None:
        if self._log is not None:
            self._log.event(kind, **fields)

    # -- CD level ------------------------------------------------------------

    def _cd_path(self, iteration: int) -> str:
        return os.path.join(self.dir, f"cd_iter_{iteration}.npz")

    @property
    def _partial_path(self) -> str:
        return os.path.join(self.dir, "cd_partial.npz")

    def _cd_payload(self, iteration: int, coord_pos: int, coefs: dict,
                    scores: dict, re_state: dict | None,
                    extra: dict | None) -> tuple[dict, dict]:
        arrays = _flatten(coefs)
        for name, s in (scores or {}).items():
            arrays[f"{name}__score"] = _host_array(s)
        tree_meta, tree_arrays = flatten_tree(
            {"re_state": re_state or {}, "extra": extra or {}})
        for key, a in tree_arrays.items():
            arrays[_TREE_PREFIX + key] = a
        manifest = {"kind": "cd", "iteration": int(iteration),
                    "coord_pos": int(coord_pos), "tree": tree_meta}
        return manifest, arrays

    def save_cd(self, iteration: int, coefs: dict, scores: dict,
                re_state: dict | None = None,
                extra: dict | None = None) -> str:
        """Sweep-boundary snapshot after completed (1-based) iteration
        ``iteration``; purges the solver and partial files it
        supersedes."""
        os.makedirs(self.dir, exist_ok=True)
        path = self._cd_path(iteration)
        manifest, arrays = self._cd_payload(iteration, 0, coefs, scores,
                                            re_state, extra)
        self._write(path, manifest, arrays, "cd")
        # A plain integer: the legacy loader reads the same pointer.
        tmp = os.path.join(self.dir, "latest.tmp")
        with open(tmp, "w") as f:
            f.write(str(int(iteration)))
        os.replace(tmp, os.path.join(self.dir, "latest"))
        self._clear_transient()
        return path

    def maybe_save_cd(self, iteration: int, coefs: dict, scores: dict,
                      re_state: dict | None = None,
                      extra: dict | None = None,
                      final: bool = False) -> str | None:
        """``save_cd`` every ``every_sweeps`` sweeps and on the final."""
        if final or iteration % self.every_sweeps == 0:
            return self.save_cd(iteration, coefs, scores,
                                re_state=re_state, extra=extra)
        return None

    def save_cd_partial(self, iteration: int, coord_pos: int, coefs: dict,
                        scores: dict, re_state: dict | None = None,
                        extra: dict | None = None) -> str:
        """Mid-sweep snapshot: ``coord_pos`` update-sequence entries of
        sweep ``iteration + 1`` are done.  One file, replaced."""
        os.makedirs(self.dir, exist_ok=True)
        manifest, arrays = self._cd_payload(
            iteration, coord_pos, coefs, scores, re_state, extra)
        self._write(self._partial_path, manifest, arrays, "cd_partial")
        return self._partial_path

    @property
    def mid_sweep_enabled(self) -> bool:
        return self.every_solver_iters > 0

    def _decode_cd(self, loaded) -> dict:
        manifest, arrays = loaded
        scores = {key.rsplit("__", 1)[0]: arrays[key]
                  for key in arrays if key.endswith("__score")}
        coef_arrays = {key: a for key, a in arrays.items()
                       if not key.endswith("__score")
                       and not key.startswith(_TREE_PREFIX)}
        tree_arrays = {key[len(_TREE_PREFIX):]: a
                       for key, a in arrays.items()
                       if key.startswith(_TREE_PREFIX)}
        tree = unflatten_tree(manifest["tree"], tree_arrays)
        return {
            "iteration": int(manifest["iteration"]),
            "coord_pos": int(manifest.get("coord_pos", 0)),
            "coefs": _unflatten(_NpzView(coef_arrays)),
            "scores": scores,
            "re_state": tree.get("re_state") or {},
            "extra": tree.get("extra") or {},
        }

    def _load_legacy_cd(self, path: str, iteration: int) -> dict | None:
        """A ``utils.checkpoint`` snapshot (no manifest), so a resume
        into a directory of that format restores the run."""
        try:
            with np.load(path, allow_pickle=False) as z:
                if "__meta__" in z.files:
                    return None
                arrays = {key: np.asarray(z[key]) for key in z.files}
        except Exception as e:  # corrupt: the previous one serves
            logger.warning("checkpoint %s unreadable (%r); ignoring",
                           path, e)
            return None
        scores = {key.rsplit("__", 1)[0]: arrays[key]
                  for key in arrays if key.endswith("__score")}
        coefs = _unflatten(_NpzView({k: a for k, a in arrays.items()
                                     if not k.endswith("__score")}))
        logger.info("checkpoint %s: restored legacy-format snapshot "
                    "(iteration %d)", path, iteration)
        return {"iteration": int(iteration), "coord_pos": 0,
                "coefs": coefs, "scores": scores,
                "re_state": {}, "extra": {}}

    def load_latest_cd(self) -> dict | None:
        """The most advanced readable CD snapshot (a partial beats its
        own sweep boundary; a corrupt newest file degrades to the
        previous good one), or None.  Keys: iteration, coord_pos, coefs
        (CPU tensors), scores (numpy), re_state, extra."""
        candidates: list[tuple[int, str]] = []
        latest = os.path.join(self.dir, "latest")
        if os.path.exists(latest):
            try:
                with open(latest) as f:
                    k = int(f.read().strip())
                candidates.append((k, self._cd_path(k)))
            except (OSError, ValueError) as e:
                logger.warning("checkpoint latest pointer unreadable "
                               "(%r); scanning %s", e, self.dir)
        for path in glob.glob(os.path.join(self.dir, "cd_iter_*.npz")):
            m = re.match(r"cd_iter_(\d+)\.npz$", os.path.basename(path))
            if m:
                candidates.append((int(m.group(1)), path))
        loaded_partial = _load_npz_manifest(self._partial_path)
        best = (self._decode_cd(loaded_partial)
                if loaded_partial is not None else None)

        def key(st: dict) -> tuple[int, int]:
            return (st["iteration"], st["coord_pos"])

        seen: set[str] = set()
        # Newest first; the first loadable boundary dominates the rest.
        for k, path in sorted(candidates, reverse=True):
            if path in seen:
                continue
            seen.add(path)
            if best is not None and (k, 0) <= key(best):
                break
            loaded = _load_npz_manifest(path)
            st = (self._decode_cd(loaded) if loaded is not None
                  else self._load_legacy_cd(path, k))
            if st is None:
                continue
            if best is None or key(st) > key(best):
                best = st
            break
        if best is not None:
            self._event("checkpoint_resume", iteration=best["iteration"],
                        coord_pos=best["coord_pos"])
        return best

    # -- solver level --------------------------------------------------------

    @contextlib.contextmanager
    def scope(self, *parts: str):
        """Position context for solver labels: the CD loop pushes
        (iteration, coordinate)."""
        self._scope.extend(str(p) for p in parts)
        try:
            yield self
        finally:
            del self._scope[len(self._scope) - len(parts):]

    def solver_label(self, label: str) -> str:
        return "/".join([*self._scope, label or "solve"])

    def _solver_path(self, label: str) -> str:
        return os.path.join(self.dir, f"solver_{_slug(label)}.npz")

    def maybe_save_solver(self, label: str, it: int, state: dict) -> bool:
        """Mid-solve snapshot every ``every_solver_iters`` iterations
        (0 disables); ``it`` rides in the tree."""
        if (self.every_solver_iters <= 0
                or it % self.every_solver_iters != 0):
            return False
        os.makedirs(self.dir, exist_ok=True)
        tree_meta, arrays = flatten_tree({"it": int(it), **state})
        self._write(self._solver_path(label),
                    {"kind": "solver", "label": label, "tree": tree_meta},
                    arrays, "solver")
        return True

    def load_solver(self, label: str) -> dict | None:
        if not self.resume:
            return None
        loaded = _load_npz_manifest(self._solver_path(label))
        if loaded is None:
            return None
        manifest, arrays = loaded
        if manifest.get("label") != label:
            return None
        state = unflatten_tree(manifest["tree"], arrays)
        self._event("checkpoint_solver_resume", label=label,
                    iteration=int(state.get("it", 0)))
        return state

    def clear_solver(self, label: str) -> None:
        with contextlib.suppress(OSError):
            os.remove(self._solver_path(label))

    def _clear_transient(self) -> None:
        """Drop the mid-solve and mid-sweep files a sweep-boundary
        snapshot supersedes."""
        for path in glob.glob(os.path.join(self.dir, "solver_*.npz")):
            with contextlib.suppress(OSError):
                os.remove(path)
        with contextlib.suppress(OSError):
            os.remove(self._partial_path)

    # -- stage level (swept lanes, tuner history) ----------------------------

    def _stage_path(self, name: str) -> str:
        return os.path.join(self.dir, f"stage_{_slug(name)}.npz")

    def save_stage(self, name: str, tree: dict) -> str:
        os.makedirs(self.dir, exist_ok=True)
        tree_meta, arrays = flatten_tree(tree)
        path = self._stage_path(name)
        self._write(path, {"kind": "stage", "name": name,
                           "tree": tree_meta}, arrays, f"stage:{name}")
        return path

    def load_stage(self, name: str) -> dict | None:
        loaded = _load_npz_manifest(self._stage_path(name))
        if loaded is None:
            return None
        manifest, arrays = loaded
        if manifest.get("name") != name:
            return None
        return unflatten_tree(manifest["tree"], arrays)

    def clear_stage(self, name: str) -> None:
        with contextlib.suppress(OSError):
            os.remove(self._stage_path(name))


# The active session: the streaming solvers are deep library code that
# consults it instead of taking a checkpointer argument.
_ACTIVE: list[RunCheckpointer] = []
_ACTIVE_LOCK = threading.Lock()


def active() -> RunCheckpointer | None:
    """The innermost active checkpointer, or None."""
    with _ACTIVE_LOCK:
        return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def session(ck: RunCheckpointer | None):
    """Expose ``ck`` to ``active()`` for the block; None is a no-op."""
    if ck is None:
        yield None
        return
    with _ACTIVE_LOCK:
        _ACTIVE.append(ck)
    try:
        yield ck
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE.remove(ck)

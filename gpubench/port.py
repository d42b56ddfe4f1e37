"""The benchmark's one adapter to the system under test, ``photon_ml_torch``.

No other file of the benchmark imports the port.  Every name of the
port that the benchmark touches is listed in ``PORT_NAMES``, and each
kernel launcher named by a file of ``gpubench/kernels/``; the
estimator's ``_prepare`` and ``_build_coordinates`` are its seams,
driven as ``chip_smoke.py`` drives them, and ``game_fit`` runs the
estimator's coordinate descent over the coordinates they build.  The
instruments (``Instruments``) wrap the objective's two evaluation
methods and those launchers while a traced run asks them to count;
otherwise nothing is patched.  A traced run also opens the port's own
telemetry session (``open_session``) while its session span records,
and reads device time by the port's spans from that trace
(``span_device_s``).
"""

from __future__ import annotations

import importlib
import json
import os

import torch

from photon_ml_torch.cache.compile_cache import enable_compilation_cache
from photon_ml_torch.config import (
    CoordinateConfig,
    CoordinateKind,
    OptimizerSettings,
    TaskType,
    TrainingConfig,
)
from photon_ml_torch import telemetry
from photon_ml_torch.data.batch import DenseBatch, SparseBatch
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.estimators.game_estimator import GameEstimator
from photon_ml_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_torch.game.dataset import GameDataset
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.optim.base import OptimizerConfig
from photon_ml_torch.telemetry.device import device_s_by_span

PORT_NAMES = (
    "photon_ml_torch.cache.compile_cache.enable_compilation_cache",
    "photon_ml_torch.config.CoordinateConfig",
    "photon_ml_torch.config.CoordinateKind",
    "photon_ml_torch.config.OptimizerSettings",
    "photon_ml_torch.config.TaskType",
    "photon_ml_torch.config.TrainingConfig",
    "photon_ml_torch.data.batch.DenseBatch",
    "photon_ml_torch.data.batch.SparseBatch",
    "photon_ml_torch.data.sparse_rows.SparseRows",
    "photon_ml_torch.estimators.game_estimator.GameEstimator",
    "photon_ml_torch.estimators.game_estimator.GameEstimator._prepare",
    "photon_ml_torch.estimators.game_estimator.GameEstimator._build_coordinates",
    "photon_ml_torch.game.dataset.GameDataset",
    "photon_ml_torch.game.coordinates.FixedEffectCoordinate (batch, problem)",
    "photon_ml_torch.game.coordinate_descent.run_coordinate_descent",
    "photon_ml_torch.optim.problem.OptimizationProblem.run",
    "photon_ml_torch.ops.objective.GLMObjective.value",
    "photon_ml_torch.ops.objective.GLMObjective.value_and_gradient",
    "photon_ml_torch.optim.base.OptimizerConfig",
    "photon_ml_torch.telemetry.start",
    "photon_ml_torch.telemetry.Telemetry.summary",
    "photon_ml_torch.telemetry.device.device_s_by_span",
)

KERNELS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "kernels")


def kernel_specs() -> dict:
    """The kernels whose launches a traced run records, by name: each
    ``gpubench/kernels/<name>.json`` (``launcher`` as ``module:attr``,
    its ``args``, the ``distinct`` args whose distinct values are
    counted, and the ``device_name`` the profiler reports)."""
    out = {}
    for f in sorted(os.listdir(KERNELS_DIR)):
        if f.endswith(".json"):
            with open(os.path.join(KERNELS_DIR, f), encoding="utf-8") as fh:
                out[f[:-5]] = json.load(fh)
    return out


def use_build_dir(root: str) -> str | None:
    """Build and load the port's kernels under ``<root>/build/kernels``."""
    return enable_compilation_cache(os.path.join(root, "build"))


def check_solver(solver: dict) -> None:
    """Refuse to run where the port's L-BFGS settings differ from the
    configuration's: the port takes them from its defaults."""
    cfg = OptimizerConfig()
    port = {"memory": cfg.lbfgs_memory, "ls_shrink": cfg.ls_shrink,
            "ls_c1": cfg.ls_c1, "ls_max_steps": cfg.ls_max_steps}
    for key, value in port.items():
        if float(solver[key]) != float(value):
            raise ValueError(f"the port's L-BFGS {key} is {value}, the "
                             f"configuration states {solver[key]}")


def game_dataset(data: dict) -> GameDataset:
    """The generated arrays as the port's dataset: the fixed-effect shard
    ``global`` as ``SparseRows``, and where the data model returns them,
    its ``entity_ids`` (key → [n] ids) and further dense ``shards``
    (name → [n, p] array)."""
    rows = SparseRows.from_flat(data["indptr"], data["cols"], data["vals"])
    return GameDataset(labels=data["labels"],
                       features={"global": rows, **data.get("shards", {})},
                       entity_ids=dict(data.get("entity_ids", {})),
                       feature_dims={"global": int(data["dim"])})


def training_config(config: dict, traffic: dict, device: str
                    ) -> TrainingConfig:
    """The configuration's coordinates and the traffic's layout as the
    port's ``TrainingConfig``: an entry of ``"kind": "fixed"`` a fixed
    effect, of ``"kind": "random"`` a random effect over its
    ``entity_key``; ``n_iterations`` coordinate-descent sweeps (1 where
    the configuration states none)."""
    kinds = {"fixed": CoordinateKind.FIXED_EFFECT,
             "random": CoordinateKind.RANDOM_EFFECT}
    coords = []
    for c in config["coordinates"]:
        settings = OptimizerSettings(max_iters=int(c["max_iters"]),
                                     tolerance=float(c["tolerance"]),
                                     reg_weight=float(c["l2"]))
        if c["kind"] not in kinds:
            raise ValueError(f"{c['name']}: coordinate kind {c['kind']!r} "
                             f"is not one of {sorted(kinds)}")
        coords.append(CoordinateConfig(
            c["name"], kinds[c["kind"]], c["shard"],
            entity_key=c.get("entity_key"), optimizer=settings))
    return TrainingConfig(
        task_type=TaskType(config["task"].upper()), coordinates=coords,
        update_sequence=list(config["update_sequence"]),
        n_iterations=int(config.get("n_iterations", 1)),
        intercept=bool(config["intercept"]),
        sparse_layout=traffic["layout"], validate_per_iteration=False,
        device=device)


def estimator(config: dict, traffic: dict, device: str) -> GameEstimator:
    check_solver(config["solver"])
    return GameEstimator(training_config(config, traffic, device))


def prepare(est: GameEstimator, train: GameDataset) -> dict:
    return est._prepare(train)


def build_coordinates(est: GameEstimator, train: GameDataset, prep: dict,
                      reg_weights: dict) -> dict:
    return est._build_coordinates(train, prep, reg_weights)


def fixed_effect_solve(coord, w0: torch.Tensor) -> torch.Tensor:
    """The fixed-effect coordinate's solve over its prepared batch."""
    return coord.problem.run(coord.batch, w0).w


def fixed_batch(coord):
    return coord.batch


def game_fit(est: GameEstimator, coords: dict,
             initial: dict | None = None) -> dict:
    """One GAME fit at fixed λ a coordinate, as
    ``GameEstimator._fit_point`` runs it (no validation, checkpoints,
    warm-start model or locked coordinates): ``run_coordinate_descent``
    over ``coords`` (built once in set-up by ``build_coordinates``) from
    ``initial`` (name → starting coefficients; zeros where absent) → the
    final coefficients by coordinate (a random effect's: one tensor a
    bucket)."""
    cfg = est.config
    return run_coordinate_descent(
        coordinates=coords, update_sequence=cfg.update_sequence,
        n_iterations=cfg.n_iterations,
        initial_coefficients=initial).coefficients


def open_session(device: str):
    """The port's ``metrics`` telemetry session: its counters and span
    statistics, and while a profiler records, its spans as ranges."""
    return telemetry.start("metrics", device=device)


def close_session(session) -> dict:
    """Close ``session`` → its summary (``counters``, ``spans``)."""
    session.close()
    return session.summary()


def span_device_s(events) -> dict:
    """Device seconds by the port's spans in a profiler trace taken with
    the host's operations while a session was open
    (``telemetry.device.device_s_by_span``: ``busy_s``, ``spans``,
    ``outside_s``, ``unlinked_s``)."""
    return device_s_by_span(events)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def evaluation_bytes(w: torch.Tensor, batch, gradient: bool) -> int | None:
    """Least bytes one evaluation moves: every array of the layout it
    reads, the labels, weights, offsets, mask and coefficients read
    once; each lane's value (and the gradient) written once.  A plain-ELL
    ``SparseBatch`` reads its values and column ids, a ``DenseBatch`` its
    ``x``; None for a layout with no count here (GRR, the transposed
    ELL)."""
    if isinstance(batch, SparseBatch):
        if batch.grr is not None or batch.colmajor is not None:
            return None
        layout = _nbytes(batch.values, batch.col_ids)
    elif isinstance(batch, DenseBatch):
        layout = _nbytes(batch.x)
    else:
        return None
    read = layout + _nbytes(batch.labels, batch.weights, batch.offsets,
                            batch.mask)
    lanes = w.numel() // w.shape[-1]
    written = lanes * w.element_size() + (_nbytes(w) if gradient else 0)
    return read + _nbytes(w) + written


class Instruments:
    """Counts objective evaluations (by the batch's type, with their
    least bytes; ``uncounted`` those with no byte count) and records the
    launches of the kernels of ``kernel_specs`` while installed: each
    launch's argument shapes, and for its ``distinct`` arguments the
    tensor, counted by ``resolve`` once the window has closed.  Launches
    are recorded only while ``recording`` is set."""

    def __init__(self):
        self.evaluations = 0
        self.eval_bytes = 0
        self.uncounted = 0
        self.batches: dict = {}
        self.recording = False
        self.specs = kernel_specs()
        self.launches: dict = {name: [] for name in self.specs}
        self._saved: list = []

    def _count(self, fn, gradient: bool):
        inst = self

        def wrapped(obj, w, batch):
            inst.evaluations += 1
            kind = type(batch).__name__
            inst.batches[kind] = inst.batches.get(kind, 0) + 1
            nbytes = evaluation_bytes(w, batch, gradient)
            if nbytes is None:
                inst.uncounted += 1
            else:
                inst.eval_bytes += nbytes
            return fn(obj, w, batch)
        return wrapped

    def _launch(self, fn, name: str):
        inst, spec = self, self.specs[name]

        def wrapped(*args):
            if inst.recording:
                named = dict(zip(spec["args"], args))
                inst.launches[name].append({
                    "shapes": {k: tuple(v.shape) for k, v in named.items()
                               if isinstance(v, torch.Tensor)},
                    "distinct": {k: named[k] for k in spec["distinct"]}})
            return fn(*args)
        # A launcher counts itself by its module-level name: the wrapper
        # where it is patched in its own module (``__exit__`` hands the
        # count on), itself where a caller's name is patched.
        wrapped.launches = getattr(fn, "launches", 0)
        wrapped.launches_at_entry = wrapped.launches
        return wrapped

    def resolve(self) -> dict:
        """The recorded launches by kernel, each ``distinct`` argument
        replaced by its number of distinct values (counted once a
        tensor); no tensor is held after."""
        seen: dict = {}
        for records in self.launches.values():
            for rec in records:
                for k, t in rec["distinct"].items():
                    key = (t.data_ptr(), tuple(t.shape))
                    if key not in seen:
                        seen[key] = int(torch.unique(t).numel())
                    rec["distinct"][k] = seen[key]
        return self.launches

    def __enter__(self):
        patches = [
            (GLMObjective, "value",
             self._count(GLMObjective.value, False)),
            (GLMObjective, "value_and_gradient",
             self._count(GLMObjective.value_and_gradient, True)),
        ]
        for name, spec in self.specs.items():
            module, attr = spec["launcher"].split(":")
            owner = importlib.import_module(module)
            patches.append((owner, attr, self._launch(getattr(owner, attr),
                                                      name)))
        for owner, attr, new in patches:
            self._saved.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, new)
        return self

    def __exit__(self, *exc):
        for owner, attr, old in reversed(self._saved):
            new = getattr(owner, attr)
            if hasattr(old, "launches"):
                old.launches += new.launches - new.launches_at_entry
            setattr(owner, attr, old)
        self._saved.clear()
        return False

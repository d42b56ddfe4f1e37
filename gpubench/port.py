"""The benchmark's one adapter to the system under test, ``photon_ml_torch``.

No other file of the benchmark imports the port.  Every name of the
port that the benchmark touches is listed in ``PORT_NAMES``, and each
kernel launcher named by a file of ``gpubench/kernels/``; the
estimator's ``_prepare`` and ``_build_coordinates`` are its seams,
driven as ``chip_smoke.py`` drives them.  The instruments (``Instruments``) wrap the objective's
two evaluation methods and those launchers while a traced run asks them
to count; otherwise nothing is patched.
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
from photon_ml_torch.data.batch import SparseBatch
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.estimators.game_estimator import GameEstimator
from photon_ml_torch.game.dataset import GameDataset
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.optim.base import OptimizerConfig

PORT_NAMES = (
    "photon_ml_torch.cache.compile_cache.enable_compilation_cache",
    "photon_ml_torch.config.CoordinateConfig",
    "photon_ml_torch.config.CoordinateKind",
    "photon_ml_torch.config.OptimizerSettings",
    "photon_ml_torch.config.TaskType",
    "photon_ml_torch.config.TrainingConfig",
    "photon_ml_torch.data.batch.SparseBatch",
    "photon_ml_torch.data.sparse_rows.SparseRows",
    "photon_ml_torch.estimators.game_estimator.GameEstimator",
    "photon_ml_torch.estimators.game_estimator.GameEstimator._prepare",
    "photon_ml_torch.estimators.game_estimator.GameEstimator._build_coordinates",
    "photon_ml_torch.game.dataset.GameDataset",
    "photon_ml_torch.game.coordinates.FixedEffectCoordinate (batch, problem)",
    "photon_ml_torch.optim.problem.OptimizationProblem.run",
    "photon_ml_torch.ops.objective.GLMObjective.value",
    "photon_ml_torch.ops.objective.GLMObjective.value_and_gradient",
    "photon_ml_torch.optim.base.OptimizerConfig",
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
    """The generated arrays as the port's dataset: one fixed-effect
    shard, ``global``, as ``SparseRows``."""
    rows = SparseRows.from_flat(data["indptr"], data["cols"], data["vals"])
    return GameDataset(labels=data["labels"], features={"global": rows},
                       entity_ids={},
                       feature_dims={"global": int(data["dim"])})


def training_config(config: dict, traffic: dict, device: str
                    ) -> TrainingConfig:
    """The configuration's coordinates and the traffic's layout as the
    port's ``TrainingConfig``."""
    coords = []
    for c in config["coordinates"]:
        settings = OptimizerSettings(max_iters=int(c["max_iters"]),
                                     tolerance=float(c["tolerance"]),
                                     reg_weight=float(c["l2"]))
        if c["kind"] != "fixed":
            raise ValueError(f"{c['name']}: only fixed effects are run")
        coords.append(CoordinateConfig(
            c["name"], CoordinateKind.FIXED_EFFECT, c["shard"],
            optimizer=settings))
    return TrainingConfig(
        task_type=TaskType(config["task"].upper()), coordinates=coords,
        update_sequence=list(config["update_sequence"]),
        n_iterations=1,
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


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def evaluation_bytes(w: torch.Tensor, batch, gradient: bool) -> int:
    """Least bytes one evaluation moves: every array of the layouts it
    reads, the labels, weights, offsets, mask and coefficients read
    once; the values (and the gradient) written once."""
    if not isinstance(batch, SparseBatch):
        raise TypeError(f"no byte count for {type(batch).__name__}")
    if batch.grr is not None or batch.colmajor is not None:
        raise ValueError("no byte count for the GRR or transposed layouts")
    read = _nbytes(batch.values, batch.col_ids, batch.labels, batch.weights,
                   batch.offsets, batch.mask)
    lanes = w.numel() // w.shape[-1]
    written = lanes * w.element_size() + (_nbytes(w) if gradient else 0)
    return read + _nbytes(w) + written


class Instruments:
    """Counts objective evaluations (with their least bytes) and records
    the launches of the kernels of ``kernel_specs`` while installed:
    each launch's argument shapes, and for its ``distinct`` arguments
    the tensor, counted by ``resolve`` once the window has closed.
    Launches are recorded only while ``recording`` is set."""

    def __init__(self):
        self.evaluations = 0
        self.eval_bytes = 0
        self.recording = False
        self.specs = kernel_specs()
        self.launches: dict = {name: [] for name in self.specs}
        self._saved: list = []

    def _count(self, fn, gradient: bool):
        inst = self

        def wrapped(obj, w, batch):
            inst.evaluations += 1
            inst.eval_bytes += evaluation_bytes(w, batch, gradient)
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
        # The launcher counts itself by its module-level name.
        wrapped.launches = getattr(fn, "launches", 0)
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
            if hasattr(old, "launches"):
                old.launches = getattr(owner, attr).launches
            setattr(owner, attr, old)
        self._saved.clear()
        return False

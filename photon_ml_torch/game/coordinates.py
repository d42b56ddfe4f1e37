"""GAME coordinates: the per-coordinate train/score units.

Counterpart of the resident part of ``photon_ml_tpu/game/coordinates.py``.
The contract is Photon-ML's: ``train(offsets, warm start) →
(coefficients, diagnostics)`` and ``score(coefficients) → per-example
scores``, scores being raw dot products x·w, summable across
coordinates.

- ``FixedEffectCoordinate``: one ``OptimizationProblem.run`` over the
  whole batch (its layout — plain ELL, transposed ELL or GRR — decides
  which kernels run), with the offsets installed and, optionally, a
  down-sampled row view.
- ``RandomEffectCoordinate``: entity blocks grouped by size bucket once
  on the host (``EntityGrouping``); each bucket trains as ONE
  lane-batched solve (``optim.problem.solve_batched``), every entity a
  lane converging on its own criteria.  Offsets move from example space
  to block space with ``index_put_`` and scores come back by a gather.

- ``ChunkedFixedEffectCoordinate``: the fixed effect over a
  ``ChunkedBatch`` (host-resident or spilled to disk), streamed to the
  card on every evaluation by the ``optim.streaming`` solvers.

``train_swept`` trains a whole λ grid as one lane-batched solve over
the shared batch (``optim.lbfgs.lbfgs_solve_swept``, or its streamed
counterpart).  The streamed random effect is ROADMAP A5b and the mesh
variants A7; they raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from photon_ml_torch.data.batch import Batch, DenseBatch, SparseBatch
from photon_ml_torch.device import resolve_device
from photon_ml_torch.game.dataset import (
    EntityGrouping,
    GameDataset,
    bucket_occupancy,
    group_by_entity,
)
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.game import FixedEffectModel, RandomEffectModel
from photon_ml_torch.ops.objective import (
    GLMObjective,
    sweep_value,
    sweep_value_and_gradient,
)
from photon_ml_torch.optim.base import OptimizerConfig, OptimizerType
from photon_ml_torch.optim.lbfgs import lbfgs_solve_swept
from photon_ml_torch.optim.problem import OptimizationProblem, solve_batched

logger = logging.getLogger(__name__)

Tensor = torch.Tensor


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded coordinates are not ported yet (ROADMAP A7)")


def _apply_training_view(batch: Batch, offsets: Tensor, train_idx,
                         train_weights) -> Batch:
    """The batch with the offsets installed; with ``train_idx``, only
    those rows (the down-sampled view) and their ``train_weights``."""
    if train_idx is None:
        return dataclasses.replace(batch, offsets=offsets)
    if isinstance(batch, SparseBatch):
        # The transposed-ELL and GRR layouts index every row: the row
        # subset drops them and runs on its ELL arrays.
        sub = dataclasses.replace(
            batch, values=batch.values[train_idx],
            col_ids=batch.col_ids[train_idx], labels=batch.labels[train_idx],
            mask=batch.mask[train_idx], colmajor=None, grr=None)
    else:
        sub = dataclasses.replace(
            batch, x=batch.x[train_idx], labels=batch.labels[train_idx],
            mask=batch.mask[train_idx])
    return dataclasses.replace(sub, offsets=offsets[train_idx],
                               weights=train_weights)


class Coordinate:
    """The train/score contract."""

    name: str

    def initial_coefficients(self):
        raise NotImplementedError

    def train(self, offsets: Tensor, warm_start):
        """offsets [n] (the other coordinates' scores) → (coefficients,
        optimizer diagnostics)."""
        raise NotImplementedError

    def score(self, coefficients) -> Tensor:
        """coefficients → per-example scores [n]."""
        raise NotImplementedError


@dataclasses.dataclass(eq=False)
class FixedEffectCoordinate(Coordinate):
    """One global solve over the full batch."""

    name: str
    batch: Batch                     # the full batch (scoring)
    problem: OptimizationProblem
    # Down-sampled training view: train on rows ``train_idx`` with
    # ``train_weights``; score every row.
    train_idx: Tensor | None = None
    train_weights: Tensor | None = None
    distributed: None = None         # mesh objective: ROADMAP A7

    def __post_init__(self):
        _no_mesh(self.distributed)

    def initial_coefficients(self) -> Tensor:
        return torch.zeros(self.batch.dim, dtype=torch.float32,
                           device=self.batch.labels.device)

    def _training_batch(self, offsets: Tensor) -> Batch:
        return _apply_training_view(self.batch, offsets, self.train_idx,
                                    self.train_weights)

    def train(self, offsets: Tensor, warm_start: Tensor | None = None):
        w0 = self.initial_coefficients() if warm_start is None else warm_start
        res = self.problem.run(self._training_batch(offsets), w0)
        return res.w, res

    def train_swept(self, offsets: Tensor, reg, warm_start=None):
        """Train the whole λ grid as ONE batched solve: L stacked
        coefficient lanes share every objective evaluation against the
        same training view.

        Args:
          offsets: [n] scores shared by every lane (the sweep varies
            only the regularization).
          reg: ``ops.regularization.SweptRegularization``, a lane a grid
            point.
          warm_start: optional [L, dim] starting points.

        Returns (W [L, dim], the lane-batched OptimizationResult).
        """
        if self.problem.optimizer == OptimizerType.TRON:
            raise ValueError(
                "train_swept supports LBFGS/OWL-QN lanes only (the λ "
                "sweep is the L-BFGS grid workload; fit TRON "
                "coordinates per grid point)")
        dev = self.batch.labels.device
        dim = self.batch.dim
        W0 = (torch.zeros((reg.n_lanes, dim), dtype=torch.float32,
                          device=dev) if warm_start is None
              else warm_start.to(device=dev, dtype=torch.float32))
        obj = self.problem.objective
        l1v = (reg.l1_vectors(dim, obj.reg.reg_mask).to(dev)
               if reg.has_l1() else None)
        l2s = reg.l2_weights.to(dev)
        view = self._training_batch(offsets)
        res = lbfgs_solve_swept(
            lambda W: sweep_value_and_gradient(obj, W, view, l2s), W0,
            self.problem.config, l1_weights=l1v,
            value=lambda W: sweep_value(obj, W, view, l2s))
        return res.w, res

    def score(self, coefficients: Tensor) -> Tensor:
        return self.batch.x_dot(coefficients)

    def compute_variances(self, coefficients: Tensor, offsets: Tensor,
                          variance_type) -> Tensor | None:
        """Coefficient variances at the optimum over the training view."""
        from photon_ml_torch.optim.variance import compute_variances

        return compute_variances(self.problem.objective, coefficients,
                                 self._training_batch(offsets),
                                 variance_type)


@dataclasses.dataclass(eq=False)
class ChunkedFixedEffectCoordinate(Coordinate):
    """A fixed effect trained by chunk-accumulated streaming: the data
    stays on the host or on disk (``data.chunked_batch``) and streams
    to the card on every objective evaluation.

    The same ``train``/``score`` contract as ``FixedEffectCoordinate``:
    the solve is ``optim.streaming.streaming_lbfgs_solve`` (L-BFGS, or
    OWL-QN with L1) or ``streaming_tron_solve`` (TRON, preconditioned by
    the Hessian-diagonal pass) over a ``ChunkedGLMObjective``; a spilled
    batch runs the prefetch pipeline on every training and scoring
    sweep.  ``train_swept`` runs L-BFGS lanes only, as on the resident
    path.  Down-sampled views and FULL variances are refused by the
    config."""

    name: str
    chunked: "object"                 # data.chunked_batch.ChunkedBatch
    objective: GLMObjective           # reg and prior added once a pass
    optimizer: "object"               # OptimizerType
    config: OptimizerConfig
    max_resident: int = 1
    prefetch_depth: int = 2
    device: "object" = None           # default CUDA; "cpu" when asked

    def __post_init__(self):
        from photon_ml_torch.optim.streaming import ChunkedGLMObjective

        self.device = resolve_device(self.device)
        self._obj = ChunkedGLMObjective(
            self.objective, self.chunked, max_resident=self.max_resident,
            prefetch_depth=self.prefetch_depth, device=self.device)

    @property
    def problem(self) -> OptimizationProblem:
        """The (objective, optimizer, config) triple, as the resident
        coordinate exposes it (model export reads its normalization)."""
        return OptimizationProblem(objective=self.objective,
                                   optimizer=self.optimizer,
                                   config=self.config)

    def initial_coefficients(self) -> Tensor:
        return torch.zeros(self.chunked.dim, dtype=torch.float32,
                           device=self.device)

    def _coerce_offsets(self, offsets) -> np.ndarray:
        """Offsets → exactly ``chunked.n`` entries.  A longer array is
        accepted only at the chunk padding grid's length; anything else
        longer raises, and a shorter one fails in ``set_offsets``."""
        if isinstance(offsets, Tensor):
            offsets = offsets.detach().cpu().numpy()
        off = np.asarray(offsets, np.float32)
        n = self.chunked.n
        if off.shape[0] == n:
            return off
        grid = self.chunked.n_chunks * self.chunked.chunk_rows
        if off.shape[0] == grid:
            return off[:n]
        if off.shape[0] > n:
            raise ValueError(
                f"offsets length {off.shape[0]} exceeds n {n} and does "
                f"not match the chunk padding grid {grid}")
        return off

    def _install(self, offsets) -> None:
        self.chunked.set_offsets(self._coerce_offsets(offsets))
        self._obj.invalidate()

    def train(self, offsets, warm_start: Tensor | None = None):
        from photon_ml_torch.optim.streaming import (
            streaming_lbfgs_solve,
            streaming_tron_solve,
        )

        self._install(offsets)
        w0 = (self.initial_coefficients() if warm_start is None
              else warm_start.to(device=self.device, dtype=torch.float32))
        problem = self.problem
        l1 = problem._l1_vector(w0) if problem.has_l1() else None
        if self.optimizer == OptimizerType.TRON:
            if l1 is not None:
                raise ValueError(
                    "TRON supports smooth objectives only (no L1) — "
                    "as on the resident path")
            res = streaming_tron_solve(
                self._obj.value_and_gradient, self._obj.hvp_pass, w0,
                self.config, hessian_diag=self._obj.hessian_diagonal,
                label=self.name)
        else:
            res = streaming_lbfgs_solve(
                self._obj.value_and_gradient, w0, self.config,
                l1_weight=l1, value_fn=self._obj.value, label=self.name)
        return res.w, res

    def train_swept(self, offsets, reg, warm_start=None):
        """The λ grid as one streamed solve: one chunk sweep an
        evaluation feeds all L lanes (the lane kernel on every chunk).
        The contract of ``FixedEffectCoordinate.train_swept``."""
        from photon_ml_torch.optim.streaming import (
            streaming_lbfgs_solve_swept,
        )

        if self.optimizer == OptimizerType.TRON:
            raise ValueError(
                "train_swept supports LBFGS/OWL-QN lanes only (the λ "
                "sweep is the L-BFGS grid workload; fit TRON "
                "coordinates per grid point)")
        self._install(offsets)
        dim = self.chunked.dim
        W0 = (torch.zeros((reg.n_lanes, dim), dtype=torch.float32,
                          device=self.device) if warm_start is None
              else warm_start.to(device=self.device, dtype=torch.float32))
        l1v = (reg.l1_vectors(dim, self.objective.reg.reg_mask)
               .to(self.device) if reg.has_l1() else None)
        res = streaming_lbfgs_solve_swept(
            lambda W: self._obj.value_and_gradient_swept(W, reg),
            lambda W: self._obj.value_swept(W, reg),
            W0, self.config, l1_weights=l1v, label=self.name)
        return res.w, res

    def score(self, coefficients: Tensor) -> Tensor:
        """Raw X·w per example (offset-free), on the coordinate's device."""
        return torch.from_numpy(self._obj.x_dot(coefficients)).to(
            self.device)

    def as_model(self, coefficients: Tensor) -> FixedEffectModel:
        return FixedEffectModel(
            coefficients=Coefficients(means=coefficients),
            feature_shard=self.name)

    def compute_variances(self, coefficients: Tensor, offsets,
                          variance_type) -> Tensor | None:
        """SIMPLE variances from one Hessian-diagonal pass; FULL would
        materialize a [d, d] Hessian and is refused."""
        from photon_ml_torch.optim.variance import VarianceComputationType

        if variance_type == VarianceComputationType.NONE:
            return None
        if variance_type == VarianceComputationType.FULL:
            raise ValueError(
                "FULL variances materialize a [d, d] Hessian — not "
                "supported on the chunked path; use SIMPLE")
        self._install(offsets)
        diag = self._obj.hessian_diagonal(coefficients)
        return 1.0 / torch.clamp(diag, min=1e-12)


@dataclasses.dataclass(eq=False)
class RandomEffectCoordinate(Coordinate):
    """Per-entity solves: one lane-batched solve a size bucket."""

    name: str
    grouping: EntityGrouping
    # Per-bucket device tensors; widths may differ a bucket when a
    # subspace projection is applied.
    x_blocks: list[Tensor]        # [E_b, cap_b, p_b]
    label_blocks: list[Tensor]    # [E_b, cap_b]
    weight_blocks: list[Tensor]   # [E_b, cap_b]
    mask_blocks: list[Tensor]     # [E_b, cap_b]
    # Example space ↔ block space, per bucket:
    ex_idx: list[Tensor]          # [n_b] example positions in this bucket
    row_idx: list[Tensor]         # [n_b] entity slot
    col_idx: list[Tensor]         # [n_b] position within the entity
    n_examples: int
    problem: OptimizationProblem
    projection: "object | None" = None   # SubspaceProjection when sparse

    @property
    def device(self) -> torch.device:
        return self.label_blocks[0].device

    def initial_coefficients(self) -> list[Tensor]:
        return [torch.zeros((blk.shape[0], blk.shape[-1]),
                            dtype=torch.float32, device=blk.device)
                for blk in self.x_blocks]

    def block_batch(self, b: int, offsets: Tensor) -> DenseBatch:
        """Bucket b's entity blocks as one lane-stacked DenseBatch, the
        per-example offsets scattered into block space."""
        off = torch.zeros_like(self.label_blocks[b])
        off.index_put_((self.row_idx[b], self.col_idx[b]),
                       offsets[self.ex_idx[b]])
        return DenseBatch(x=self.x_blocks[b], labels=self.label_blocks[b],
                          weights=self.weight_blocks[b], offsets=off,
                          mask=self.mask_blocks[b])

    def train(self, offsets: Tensor, warm_start=None):
        w0s = self.initial_coefficients() if warm_start is None else warm_start
        results = [solve_batched(self.problem, self.block_batch(b, offsets),
                                 w0s[b])
                   for b in range(len(self.x_blocks))]
        return [r.w for r in results], results

    def score(self, coefficient_blocks: list[Tensor]) -> Tensor:
        """x·w per entity block, gathered back to example order."""
        scores = torch.zeros(self.n_examples, dtype=torch.float32,
                             device=self.device)
        for b, w_b in enumerate(coefficient_blocks):
            blk = (self.x_blocks[b] * w_b[:, None, :]).sum(-1)
            scores[self.ex_idx[b]] = blk[self.row_idx[b], self.col_idx[b]]
        return scores

    def as_model(self, coefficient_blocks: list[Tensor]) -> RandomEffectModel:
        return RandomEffectModel(coefficient_blocks=coefficient_blocks,
                                 grouping=self.grouping,
                                 feature_shard=self.name,
                                 projection=self.projection)

    def compute_variance_blocks(self, coefficient_blocks: list[Tensor],
                                offsets: Tensor) -> list[Tensor]:
        """SIMPLE per-entity variances (1 / diag H), lane-batched a
        bucket."""
        from photon_ml_torch.optim.variance import simple_variances

        return [simple_variances(self.problem.objective, w_b,
                                 self.block_batch(b, offsets))
                for b, w_b in enumerate(coefficient_blocks)]

    @property
    def coefficient_shapes(self) -> list[tuple[int, int]]:
        """(entities, width) a bucket."""
        return [(blk.shape[0], blk.shape[-1]) for blk in self.x_blocks]


def _log_occupancy(name: str, grouping: EntityGrouping) -> None:
    """One log line of bucket occupancy and padding waste a build."""
    occ = bucket_occupancy(grouping)
    per_bucket = ", ".join(
        f"cap={b['capacity']}:E={b['entities']}:fill={b['fill_fraction']}"
        for b in occ["buckets"])
    logger.info(
        "RE coordinate '%s': %d entities / %d examples in %d buckets "
        "[%s]; padded-slot ratio %.4f (%d of %d slots)",
        name, occ["entities"], occ["examples"], len(occ["buckets"]),
        per_bucket, occ["padded_slot_ratio"], occ["padded_slots"],
        occ["total_slots"])


def _scalar_blocks(grouping: EntityGrouping, labels, weights, dev):
    """labels/weights/mask → per-bucket [E_b, cap_b] tensors."""
    lab, wt, msk = [], [], []
    for b, (cap, ne) in enumerate(zip(grouping.capacities,
                                      grouping.n_entities)):
        sel = np.flatnonzero(grouping.example_bucket == b)
        rows, cols = grouping.example_row[sel], grouping.example_col[sel]
        lb = np.zeros((ne, cap), np.float32)
        wb = np.zeros((ne, cap), np.float32)
        mb = np.zeros((ne, cap), np.float32)
        lb[rows, cols] = labels[sel]
        wb[rows, cols] = weights[sel]
        mb[rows, cols] = 1.0
        lab.append(torch.from_numpy(lb).to(dev))
        wt.append(torch.from_numpy(wb).to(dev))
        msk.append(torch.from_numpy(mb).to(dev))
    return lab, wt, msk


def _index_maps(grouping: EntityGrouping, dev):
    ex_idx, row_idx, col_idx = [], [], []
    for b in range(len(grouping.capacities)):
        sel = np.flatnonzero(grouping.example_bucket == b)
        ex_idx.append(torch.from_numpy(sel.astype(np.int64)).to(dev))
        row_idx.append(torch.from_numpy(
            grouping.example_row[sel].astype(np.int64)).to(dev))
        col_idx.append(torch.from_numpy(
            grouping.example_col[sel].astype(np.int64)).to(dev))
    return ex_idx, row_idx, col_idx


def _problem(objective, config, optimizer) -> OptimizationProblem:
    return OptimizationProblem(objective=objective,
                               optimizer=optimizer or OptimizerType.LBFGS,
                               config=config or OptimizerConfig())


def build_random_effect_coordinate(
    name: str,
    dataset: GameDataset,
    feature_shard: str,
    objective: GLMObjective,
    config: OptimizerConfig | None = None,
    optimizer=None,
    bucket_base: int = 4,
    mesh=None,
    device=None,
) -> RandomEffectCoordinate:
    """Dense shard: host grouping → per-bucket blocks on ``device``
    (default CUDA; ``"cpu"`` when asked)."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    x = np.asarray(dataset.features[feature_shard], np.float32)
    grouping = group_by_entity(dataset.entity_ids[name],
                               bucket_base=bucket_base)
    labels = dataset.labels.astype(np.float32)
    lab, wt, msk = _scalar_blocks(grouping, labels, dataset.weight_array(),
                                  dev)
    ex_idx, row_idx, col_idx = _index_maps(grouping, dev)
    x_blocks = []
    for b, (cap, ne) in enumerate(zip(grouping.capacities,
                                      grouping.n_entities)):
        sel = np.flatnonzero(grouping.example_bucket == b)
        xb = np.zeros((ne, cap, x.shape[1]), np.float32)
        xb[grouping.example_row[sel], grouping.example_col[sel]] = x[sel]
        x_blocks.append(torch.from_numpy(xb).to(dev))
    _log_occupancy(name, grouping)
    return RandomEffectCoordinate(
        name=name, grouping=grouping, x_blocks=x_blocks, label_blocks=lab,
        weight_blocks=wt, mask_blocks=msk, ex_idx=ex_idx, row_idx=row_idx,
        col_idx=col_idx, n_examples=len(labels),
        problem=_problem(objective, config, optimizer))


def build_random_effect_coordinate_sparse(
    name: str,
    dataset: GameDataset,
    feature_shard: str,
    objective: GLMObjective,
    global_dim: int,
    config: OptimizerConfig | None = None,
    optimizer=None,
    bucket_base: int = 4,
    mesh=None,
    device=None,
) -> RandomEffectCoordinate:
    """Sparse shard in a wide global space: each entity's problem is
    solved in its observed-feature subspace (``game.projector``)."""
    from photon_ml_torch.game.projector import build_subspace_projection

    _no_mesh(mesh)
    dev = resolve_device(device)
    grouping = group_by_entity(dataset.entity_ids[name],
                               bucket_base=bucket_base)
    projection, x_blocks_np = build_subspace_projection(
        grouping, dataset.features[feature_shard], global_dim)
    labels = dataset.labels.astype(np.float32)
    lab, wt, msk = _scalar_blocks(grouping, labels, dataset.weight_array(),
                                  dev)
    ex_idx, row_idx, col_idx = _index_maps(grouping, dev)
    _log_occupancy(name, grouping)
    return RandomEffectCoordinate(
        name=name, grouping=grouping,
        x_blocks=[torch.from_numpy(xb).to(dev) for xb in x_blocks_np],
        label_blocks=lab, weight_blocks=wt, mask_blocks=msk, ex_idx=ex_idx,
        row_idx=row_idx, col_idx=col_idx, n_examples=len(labels),
        problem=_problem(objective, config, optimizer),
        projection=projection)


def build_streamed_random_effect_coordinate(*args, **kwargs):
    """Out-of-core random effects: ROADMAP A5b."""
    raise NotImplementedError(
        "streamed random-effect training is not ported yet (ROADMAP A5b)")

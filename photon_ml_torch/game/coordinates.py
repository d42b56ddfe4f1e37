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
- ``StreamedRandomEffectCoordinate``: the random effect's entity blocks
  spilled to a chunk store one fixed-shape entity chunk at a time and
  streamed through the prefetch pipeline, a lane-batched solve a chunk,
  with converged entities retired between sweeps.

``train_swept`` trains a whole λ grid as one lane-batched solve over
the shared batch (``optim.lbfgs.lbfgs_solve_swept``, or its streamed
counterpart).  The mesh variants are ROADMAP A7 and raise
``NotImplementedError``.
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

    def retire_converged(self) -> int | None:
        """Commit this sweep's converged-entity retirement (the hook the
        coordinate-descent loop calls after each update).  None: no
        retirement protocol; the streamed random effect returns the
        number of newly retired entities."""
        return None


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


# -- the streamed random effect --------------------------------------------


def _re_chunk_train(problem: OptimizationProblem, dev: dict):
    """One entity chunk's lane-batched solve: (w [C, p], scores [C, cap]
    at w, per-lane max |w − w0|, converged [C], iterations [C]).  The
    scores come out of the same placed chunk, so a sweep never pays a
    second scoring pass over the store."""
    batch = DenseBatch(x=dev["x"], labels=dev["labels"],
                       weights=dev["weights"], offsets=dev["offsets"],
                       mask=dev["mask"])
    res = solve_batched(problem, batch, dev["w0"])
    scores = torch.einsum("ecp,ep->ec", dev["x"], res.w)
    dw = (res.w - dev["w0"]).abs().amax(-1)
    return res.w, scores, dw, res.converged, res.iterations


class _Readback:
    """A chunk's solve outputs brought to the host in one copy that does
    not block: a sweep reads chunk j's after chunk j + 1's solve is
    queued.  Every part travels as float32 (coefficients, scores and
    movements are float32; flags and iteration counts are exact)."""

    def __init__(self, parts: list[Tensor]):
        flat = torch.cat([p.reshape(-1).to(torch.float32) for p in parts])
        self.shapes = [tuple(p.shape) for p in parts]
        self.event = None
        if flat.is_cuda:
            self.host = torch.empty(flat.shape, dtype=flat.dtype,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = flat

    def arrays(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        flat, out, at = self.host.numpy(), [], 0
        for shape in self.shapes:
            n = int(np.prod(shape))
            out.append(flat[at:at + n].reshape(shape))
            at += n
        return out


def _entity_example_runs(ex_sorted_b: np.ndarray, starts_b: np.ndarray,
                         ents: np.ndarray):
    """(example ids, chunk rows, within-entity cols) of the entities
    ``ents`` (bucket slots): the maps that move per-example offsets into
    a packed chunk and its scores back out.  ``ex_sorted_b`` orders the
    bucket's examples by (slot, position), so each entity is one run."""
    counts = (starts_b[ents + 1] - starts_b[ents]).astype(np.int64)
    total = int(counts.sum())
    rows = np.repeat(np.arange(len(ents), dtype=np.int64), counts)
    cum = np.cumsum(counts) - counts
    cols = np.arange(total, dtype=np.int64) - np.repeat(cum, counts)
    idx = np.repeat(starts_b[ents], counts) + cols
    return ex_sorted_b[idx], rows, cols


def _example_runs(grouping: EntityGrouping):
    """Per-bucket (ex_sorted, ent_starts) run maps (see
    ``_entity_example_runs``)."""
    ex_sorted, ent_starts = [], []
    for b, ne in enumerate(grouping.n_entities):
        sel = np.flatnonzero(grouping.example_bucket == b)
        order = np.lexsort((grouping.example_col[sel],
                            grouping.example_row[sel]))
        sel = sel[order].astype(np.int64)
        ex_sorted.append(sel)
        counts = np.bincount(grouping.example_row[sel], minlength=ne)
        starts = np.zeros(ne + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        ent_starts.append(starts)
    return ex_sorted, ent_starts


def _host(a) -> np.ndarray:
    """A tensor or array as a float32 host array."""
    if isinstance(a, Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


@dataclasses.dataclass(eq=False)
class StreamedRandomEffectCoordinate(Coordinate):
    """Out-of-core random-effect training: streamed entity-bucket solves
    with converged-entity retirement.

    Each bucket's entities are split into fixed-shape entity chunks
    (``chunk_ents[b]`` a chunk, the last padded with zero-mask lanes),
    spilled through ``data.chunk_store`` (entity-block codec,
    content-keyed, memory-mapped loads, LRU host window, lineage
    rebuild) and streamed chunk by chunk through
    ``optim.streaming.prefetch_stream``: disk read, pinned staging, the
    copy to the card on a copy stream ahead of the chunk's solve.  Only
    the coefficient blocks [E_b, p_b], the per-example run maps and the
    score plane stay resident.

    Retirement: after a sweep, the entities whose coefficients and
    offsets both moved less than the solver tolerance are candidates;
    the coordinate-descent loop commits them (``retire_converged``) and
    later sweeps pack only the active entities.  A retired entity's
    cached scores stay exact (its x and w are unchanged); it wakes when
    its offsets drift past the tolerance since its last solve.
    """

    name: str
    grouping: EntityGrouping
    problem: OptimizationProblem
    store: "object"                  # data.chunk_store.ChunkStore
    chunk_ents: list[int]            # entities a chunk, a bucket
    widths: list[int]                # p_b a bucket
    ex_sorted: list[np.ndarray]      # a bucket: [n_b] example ids
    ent_starts: list[np.ndarray]     # a bucket: [E_b + 1] run starts
    chunk_base: list[int]            # global id of a bucket's first chunk
    n_source_chunks: list[int]       # chunks a bucket
    n_examples: int
    prefetch_depth: int = 2
    # Retire entities whose coefficients and offsets moved less than the
    # solver tolerance in a sweep.
    retirement: bool = True
    projection: "object | None" = None
    device: "object" = None          # default CUDA; "cpu" when asked

    def __post_init__(self):
        from photon_ml_torch.optim.streaming import ArrayPlacer

        self.device = resolve_device(self.device)
        ne = self.grouping.n_entities
        self._w_host = [np.zeros((e, p), np.float32)
                        for e, p in zip(ne, self.widths)]
        self._active = [np.ones(e, bool) for e in ne]
        self._pending = [np.zeros(e, bool) for e in ne]
        self._scores_host = np.zeros(self.n_examples, np.float32)
        self._solved_offsets: np.ndarray | None = None
        self._prev_offsets: np.ndarray | None = None
        # The blocks the last train() returned, held by reference: an
        # id() key could match a recycled address after collection and
        # serve stale cached scores.
        self._last_w_blocks: list | None = None
        self._cached_scores: Tensor | None = None
        self._placer = ArrayPlacer(self.device,
                                   max(self.prefetch_depth, 0) + 2)

    def _is_last_train_output(self, blocks) -> bool:
        return (self._last_w_blocks is not None
                and len(blocks) == len(self._last_w_blocks)
                and all(a is b for a, b in zip(blocks,
                                               self._last_w_blocks)))

    # -- shapes ------------------------------------------------------------

    @property
    def coefficient_shapes(self) -> list[tuple[int, int]]:
        return [(w.shape[0], w.shape[1]) for w in self._w_host]

    def initial_coefficients(self) -> list[Tensor]:
        return [torch.zeros((e, p), dtype=torch.float32, device=self.device)
                for e, p in zip(self.grouping.n_entities, self.widths)]

    @property
    def entities_retired(self) -> int:
        return int(sum((~a).sum() for a in self._active))

    def _to_device(self, a: np.ndarray) -> Tensor:
        """A copy on the device: the host arrays are updated in place by
        later sweeps, and a CPU tensor made from one would follow them."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            copy=True)

    # -- the chunk plan and its stream ---------------------------------------

    def _entity_max(self, b: int, per_example: np.ndarray) -> np.ndarray:
        """Per-entity max of a per-example quantity over bucket b's runs
        ([E_b]; one ``reduceat``)."""
        v = per_example[self.ex_sorted[b]]
        return np.maximum.reduceat(v, self.ent_starts[b][:-1])

    def _specs(self) -> list[tuple[int, np.ndarray]]:
        """This sweep's packed chunks: each bucket's active entities in
        ascending slot order, ``chunk_ents[b]`` a chunk (ascending slots
        keep the source chunks' access sequential)."""
        specs = []
        for b, act in enumerate(self._active):
            C = self.chunk_ents[b]
            sel = np.flatnonzero(act)
            for lo in range(0, len(sel), C):
                specs.append((b, sel[lo:lo + C]))
        return specs

    def _full_specs(self) -> list[tuple[int, np.ndarray]]:
        specs = []
        for b, e in enumerate(self.grouping.n_entities):
            C = self.chunk_ents[b]
            for s in range(self.n_source_chunks[b]):
                lo = s * C
                specs.append((b, np.arange(lo, min(lo + C, e),
                                           dtype=np.int64)))
        return specs

    def _assemble(self, spec, offsets: np.ndarray, with_w0: bool = True,
                  x_only: bool = False) -> dict:
        """The load stage (on the prefetch thread): the source chunks
        from the store window, the active entities' rows gathered into
        one packed chunk, the current offsets scattered into block space
        and the warm-start lanes gathered from the resident blocks.  A
        full, untouched source chunk passes its (memory-mapped) arrays
        straight through.  ``x_only`` skips the scalar planes and the
        offsets (the scoring pass)."""
        b, ents = spec
        C = self.chunk_ents[b]
        cap = self.grouping.capacities[b]
        p = self.widths[b]
        base = self.chunk_base[b]
        src = ents // C
        full = (len(ents) == C and src[0] == src[-1]
                and int(ents[0]) == int(src[0]) * C
                and int(ents[-1]) == int(src[0]) * C + C - 1)
        if full:
            ch = self.store.get(base + int(src[0]))
            x = ch["x"]
            if not x_only:
                lab, wt, mk = ch["labels"], ch["weights"], ch["mask"]
        else:
            x = np.zeros((C, cap, p), np.float32)
            if not x_only:
                lab = np.zeros((C, cap), np.float32)
                wt = np.zeros((C, cap), np.float32)
                mk = np.zeros((C, cap), np.float32)
            for s in np.unique(src):          # ascending: LRU-friendly
                m = src == s
                ch = self.store.get(base + int(s))
                rows_local = (ents[m] - int(s) * C).astype(np.int64)
                dst = np.flatnonzero(m)
                x[dst] = ch["x"][rows_local]
                if not x_only:
                    lab[dst] = ch["labels"][rows_local]
                    wt[dst] = ch["weights"][rows_local]
                    mk[dst] = ch["mask"][rows_local]
        ex, rows, cols = _entity_example_runs(
            self.ex_sorted[b], self.ent_starts[b], ents)
        if x_only:
            arrays = {"x": x}
        else:
            off = np.zeros((C, cap), np.float32)
            off[rows, cols] = offsets[ex]
            arrays = {"x": x, "labels": lab, "weights": wt, "mask": mk,
                      "offsets": off}
        if with_w0:
            w0 = np.zeros((C, p), np.float32)
            w0[: len(ents)] = self._w_host[b][ents]
            arrays["w0"] = w0
        return {"arrays": arrays, "b": b, "ents": ents, "ex": ex,
                "rows": rows, "cols": cols}

    def _place(self, item: dict):
        """The placement stage: the chunk's arrays to the card (pinned
        staging, copy stream, an event); the host maps ride along."""
        return (self._placer.place(item["arrays"]), item["b"], item["ents"],
                item["ex"], item["rows"], item["cols"])

    def _stream(self, specs, offsets: np.ndarray, with_w0: bool = True,
                x_only: bool = False):
        """``(placed tensors, b, ents, ex, rows, cols)`` a spec, in
        order, through the prefetch pipeline; the store is quiesced when
        the generator ends."""
        from photon_ml_torch.optim.streaming import (
            ArrayPlacer,
            prefetch_stream,
        )

        def load(j):
            return self._assemble(specs[j], offsets, with_w0, x_only)

        inner = prefetch_stream(load, self._place, range(len(specs)),
                                self.prefetch_depth, store=self.store,
                                device=self.device)
        try:
            for _, (placed, *maps) in inner:
                yield (ArrayPlacer.handover(placed), *maps)
        finally:
            inner.close()
            self.store.assert_quiesced()

    # -- train -------------------------------------------------------------

    def _adopt_warm_start(self, warm_start) -> None:
        """Foreign warm-start blocks (a saved model, a caller's arrays):
        they overwrite the resident blocks, and the retirement state
        resets (its movement bookkeeping was about other coefficients)."""
        for b, w in enumerate(warm_start):
            wb = _host(w)
            if wb.shape != self._w_host[b].shape:
                raise ValueError(
                    f"warm-start bucket {b} shape {wb.shape} != "
                    f"{self._w_host[b].shape}")
            self._w_host[b] = wb.copy()
        for b in range(len(self._active)):
            self._active[b][:] = True
            self._pending[b][:] = False
        self._solved_offsets = None
        self._prev_offsets = None

    def train(self, offsets, warm_start=None):
        """One streamed sweep over the active entities; scores come out
        of the same chunk solves.  Returns (coefficient blocks on the
        device, a diagnostics dict)."""
        off = _host(offsets)
        if off.shape[0] != self.n_examples:
            raise ValueError(f"offsets length {off.shape[0]} != "
                             f"n {self.n_examples}")
        if warm_start is not None and not self._is_last_train_output(
                list(warm_start)):
            self._adopt_warm_start(warm_start)
        rtol = float(self.problem.config.tolerance)
        woken = 0
        if self._solved_offsets is None:
            self._solved_offsets = off.copy()
        elif self.retirement and self.entities_retired:
            # Wake retired entities whose offsets drifted past the
            # tolerance since their last solve (the O(n) scan runs only
            # while something is retired).
            drift = np.abs(off - self._solved_offsets)
            for b in range(len(self._active)):
                woke = ((~self._active[b])
                        & (self._entity_max(b, drift) >= rtol))
                woken += int(woke.sum())
                self._active[b] |= woke

        specs = self._specs()
        retired_now = self.entities_retired
        ne = self.grouping.n_entities
        solved = [np.zeros(e, bool) for e in ne]
        conv = [np.zeros(e, bool) for e in ne]
        dw = [np.zeros(e, np.float32) for e in ne]
        max_iters = 0

        def collect(rb, b, ents, ex, rows, cols) -> int:
            w, scores, dw_c, conv_c, iters = rb.arrays()
            self._w_host[b][ents] = w
            self._scores_host[ex] = scores[rows, cols]
            dw[b][ents] = dw_c
            conv[b][ents] = conv_c > 0
            solved[b][ents] = True
            return int(iters.max()) if len(ents) else 0

        pending = None
        for dev, b, ents, ex, rows, cols in self._stream(specs, off):
            k = len(ents)
            outs = _re_chunk_train(self.problem, dev)
            ticket = (_Readback([o[:k] for o in outs]), b, ents, ex, rows,
                      cols)
            if pending is not None:
                max_iters = max(max_iters, collect(*pending))
            pending = ticket
            self._solved_offsets[ex] = off[ex]
        if pending is not None:
            max_iters = max(max_iters, collect(*pending))

        # Retirement candidates: solved, converged, and coefficients and
        # offsets both moved less than the tolerance this sweep.  The CD
        # loop commits them (retire_converged), so a direct train()
        # caller sees pure streaming.
        if self.retirement and self._prev_offsets is not None:
            drift_prev = np.abs(off - self._prev_offsets)
            for b in range(len(self._pending)):
                doff = self._entity_max(b, drift_prev)
                self._pending[b] = (solved[b] & conv[b]
                                    & (dw[b] < rtol) & (doff < rtol))
        self._prev_offsets = off.copy()

        from photon_ml_torch.data.chunk_store import release_free_heap

        release_free_heap()   # the sweep's staging churn, not steady RSS
        blocks_out = [self._to_device(w) for w in self._w_host]
        self._last_w_blocks = list(blocks_out)
        self._cached_scores = self._to_device(self._scores_host)
        n_solved = int(sum(m.sum() for m in solved))
        diag = {
            "entities": int(sum(ne)),
            "entities_solved": n_solved,
            "entities_converged": int(sum((m & c).sum()
                                          for m, c in zip(solved, conv))),
            "entities_retired": retired_now,
            "entities_woken": woken,
            "max_solver_iterations": max_iters,
            "chunks_streamed": len(specs),
        }
        return blocks_out, diag

    # -- checkpoint state ----------------------------------------------------

    def runtime_state(self) -> dict:
        """What the retirement machinery carries between sweeps: the
        resident blocks, the active and pending masks, the score plane
        and the offset baselines (the JAX package's tree)."""
        return {
            "w_host": [np.asarray(w) for w in self._w_host],
            "active": [np.asarray(a) for a in self._active],
            "pending": [np.asarray(p) for p in self._pending],
            "scores_host": np.asarray(self._scores_host),
            "solved_offsets": (None if self._solved_offsets is None
                               else np.asarray(self._solved_offsets)),
            "prev_offsets": (None if self._prev_offsets is None
                             else np.asarray(self._prev_offsets)),
        }

    def restore_runtime_state(self, state: dict):
        """Inverse of ``runtime_state``.  Returns (the coefficient blocks,
        the cached score plane): the CD loop installs these very blocks
        as the warm start, so ``train`` keeps the restored retirement
        state instead of resetting it."""
        for b, w in enumerate(state["w_host"]):
            wb = np.asarray(w, np.float32)
            if wb.shape != self._w_host[b].shape:
                raise ValueError(
                    f"checkpoint bucket {b} shape {wb.shape} != "
                    f"{self._w_host[b].shape} (grouping changed; a "
                    "checkpoint only resumes its own dataset/config)")
            self._w_host[b] = wb.copy()
            self._active[b] = np.asarray(state["active"][b], bool).copy()
            self._pending[b] = np.asarray(state["pending"][b],
                                          bool).copy()
        self._scores_host = np.asarray(state["scores_host"],
                                       np.float32).copy()
        self._solved_offsets = (
            None if state.get("solved_offsets") is None
            else np.asarray(state["solved_offsets"], np.float32).copy())
        self._prev_offsets = (
            None if state.get("prev_offsets") is None
            else np.asarray(state["prev_offsets"], np.float32).copy())
        blocks = [self._to_device(w) for w in self._w_host]
        self._last_w_blocks = list(blocks)
        self._cached_scores = self._to_device(self._scores_host)
        return blocks, self._cached_scores

    def retire_converged(self) -> int:
        """Commit this sweep's retirement candidates; the number newly
        retired (0 with retirement off)."""
        if not self.retirement:
            return 0
        newly = 0
        for b in range(len(self._active)):
            pend = self._pending[b] & self._active[b]
            newly += int(pend.sum())
            self._active[b] &= ~pend
            self._pending[b][:] = False
        return newly

    # -- score / export / variances -------------------------------------------

    def score(self, coefficient_blocks: list) -> Tensor:
        """Raw x·w per example: the last train's blocks hit the cached
        plane, zero blocks short-circuit, anything else streams one
        scoring pass over the store."""
        if (self._cached_scores is not None
                and self._is_last_train_output(list(coefficient_blocks))):
            return self._cached_scores
        blocks = [_host(bk) for bk in coefficient_blocks]
        if not any(bk.any() for bk in blocks):
            return torch.zeros(self.n_examples, dtype=torch.float32,
                               device=self.device)
        scores = np.zeros(self.n_examples, np.float32)
        unused = np.zeros(0, np.float32)   # x_only skips the offsets
        for dev, b, ents, ex, rows, cols in self._stream(
                self._full_specs(), unused, with_w0=False, x_only=True):
            w_chunk = np.zeros((self.chunk_ents[b], self.widths[b]),
                               np.float32)
            w_chunk[: len(ents)] = blocks[b][ents]
            blk = torch.einsum("ecp,ep->ec", dev["x"],
                               self._to_device(w_chunk))
            scores[ex] = blk.cpu().numpy()[rows, cols]
        return self._to_device(scores)

    def as_model(self, coefficient_blocks: list) -> RandomEffectModel:
        return RandomEffectModel(coefficient_blocks=coefficient_blocks,
                                 grouping=self.grouping,
                                 feature_shard=self.name,
                                 projection=self.projection)

    def compute_variance_blocks(self, coefficient_blocks: list,
                                offsets) -> list[Tensor]:
        """SIMPLE per-entity variances, one more streamed pass."""
        from photon_ml_torch.optim.variance import simple_variances

        off = _host(offsets)
        blocks = [_host(bk) for bk in coefficient_blocks]
        out = [np.zeros((e, p), np.float32)
               for e, p in zip(self.grouping.n_entities, self.widths)]
        for dev, b, ents, ex, rows, cols in self._stream(
                self._full_specs(), off, with_w0=False):
            w_chunk = np.zeros((self.chunk_ents[b], self.widths[b]),
                               np.float32)
            w_chunk[: len(ents)] = blocks[b][ents]
            batch = DenseBatch(x=dev["x"], labels=dev["labels"],
                               weights=dev["weights"],
                               offsets=dev["offsets"], mask=dev["mask"])
            v = simple_variances(self.problem.objective,
                                 self._to_device(w_chunk), batch)
            out[b][ents] = v[: len(ents)].cpu().numpy()
        return [self._to_device(v) for v in out]


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


def build_streamed_random_effect_coordinate(
    name: str,
    dataset: GameDataset,
    feature_shard: str,
    objective: GLMObjective,
    spill_dir: str,
    chunk_entities: int,
    config: OptimizerConfig | None = None,
    optimizer=None,
    bucket_base: int = 4,
    host_max_resident: int = 2,
    prefetch_depth: int = 2,
    retirement: bool = True,
    mesh=None,
    device=None,
) -> StreamedRandomEffectCoordinate:
    """Out-of-core variant of the builders above: entity blocks are built
    one chunk at a time and spilled straight to the chunk store
    (content-keyed: a spill dir built before, by either package, for the
    same data and configuration is reused), so host memory during the
    build is bounded by a chunk.  Dense shards assemble each chunk from
    the example rows; sparse shards go through the subspace projection,
    whose blocks are spilled and freed (a lineage rebuild re-runs the
    deterministic projection).  ``chunk_entities`` is the budget a
    chunk, balanced over each bucket's chunk count and capped by its
    entity count."""
    from photon_ml_torch.data.chunk_store import (
        ENTITY_CHUNK_CODEC,
        ChunkStore,
        array_content_key,
        release_free_heap,
    )
    from photon_ml_torch.data.sparse_rows import SparseRows

    _no_mesh(mesh)
    if chunk_entities <= 0:
        raise ValueError("chunk_entities must be positive")
    if not spill_dir:
        raise ValueError(
            "streamed random-effect training requires spill_dir (the "
            "chunk store is the architecture, not an option)")
    dev = resolve_device(device)
    feats = dataset.features[feature_shard]
    entity_ids = np.asarray(dataset.entity_ids[name])
    grouping = group_by_entity(entity_ids, bucket_base=bucket_base)
    labels = dataset.labels.astype(np.float32)
    weights = dataset.weight_array()
    # A global chunk size would pad a small bucket's one chunk with dead
    # solve lanes: balance the budget over each bucket's chunks.
    chunk_ents = []
    for e in grouping.n_entities:
        k_b = max(1, -(-e // max(1, int(chunk_entities))))
        chunk_ents.append(-(-e // k_b))
    ex_sorted, ent_starts = _example_runs(grouping)

    sparse = not isinstance(feats, np.ndarray)
    projection = None
    if sparse:
        from photon_ml_torch.game.projector import build_subspace_projection

        if not isinstance(feats, SparseRows):
            feats = SparseRows.from_rows(feats)
        global_dim = dataset.feature_dim(feature_shard)
        projection, x_blocks_np = build_subspace_projection(
            grouping, feats, global_dim)
        widths = [xb.shape[-1] for xb in x_blocks_np]
        # Freed after the spill below; a rebuild re-projects.
        src_holder = {"blocks": x_blocks_np}

        def chunk_x(b, lo, hi):
            if src_holder["blocks"] is None:
                src_holder["blocks"] = build_subspace_projection(
                    grouping, feats, global_dim)[1]
            return src_holder["blocks"][b][lo:hi]

        key_arrays = [np.asarray(feats.indptr), np.asarray(feats.cols),
                      np.asarray(feats.vals, np.float32), labels,
                      weights, entity_ids]
    else:
        x = np.asarray(feats, np.float32)
        widths = [x.shape[1]] * len(grouping.capacities)
        key_arrays = [x, labels, weights, entity_ids]

    n_source_chunks = [-(-e // cb)
                       for e, cb in zip(grouping.n_entities, chunk_ents)]
    chunk_base = ([int(c) for c in np.concatenate(
        [[0], np.cumsum(n_source_chunks)[:-1]])]
        if n_source_chunks else [])
    total_chunks = int(sum(n_source_chunks))

    def locate(gid: int) -> tuple[int, int]:
        for b in range(len(chunk_base) - 1, -1, -1):
            if gid >= chunk_base[b]:
                return b, gid - chunk_base[b]
        raise IndexError(gid)

    def build_chunk(b: int, s: int) -> dict:
        cap, p, C = grouping.capacities[b], widths[b], chunk_ents[b]
        lo = s * C
        hi = min(lo + C, grouping.n_entities[b])
        ents = np.arange(lo, hi, dtype=np.int64)
        ex, rows, cols = _entity_example_runs(ex_sorted[b], ent_starts[b],
                                              ents)
        lb = np.zeros((C, cap), np.float32)
        wt = np.zeros((C, cap), np.float32)
        mk = np.zeros((C, cap), np.float32)
        lb[rows, cols] = labels[ex]
        wt[rows, cols] = weights[ex]
        mk[rows, cols] = 1.0
        xc = np.zeros((C, cap, p), np.float32)
        if sparse:
            xc[: hi - lo] = chunk_x(b, lo, hi)
        else:
            xc[rows, cols] = x[ex]
        return {"x": xc, "labels": lb, "weights": wt, "mask": mk}

    def rebuild(gid: int) -> dict:
        return build_chunk(*locate(gid))

    # The JAX package's key: the same inputs and configuration name the
    # same files in either package.
    key = array_content_key(key_arrays, {
        "kind": "re-sparse" if sparse else "re-dense",
        "chunk_ents": [int(cb) for cb in chunk_ents],
        "bucket_base": int(bucket_base),
        "widths": [int(p) for p in widths],
    })
    store = ChunkStore(spill_dir, key, total_chunks,
                       host_max_resident=host_max_resident,
                       rebuild=rebuild, codec=ENTITY_CHUNK_CODEC)
    missing = [gid for gid in range(total_chunks) if not store.has(gid)]
    for gid in missing:
        # Default admission keeps the first window resident: the first
        # sweep visits chunks in this order.
        store.put(gid, build_chunk(*locate(gid)))
    if sparse:
        src_holder["blocks"] = None
    if missing:
        release_free_heap()
    _log_occupancy(name, grouping)
    logger.info(
        "streamed RE coordinate '%s': %d entity chunks (sizes a bucket "
        "%s; %d built, %d reused; host window %d) spilled to %s",
        name, total_chunks, chunk_ents, len(missing),
        total_chunks - len(missing), store.host_max_resident, spill_dir)
    return StreamedRandomEffectCoordinate(
        name=name, grouping=grouping,
        problem=_problem(objective, config, optimizer), store=store,
        chunk_ents=[int(cb) for cb in chunk_ents],
        widths=[int(p) for p in widths], ex_sorted=ex_sorted,
        ent_starts=ent_starts, chunk_base=chunk_base,
        n_source_chunks=[int(k) for k in n_source_chunks],
        n_examples=len(labels), prefetch_depth=prefetch_depth,
        retirement=retirement, projection=projection, device=dev)

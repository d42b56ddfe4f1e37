"""Model-only scoring plan + bucketed fused dispatch.

Counterpart of ``photon_ml_tpu/serving/engine.py``.  The engine derives
the scoring plan (a ``_CoordSpec`` tuple plus device tables) from the
MODEL alone and builds each micro-batch's chunk from parsed request rows:

- **The program is the scorer's** ``run_chunk``: one call per batch
  sums every coordinate into margins and applies the task mean.  The
  sparse fixed effect runs the hand-written CUDA ``gather_rowsum``.
- **Closed shape set**: batches pad to the configured bucket row
  counts and sparse rows densify to ELL at ``ell_row_capacity``.  The
  intercept is the last coefficient: the ELL gathers over all of ``w``
  (request columns never reach it) and ``w[-1]`` is added as ``.base``.
- **Random effects** gather per-request coefficient rows from the
  mmap'd ``EntityServeStore`` into a per-batch MINI-table ``[R+1, p]``:
  row i serves request-row i and row R is the zero row shared by unseen
  entities and padding, so the device never holds the [E, p] table.
- **Projected random effects** score on the host per batch (the
  transformer's pre-sorted merge-join table) and fold into ``base``
  before the call, exactly as the reference does.

``score_batch`` fires the ``serve.dispatch`` fault seam before the batch
is placed.  Given a batch trace it stamps ``store_lookup`` (the entity
stores' reads), ``assemble`` (the rest of the host staging),
``dispatch`` (the copies to the card and the kernels' launch, which
return before the kernels finish) and ``d2h`` (the one blocking copy
back), with no synchronization between them: on CUDA the kernels'
device time lands in ``d2h``, so ``dispatch`` is not kernel time.
Without a trace it takes no timestamp.

``BadRequest`` marks client errors; the HTTP layer answers 400.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from photon_ml_torch import telemetry
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.device import resolve_device
from photon_ml_torch.estimators.game_transformer import (
    _projected_score_table,
    _score_projected_rows,
)
from photon_ml_torch.estimators.streaming_scorer import _CoordSpec, run_chunk
from photon_ml_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.reliability import faults
from photon_ml_torch.serving.entity_store import EntityServeStore

logger = logging.getLogger(__name__)


class BadRequest(ValueError):
    """A malformed scoring request (client error → HTTP 400)."""


def _parse_sparse(feat, dim: int, cap: int, shard: str
                  ) -> tuple[np.ndarray, np.ndarray]:
    """One row's sparse features → (cols int32, vals float32), from
    either ``{"col": val}`` maps or ``[[col, val], ...]`` pairs."""
    if isinstance(feat, dict):
        items = [(int(c), float(v)) for c, v in feat.items()]
    else:
        try:
            items = [(int(c), float(v)) for c, v in feat]
        except (TypeError, ValueError) as e:
            raise BadRequest(
                f"shard '{shard}': sparse features must be a "
                f"col->value map or [[col, value], ...] pairs ({e})")
    if len(items) > cap:
        raise BadRequest(
            f"shard '{shard}': {len(items)} non-zeros exceeds the "
            f"server's ell_row_capacity={cap}; raise the knob or "
            "split the row")
    cols = np.fromiter((c for c, _ in items), np.int32, len(items))
    vals = np.fromiter((v for _, v in items), np.float32, len(items))
    if len(cols) and (cols.min() < 0 or cols.max() >= dim):
        raise BadRequest(
            f"shard '{shard}': column ids must be in [0, {dim})")
    return cols, vals


def _parse_dense(feat, dim: int, shard: str) -> np.ndarray:
    x = np.asarray(feat, np.float32)
    if x.shape != (dim,):
        raise BadRequest(
            f"shard '{shard}': dense features must be a length-{dim} "
            f"vector, got shape {x.shape}")
    return x


class ParsedRow:
    """One validated request row, ready for batch assembly."""

    __slots__ = ("offset", "sparse", "dense", "ids")

    def __init__(self, offset: float, sparse: dict, dense: dict,
                 ids: dict):
        self.offset = offset
        self.sparse = sparse     # shard -> (cols, vals)
        self.dense = dense       # shard -> [d] float32
        self.ids = ids           # entity key -> int


class ScoringEngine:
    """One model version's request-path scorer on ``device`` (default
    CUDA; ``"cpu"`` only when asked for)."""

    def __init__(self, model: GameModel, task: TaskType, *,
                 version: str = "0", ell_row_capacity: int = 64,
                 dense_feature_shards: tuple = (),
                 spill_dir: str | None = None, entity_chunk: int = 4096,
                 host_max_resident: int = 4, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.task = task
        self.version = str(version)
        self._mean = task.loss.mean
        self.ell_row_capacity = int(ell_row_capacity)

        specs: list[_CoordSpec] = []
        tables: dict = {}
        # Input schema: shard -> ("sparse", dim) | ("dense", dim).
        self._shards: dict[str, tuple[str, int]] = {}
        self._entity_keys: list[str] = []
        self._fixed_sparse: list[tuple[str, str]] = []  # (coord, shard)
        self._fixed_dense: list[tuple[str, str]] = []
        self._re: list[tuple[str, str, str, EntityServeStore]] = []
        self._proj: list[tuple[str, RandomEffectModel, tuple, str, str]] \
            = []
        dense_shards = set(dense_feature_shards)

        def declare(shard: str, form: str, dim: int) -> None:
            prev = self._shards.get(shard)
            if prev is not None and prev != (form, dim):
                raise ValueError(
                    f"feature shard '{shard}' is used as {prev} and as "
                    f"({form}, {dim}) by different coordinates; serving "
                    "needs one form per shard")
            self._shards[shard] = (form, dim)

        def on_device(a) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        for name, comp in model.models.items():
            if isinstance(comp, FixedEffectModel):
                w = np.asarray(comp.coefficients.means, np.float32)
                dim = len(w) - (1 if comp.intercept else 0)
                base = on_device(w[-1] if comp.intercept else 0.0)
                if comp.feature_shard in dense_shards:
                    specs.append(_CoordSpec(name, "fixed_dense"))
                    tables[name] = on_device(w[:-1] if comp.intercept
                                             else w)
                    declare(comp.feature_shard, "dense", dim)
                    self._fixed_dense.append((name, comp.feature_shard))
                else:
                    specs.append(_CoordSpec(name, "fixed_sparse"))
                    tables[name] = on_device(w)
                    declare(comp.feature_shard, "sparse", dim)
                    self._fixed_sparse.append((name, comp.feature_shard))
                tables[name + ".base"] = base
            elif isinstance(comp, RandomEffectModel):
                key = comp.entity_key or name
                self._entity_keys.append(key)
                if comp.projection is not None:
                    declare(comp.feature_shard, "sparse",
                            comp.projection.global_dim)
                    self._proj.append((name, comp,
                                       _projected_score_table(comp),
                                       comp.feature_shard, key))
                    continue
                store = EntityServeStore.build(
                    name, comp, spill_dir, entity_chunk=entity_chunk,
                    host_max_resident=host_max_resident)
                specs.append(_CoordSpec(name, "re"))
                declare(comp.feature_shard, "dense", store.dim)
                self._re.append((name, comp.feature_shard, key, store))
            else:
                raise TypeError(f"unknown component model {type(comp)}")

        self.specs = tuple(specs)
        self._tables = tables          # on the device, model-constant
        self.warmed_buckets: list[int] = []

    # -- request parsing ----------------------------------------------------

    def parse_row(self, row) -> ParsedRow:
        if not isinstance(row, dict):
            raise BadRequest("each row must be a JSON object")
        feats = row.get("features")
        if not isinstance(feats, dict):
            raise BadRequest("each row needs a 'features' object "
                             "(shard -> features)")
        unknown = set(feats) - set(self._shards)
        if unknown:
            raise BadRequest(
                f"unknown feature shard(s) {sorted(unknown)}; the "
                f"model serves {sorted(self._shards)}")
        sparse: dict = {}
        dense: dict = {}
        for shard, (form, dim) in self._shards.items():
            if shard not in feats:
                raise BadRequest(f"row is missing feature shard "
                                 f"'{shard}'")
            if form == "sparse":
                sparse[shard] = _parse_sparse(
                    feats[shard], dim, self.ell_row_capacity, shard)
            else:
                dense[shard] = _parse_dense(feats[shard], dim, shard)
        raw_ids = row.get("ids") or {}
        ids: dict = {}
        for key in self._entity_keys:
            if key not in raw_ids:
                raise BadRequest(f"row is missing entity id '{key}'")
            try:
                ids[key] = int(raw_ids[key])
            except (TypeError, ValueError):
                raise BadRequest(f"entity id '{key}' must be an "
                                 "integer")
        try:
            offset = float(row.get("offset", 0.0))
        except (TypeError, ValueError):
            raise BadRequest("'offset' must be a number")
        return ParsedRow(offset, sparse, dense, ids)

    def parse_rows(self, rows) -> list[ParsedRow]:
        if not isinstance(rows, list) or not rows:
            raise BadRequest("'rows' must be a non-empty list")
        return [self.parse_row(r) for r in rows]

    # -- batch assembly + dispatch ------------------------------------------

    def _zero_rows(self, n: int) -> list[ParsedRow]:
        """Synthetic all-zeros rows (bucket warm-up)."""
        sparse = {s: (np.zeros(0, np.int32), np.zeros(0, np.float32))
                  for s, (f, _) in self._shards.items() if f == "sparse"}
        dense = {s: np.zeros(d, np.float32)
                 for s, (f, d) in self._shards.items() if f == "dense"}
        ids = {k: -1 for k in self._entity_keys}
        return [ParsedRow(0.0, dict(sparse), dict(dense), dict(ids))
                for _ in range(n)]

    def _build_chunk(self, rows: list[ParsedRow], R: int,
                     timings: dict | None = None
                     ) -> tuple[dict, dict, np.ndarray]:
        """(chunk arrays, per-batch tables, degraded [n] bool) for
        ``rows`` padded to ``R``, all host numpy.  ``timings``
        accumulates the entity-store reads' seconds under
        ``"store_lookup"``."""
        n = len(rows)
        k = self.ell_row_capacity
        base = np.zeros(R, np.float32)
        for i, r in enumerate(rows):
            base[i] = r.offset
        chunk: dict = {}
        staged: dict = {}
        for shard, (form, dim) in self._shards.items():
            if form == "sparse":
                cols = np.zeros((R, k), np.int32)
                vals = np.zeros((R, k), np.float32)
                for i, r in enumerate(rows):
                    c, v = r.sparse[shard]
                    cols[i, : len(c)] = c
                    vals[i, : len(v)] = v
                staged[shard] = (cols, vals)
            else:
                x = np.zeros((R, dim), np.float32)
                for i, r in enumerate(rows):
                    x[i] = r.dense[shard]
                staged[shard] = x
        for name, shard in self._fixed_sparse:
            chunk[name + ".cols"], chunk[name + ".vals"] = staged[shard]
        for name, shard in self._fixed_dense:
            chunk[name + ".x"] = staged[shard]
        batch_tables: dict = {}
        degraded = np.zeros(n, bool)
        for name, shard, key, store in self._re:
            ids = np.fromiter((r.ids[key] for r in rows), np.int64, n)
            if timings is None:
                w_rows, _hit, deg = store.lookup(ids)
            else:
                t_l = time.perf_counter()
                w_rows, _hit, deg = store.lookup(ids)
                timings["store_lookup"] = (timings.get("store_lookup", 0.0)
                                           + time.perf_counter() - t_l)
            degraded |= deg
            # Mini-table: row i serves request-row i; row R is the zero
            # row for unseen entities and padding.
            mt = np.zeros((R + 1, store.dim), np.float32)
            mt[:n] = w_rows
            idx = np.full(R, R, np.int64)
            idx[:n] = np.arange(n)
            chunk[name + ".x"] = staged[shard]
            chunk[name + ".idx"] = idx
            batch_tables[name] = mt
        for _name, comp, table, shard, key in self._proj:
            cols = [r.sparse[shard][0] for r in rows]
            vals = [r.sparse[shard][1] for r in rows]
            indptr = np.zeros(n + 1, np.int64)
            np.cumsum([len(c) for c in cols], out=indptr[1:])
            srows = SparseRows.from_flat(
                indptr,
                np.concatenate(cols).astype(np.int64) if n
                else np.zeros(0, np.int64),
                np.concatenate(vals).astype(np.float32) if n
                else np.zeros(0, np.float32))
            ids = np.fromiter((r.ids[key] for r in rows), np.int64, n)
            base[:n] += _score_projected_rows(
                comp, table, comp.grouping.join_ids(ids), srows)
        chunk["base"] = base
        return chunk, batch_tables, degraded

    def score_batch(self, rows: list[ParsedRow], bucket: int, trace=None
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Score ``rows`` padded to ``bucket`` → (margins [n],
        predictions [n], degraded [n] bool) as host numpy: one copy of
        the batch to the device, one ``run_chunk``, one copy back.
        ``trace``: the batch's ``BatchTrace`` (stages in the module
        docstring); None takes no timestamp."""
        n = len(rows)
        if n > bucket:
            raise ValueError(f"{n} rows > bucket {bucket}")
        timings = None if trace is None else {}
        t_a = 0.0 if trace is None else time.perf_counter()
        chunk, batch_tables, degraded = self._build_chunk(rows, bucket,
                                                          timings)
        if trace is not None:
            lookup_s = timings.get("store_lookup", 0.0)
            trace.stamp("store_lookup", lookup_s)
            trace.stamp("assemble", time.perf_counter() - t_a - lookup_s)
        # A failing or wedged dispatch answers the whole batch with an
        # error (the batcher's 500), never a hang.
        faults.fire("serve.dispatch", bucket=bucket)
        t_d = 0.0 if trace is None else time.perf_counter()
        dev = self.device
        buf = {k: torch.from_numpy(v).to(dev) for k, v in chunk.items()}
        tables = self._tables
        if batch_tables:
            tables = {**tables, **{k: torch.from_numpy(v).to(dev)
                                   for k, v in batch_tables.items()}}
        m, p = run_chunk(self.specs, self._mean, tables, buf)
        if trace is not None:
            t_h = time.perf_counter()
            trace.stamp("dispatch", t_h - t_d)
        mp = torch.stack([m[:n], p[:n]]).cpu().numpy()
        if trace is not None:
            trace.stamp("d2h", time.perf_counter() - t_h)
        return mp[0], mp[1], degraded

    def warm(self, buckets: list[int]) -> dict:
        """Run every bucket shape once (kernel build and load, allocator
        warm-up) so the first request pays neither."""
        t0 = time.perf_counter()
        for b in sorted(buckets):
            self.score_batch(self._zero_rows(1), b)
            self.warmed_buckets.append(int(b))
        warm_s = time.perf_counter() - t0
        telemetry.observe("serve.warm_s", warm_s)
        logger.info("scoring engine warmed %d bucket(s) %s in %.2fs on %s",
                    len(self.warmed_buckets), self.warmed_buckets, warm_s,
                    self.device)
        return {"buckets": list(self.warmed_buckets),
                "warm_s": round(warm_s, 3)}

    # -- introspection / retirement -----------------------------------------

    def describe(self) -> dict:
        return {
            "version": self.version,
            "device": str(self.device),
            "coordinates": {s.name: s.kind for s in self.specs}
            | {name: "re_projected" for name, *_ in self._proj},
            "shards": {s: {"form": f, "dim": d}
                       for s, (f, d) in self._shards.items()},
            "entity_keys": list(self._entity_keys),
            "ell_row_capacity": self.ell_row_capacity,
            "buckets": list(self.warmed_buckets),
            "entity_stores": [store.stats() for *_x, store in self._re],
        }

    def close(self) -> None:
        """Retire this engine: drop the entity stores' decoded windows."""
        for *_x, store in self._re:
            store.close()


def dataset_rows(dataset, lo: int, hi: int) -> list[dict]:
    """Dataset rows [lo, hi) → ``/v1/score`` request-row JSON objects.

    ``dataset`` needs ``features`` (shard → dense [n, d] array, or CSR
    rows with ``indptr``/``cols``/``vals``), ``entity_ids`` (key → [n]
    ids) and ``offsets`` ([n] or None) — a GAME dataset of either
    package qualifies.  Test, benchmark and client helper."""
    offsets = getattr(dataset, "offsets", None)
    rows = []
    for i in range(lo, hi):
        feats: dict = {}
        for shard, f in dataset.features.items():
            if isinstance(f, np.ndarray):
                feats[shard] = [float(v) for v in f[i]]
            else:
                s0, s1 = int(f.indptr[i]), int(f.indptr[i + 1])
                feats[shard] = [[int(c), float(v)]
                                for c, v in zip(f.cols[s0:s1],
                                                f.vals[s0:s1])]
        rows.append({
            "features": feats,
            "ids": {k: int(v[i]) for k, v in dataset.entity_ids.items()},
            "offset": 0.0 if offsets is None else float(offsets[i]),
        })
    return rows

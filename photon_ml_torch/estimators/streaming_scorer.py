"""One-pass streamed GAME scoring, and the fused per-chunk program.

Counterpart of ``photon_ml_tpu/estimators/streaming_scorer.py``.  The
dataset is walked once, in chunks of ``chunk_rows`` rows (the tail
padded, so every chunk has one shape), and each chunk goes through one
call of ``run_chunk``, which sums every coordinate's contribution into
margins and applies the task mean:

- ``fixed_sparse``: the ELL gather-contract ``gather_rowsum`` (B1, the
  hand-written CUDA kernel on the GPU) plus the intercept ``.base``;
- ``fixed_dense``: ``x @ w`` plus ``.base`` (a plain product, left to
  ``torch.matmul`` as the JAX package left it to XLA);
- ``re``: the coefficient-row gather-dot ``(x * table[idx]).sum(-1)``,
  plain torch for the same reason.

A projected random effect is scored on the host (the per-entity
subspace merge-join of ``estimators.game_transformer``) and folded into
the chunk's ``base`` plane (offsets plus host scores) before the chunk
is placed, so the card's work stays one fused sum.

``StreamingGameScorer.score`` is the pass:

- chunks are built on the host from the dataset, or with ``spill_dir``
  spilled once to content-keyed ``.npz`` files of ``data.chunk_store``
  (built one at a time) and read back memory-mapped through a window of
  ``host_max_resident`` chunks; the store key and the chunk members are
  the JAX package's, so a spill dir written by either package loads in
  the other;
- ``optim.streaming.prefetch_stream`` loads and places chunks
  ``prefetch_depth`` ahead on a thread (pinned staging, a copy stream
  and an event a chunk, ``ArrayPlacer``); the consumer's stream waits
  on a chunk's event before ``run_chunk`` reads it;
- dispatch backpressure: chunk i-1's work is fenced before chunk i
  dispatches, so the card holds about two chunks' buffers;
- each chunk's margins and predictions come back in one asynchronous
  copy into pinned host memory, drained two chunks behind;
- a writer thread (``_SinkWriter``) feeds the sinks of
  ``io.score_sink``, and the ``evaluation.streaming`` accumulators fold
  the metrics on the consumer's thread.

``GameTransformer.transform`` stays the per-coordinate resident path;
this pass gives its margins up to float summation order.  The serving
engine calls ``run_chunk`` directly.  With telemetry a pass is one
``score_pass`` span, each chunk a ``chunk_compute`` span (and a CUDA
event pair, program ``score_chunk``) and a ``chunk_drain`` span, and the
writer thread's ``sink_write`` spans, heartbeats and death event land in
the run log; each chunk reports the live monitor's ``score`` progress in
rows.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import queue
import threading
import time

import numpy as np
import torch

from photon_ml_torch import telemetry
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.device import resolve_device
from photon_ml_torch.estimators.game_transformer import (
    _np,
    _projected_score_table,
    _score_projected_rows,
)
from photon_ml_torch.game.dataset import GameDataset
from photon_ml_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.ops.kernels import gather_rowsum
from photon_ml_torch.reliability import faults as _faults
from photon_ml_torch.telemetry import device as _device
from photon_ml_torch.telemetry import monitor as _mon

logger = logging.getLogger(__name__)

# On-disk score-chunk format version (part of the store key).
SCORE_CHUNK_VERSION = 1

# Scored chunks in flight (dispatched, copying back) before the oldest
# is drained.
_INFLIGHT = 2


@dataclasses.dataclass(frozen=True)
class _CoordSpec:
    """Static description of one coordinate's scoring."""

    name: str
    kind: str          # "fixed_sparse" | "fixed_dense" | "re"


def run_chunk(specs, mean_fn, tables: dict, chunk: dict
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(margins, predictions) for one chunk: ``chunk["base"]`` plus
    every coordinate of ``specs``; ``tables`` and ``chunk`` are dicts of
    tensors on one device."""
    m = chunk["base"]
    for s in specs:
        if s.kind == "fixed_sparse":
            m = m + gather_rowsum(tables[s.name], chunk[s.name + ".vals"],
                                  chunk[s.name + ".cols"]) \
                + tables[s.name + ".base"]
        elif s.kind == "fixed_dense":
            m = m + chunk[s.name + ".x"] @ tables[s.name] \
                + tables[s.name + ".base"]
        else:
            m = m + (chunk[s.name + ".x"]
                     * tables[s.name][chunk[s.name + ".idx"]]).sum(-1)
    return m, mean_fn(m)


def _score_chunk_cost(chunk: dict, tables: dict, out, device) -> dict:
    """Analytic cost of ``run_chunk`` on one chunk: the chunk's arrays
    and the coefficient tables read once, margins and predictions
    written once; flops: a multiply-add a stored slot of every sparse
    or dense feature plane (B1 over ``.vals``, the dots over ``.x``)."""
    flops = sum(2.0 * v.numel() for k, v in chunk.items()
                if k.endswith((".vals", ".x")))
    return _device.program_cost(
        list(chunk.values()) + list(tables.values()),
        _device.tensor_bytes([out]), flops, device)


class _SinkWriter:
    """Writer thread: drains finished host chunks into the sinks, in
    queue order, while the card scores later chunks.  A failed write is
    handed to the producer under a lock (``put`` raises it mid-stream,
    ``close`` at the end), and every sink is aborted at once so no torn
    container is left on disk."""

    _SENTINEL = object()

    def __init__(self, sinks):
        self._sinks = list(sinks)
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._lock = threading.Lock()
        self._error: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="photon-score-writer")
        self._thread.start()

    def _failed(self) -> BaseException | None:
        with self._lock:
            return self._error

    def _next_item(self):
        """The next queued item.  close() always enqueues the sentinel,
        from the thread that puts, so the wait ends with the pass; with
        telemetry, heartbeats flow while starved."""
        t = telemetry.active()
        start = beat = time.perf_counter()
        while True:
            try:
                return self._q.get(timeout=0.05)
            except queue.Empty:
                if t is None:
                    continue
                now = time.perf_counter()
                if now - beat >= t.heartbeat_s:
                    t.heartbeat("sink-writer", state="queue_empty",
                                waiting_s=round(now - start, 3))
                    beat = now

    def _run(self) -> None:
        while True:
            item = self._next_item()
            if item is self._SENTINEL:
                return
            if self._failed() is not None:
                continue       # drain without writing after a failure
            try:
                lo, hi, margins, preds, labels, ids = item
                t0 = time.perf_counter()
                with telemetry.span("sink_write", cat="sink", lo=lo,
                                    hi=hi):
                    _faults.fire("sink.write", lo=lo, hi=hi)
                    for s in self._sinks:
                        s.write(lo, hi, margins, preds, labels, ids=ids)
                telemetry.observe("sink.write_s", time.perf_counter() - t0)
            except BaseException as e:
                # The death event first, then the locked hand-off the
                # producer reads in put().
                telemetry.thread_exception("sink-writer", e)
                with self._lock:
                    self._error = e
                for s in self._sinks:
                    try:
                        s.abort()
                    except Exception:  # photon-lint: disable=swallowed-exception (cleanup of an already-failed sink; the first error is recorded above)
                        pass

    def put(self, lo, hi, margins, preds, labels, ids) -> None:
        err = self._failed()
        if err is not None:
            raise err
        telemetry.gauge("sink.queue_depth", self._q.qsize())
        self._q.put((lo, hi, margins, preds, labels, ids))

    def close(self) -> None:
        self._q.put(self._SENTINEL)
        # Bounded: a sink wedged in a filesystem write becomes an error.
        self._thread.join(timeout=600.0)
        if self._thread.is_alive():
            raise RuntimeError(
                "score sink writer did not drain within 600s (sink "
                "write wedged); output containers may be incomplete")
        err = self._failed()
        if err is not None:
            raise err


def _fingerprint_arrays(parts, extra: str = "") -> str:
    """blake2b content key over a sequence of arrays and a config tag,
    hashed through the buffer protocol (no ``tobytes`` copy)."""
    h = hashlib.blake2b(digest_size=16)
    for a in parts:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(memoryview(a).cast("B"))
    h.update(extra.encode())
    return h.hexdigest()


class StreamingGameScorer:
    """One-pass fused scoring of a ``GameDataset`` with a ``GameModel``
    on ``device`` (default CUDA; ``"cpu"`` runs the plain versions).

    ``chunk_rows`` fixes the chunk grid.  ``spill_dir`` (None: chunks are
    built on the fly each pass) spills the prepared chunks once, one at
    a time, to content-keyed ``.npz`` files that later passes read back
    through an LRU window of ``host_max_resident`` chunks.
    ``prefetch_depth`` > 0 loads and places chunks on a thread that
    many ahead, with or without a store.
    """

    def __init__(self, model: GameModel, task: TaskType,
                 chunk_rows: int = 1 << 20,
                 spill_dir: str | None = None,
                 host_max_resident: int = 2,
                 prefetch_depth: int = 2,
                 device: str | None = None):
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        self.model = model
        self.task = task
        self.chunk_rows = int(chunk_rows)
        self.spill_dir = spill_dir
        self.host_max_resident = int(host_max_resident)
        self.prefetch_depth = int(prefetch_depth)
        self.device = resolve_device(device)
        # The plan of the last dataset scored, keyed by the dataset
        # object (a strong reference: a dataset changed in place needs a
        # new scorer), and the store key of that plan.
        self._plan_memo: tuple | None = None
        self._key_memo: tuple | None = None
        # The last pass's store (None without one), for callers that
        # inspect its files and readers.
        self.store = None

    # -- plan ---------------------------------------------------------------

    def _table(self, a) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(a, np.float32)).to(self.device)

    def _plan(self, dataset: GameDataset):
        """Classify the coordinates, join entities, place the tables and
        return (specs, tables, build_chunk, key_parts)."""
        n = dataset.n
        R = self.chunk_rows
        specs: list[_CoordSpec] = []
        tables: dict = {}
        builders: dict = {}    # name -> per-chunk host-array builder
        host_parts: list = []  # (model, table, idx, rows) projected REs
        key_parts: list = [dataset.offset_array()]
        key_cfg: list = [f"v{SCORE_CHUNK_VERSION}", f"R{R}"]

        for name, comp in self.model.models.items():
            if isinstance(comp, FixedEffectModel):
                feats = dataset.features[comp.feature_shard]
                w_np = _np(comp.coefficients.means).astype(np.float32)
                base = np.float32(w_np[-1] if comp.intercept else 0.0)
                tables[name + ".base"] = torch.tensor(
                    base, dtype=torch.float32, device=self.device)
                if isinstance(feats, np.ndarray):
                    x_all = np.asarray(feats, np.float32)
                    specs.append(_CoordSpec(name, "fixed_dense"))
                    tables[name] = self._table(
                        w_np[:-1] if comp.intercept else w_np)

                    def build_dense(lo, hi, x_all=x_all):
                        x = x_all[lo:hi]
                        if hi - lo < R:
                            x = np.pad(x, ((0, R - (hi - lo)), (0, 0)))
                        return {".x": np.ascontiguousarray(x)}

                    builders[name] = build_dense
                    key_parts.append(x_all)
                    key_cfg.append(f"{name}:dense:{comp.intercept}")
                else:
                    rows = feats if isinstance(feats, SparseRows) else \
                        SparseRows.from_rows(feats)
                    k = max(rows.max_nnz, 1)
                    specs.append(_CoordSpec(name, "fixed_sparse"))
                    tables[name] = self._table(w_np)

                    def build_sparse(lo, hi, rows=rows, k=k):
                        cols, vals = rows[lo:hi].to_ell(
                            row_capacity=k, pad_to=R)
                        return {".cols": cols, ".vals": vals}

                    builders[name] = build_sparse
                    key_parts.extend([rows.indptr, rows.cols, rows.vals])
                    key_cfg.append(f"{name}:sparse:k{k}:{comp.intercept}")
            elif isinstance(comp, RandomEffectModel):
                ids = dataset.entity_ids[comp.entity_key or name]
                idx = comp.grouping.join_ids(ids)
                feats = dataset.features[comp.feature_shard]
                if comp.projection is not None:
                    # Scored on the host, a chunk at a time, into base.
                    rows = feats if isinstance(feats, SparseRows) else \
                        SparseRows.from_rows(feats)
                    table = _projected_score_table(comp)
                    host_parts.append((comp, table, idx, rows))
                    key_parts.extend([rows.indptr, rows.cols, rows.vals,
                                      idx, table[0], table[1]])
                    key_cfg.append(f"{name}:proj")
                    continue
                w_all = _np(comp.all_coefficients()).astype(np.float32)
                E, d_re = w_all.shape
                w_pad = np.vstack([w_all, np.zeros((1, d_re), np.float32)])
                specs.append(_CoordSpec(name, "re"))
                tables[name] = self._table(w_pad)
                idx32 = np.where(idx < 0, E, idx).astype(np.int32)

                def build_re(lo, hi, feats=feats, idx32=idx32, E=E,
                             d_re=d_re):
                    if isinstance(feats, SparseRows):
                        x = feats[lo:hi].to_dense(d_re)
                    else:
                        x = np.asarray(feats[lo:hi], np.float32)
                    if hi - lo < R:
                        x = np.pad(x, ((0, R - (hi - lo)), (0, 0)))
                    ix = np.full(R, E, np.int32)
                    ix[: hi - lo] = idx32[lo:hi]
                    return {".x": np.ascontiguousarray(x), ".idx": ix}

                builders[name] = build_re
                if isinstance(feats, SparseRows):
                    key_parts.extend([feats.indptr, feats.cols,
                                      feats.vals])
                else:
                    key_parts.append(np.asarray(feats, np.float32))
                key_parts.append(idx32)
                key_cfg.append(f"{name}:re:d{d_re}")
            else:
                raise TypeError(f"unknown component model {type(comp)}")

        offsets = dataset.offset_array()

        def build_chunk(i: int) -> dict:
            lo = i * R
            hi = min(lo + R, n)
            base = np.zeros(R, np.float32)
            base[: hi - lo] = offsets[lo:hi]
            for comp, table, idx, rows in host_parts:
                base[: hi - lo] += _score_projected_rows(
                    comp, table, idx[lo:hi], rows[lo:hi])
            chunk = {"base": base}
            for name, build in builders.items():
                for suffix, arr in build(lo, hi).items():
                    chunk[name + suffix] = arr
            return chunk

        return tuple(specs), tables, build_chunk, (key_parts, key_cfg)

    def _make_program(self, specs):
        mean = self.task.loss.mean

        def run(tables, chunk):
            return run_chunk(specs, mean, tables, chunk)

        return run

    def _store_key(self, key_parts) -> str:
        """The spill store's content key, memoized with the plan."""
        if self._key_memo is None or self._key_memo[0] is not key_parts:
            parts, cfg = key_parts
            self._key_memo = (
                key_parts,
                "score-" + _fingerprint_arrays(parts, "|".join(cfg)))
        return self._key_memo[1]

    def _make_store(self, n_chunks: int, key_parts, build_chunk):
        from photon_ml_torch.data.chunk_store import (
            ChunkStore,
            decode_array_chunk,
            encode_array_chunk,
            release_free_heap,
        )

        key = self._store_key(key_parts)
        store = ChunkStore(
            self.spill_dir, key, n_chunks,
            host_max_resident=self.host_max_resident,
            rebuild=build_chunk,
            codec=(encode_array_chunk, decode_array_chunk))
        missing = [i for i in range(n_chunks) if not store.has(i)]
        for i in missing:        # one chunk in flight: bounded host memory
            store.put(i, build_chunk(i))
        if missing:
            release_free_heap()
        logger.info(
            "score chunks: %d spilled to %s (%d built, %d reused; "
            "host window %d)", n_chunks, self.spill_dir, len(missing),
            n_chunks - len(missing), store.host_max_resident)
        return store

    # -- the pass -----------------------------------------------------------

    def _placed_chunks(self, n_chunks: int, load, store):
        """Chunks on the card in order, each usable on the current
        stream, through the prefetch pipeline."""
        from photon_ml_torch.optim.streaming import (
            ArrayPlacer,
            prefetch_stream,
        )

        placer = ArrayPlacer(self.device, max(self.prefetch_depth, 0) + 2)
        inner = prefetch_stream(load, placer.place, range(n_chunks),
                                self.prefetch_depth, store=store,
                                device=self.device)
        try:
            for _, placed in inner:
                yield ArrayPlacer.handover(placed)
        finally:
            inner.close()
            placer.quiesce()

    def score(self, dataset: GameDataset, sinks=(), evaluators=(),
              keep_margins: bool = False) -> dict:
        """One fused pass.  ``sinks``: ``io.score_sink`` writers, drained
        by a thread.  ``evaluators``: ``evaluation.streaming`` adapters,
        updated in chunk order.  ``keep_margins`` also returns the whole
        ``margins`` and ``predictions`` (tests and small runs)."""
        from photon_ml_torch.data.chunk_store import probe_spill_dir

        n = dataset.n
        R = self.chunk_rows
        n_chunks = max(1, -(-n // R))
        if (self._plan_memo is not None
                and self._plan_memo[0] is dataset):
            specs, tables, build_chunk, key_parts = self._plan_memo[1]
        else:
            planned = self._plan(dataset)
            self._plan_memo = (dataset, planned)
            specs, tables, build_chunk, key_parts = planned
        run = self._make_program(specs)

        # An unwritable spill dir degrades, with one warning, to chunks
        # built on the fly: the disk tier is never needed for a result.
        store = None
        if probe_spill_dir(self.spill_dir) is not None:
            store = self._make_store(n_chunks, key_parts, build_chunk)
            load = store.get
        else:
            load = build_chunk
        self.store = store

        labels = dataset.labels
        # Only evaluators read weights.
        weights = dataset.weight_array() if evaluators else None
        entity_cols = dataset.entity_ids
        cuda = self.device.type == "cuda"

        margins_out = np.empty(n, np.float32) if keep_margins else None
        preds_out = np.empty(n, np.float32) if keep_margins else None
        writer = _SinkWriter(sinks) if sinks else None
        evaluators = list(evaluators)

        def drain(item) -> None:
            i, host, done = item
            lo = i * R
            hi = min(lo + R, n)
            t_drain = time.perf_counter()
            with telemetry.span("chunk_drain", cat="score", chunk=i):
                if done is not None:
                    done.synchronize()
                out = host.numpy()
                m, p = out[0, : hi - lo], out[1, : hi - lo]
                lab = labels[lo:hi]
                for ev in evaluators:
                    ev.update(m, p, lab, weights[lo:hi])
                if writer is not None:
                    writer.put(lo, hi, m, p, lab,
                               {k: v[lo:hi]
                                for k, v in entity_cols.items()})
                if keep_margins:
                    margins_out[lo:hi] = m
                    preds_out[lo:hi] = p
            telemetry.observe("score.chunk_drain_s",
                              time.perf_counter() - t_drain)

        t0 = time.perf_counter()
        pending: list = []
        chunks = self._placed_chunks(n_chunks, load, store)
        try:
            with telemetry.span("score_pass", cat="score",
                                chunks=n_chunks):
                telemetry.count("score.passes")
                for i, buf in enumerate(chunks):
                    with telemetry.span("chunk_compute", cat="device"):
                        if pending and pending[-1][2] is not None:
                            # Backpressure: chunk i-1's work ends before
                            # chunk i dispatches, so about two chunks'
                            # buffers are live.
                            pending[-1][2].synchronize()
                        with telemetry.device_timed("score_chunk",
                                                    self.device):
                            m, p = run(tables, buf)
                            both = torch.stack((m, p))
                        _device.maybe_capture(
                            "score_chunk",
                            lambda: _score_chunk_cost(buf, tables, both,
                                                      self.device),
                            span="chunk_compute")
                        if cuda:
                            # One copy back a chunk, into pinned memory.
                            host = torch.empty(both.shape,
                                               dtype=both.dtype,
                                               pin_memory=True)
                            host.copy_(both, non_blocking=True)
                            done = torch.cuda.Event()
                            done.record()
                        else:
                            host, done = both, None
                    del buf
                    pending.append((i, host, done))
                    # In rows, so the monitor's rolling rate is rows/s.
                    _mon.progress("score", min((i + 1) * R, n), n,
                                  unit="rows")
                    if len(pending) > _INFLIGHT:
                        drain(pending.pop(0))
                chunks.close()
                for item in pending:
                    drain(item)
                if writer is not None:
                    w, writer = writer, None
                    w.close()
                for s in sinks:
                    s.close()
        except BaseException:
            chunks.close()
            if writer is not None:
                try:
                    writer.close()
                except Exception:  # photon-lint: disable=swallowed-exception (error-path cleanup; the pass's own error re-raises below)
                    pass
            for s in sinks:
                try:
                    s.abort()
                except Exception:  # photon-lint: disable=swallowed-exception (error-path cleanup; the pass's own error re-raises below)
                    pass
            raise
        wall_s = time.perf_counter() - t0

        result = {
            "n": int(n),
            "n_chunks": int(n_chunks),
            "chunk_rows": int(R),
            "wall_s": wall_s,
            "rows_per_sec": (n / wall_s) if wall_s > 0 else None,
            "evaluation": {ev.type.value: ev.result()
                           for ev in evaluators},
        }
        if store is not None:
            result["store"] = {
                "loads": store.loads, "hits": store.hits,
                "spills": store.spills,
                "peak_resident": store.peak_resident,
            }
        if keep_margins:
            result["margins"] = margins_out
            result["predictions"] = preds_out
        return result

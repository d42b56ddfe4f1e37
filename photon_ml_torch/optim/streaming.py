"""Streaming (chunk-accumulated) objective and host-driven solvers.

Counterpart of ``photon_ml_tpu/optim/streaming.py``.  The chunks of a
``data.chunked_batch.ChunkedBatch`` stream through the card on every
objective evaluation; each chunk's partial (value, gradient,
Hessian-vector product, Hessian diagonal) comes from ``GLMObjective``
on the placed chunk, so ``X·w`` runs the ``gather_rowsum`` kernel (B1)
and ``X·Wᵀ`` over λ-lanes ``gather_rowsum_lanes``.  Regularization and
the Gaussian prior are example-independent and added once, after the
chunk loop.

The path from disk to the card, for a spilled batch:

- ``ChunkPrefetcher``: one thread walks the sweep's chunk order ahead
  of the consumer, ``prefetch_depth`` chunks deep: disk read (the
  store's memory-mapped window), then the copy to the card.
- ``_Stager`` (CUDA): a ring of pinned host buffers, one set of leaves
  a slot (the chunks are congruent, so the shapes are fixed).  The
  prefetch thread fills a slot with a chunk's leaves (a leaf that is a
  whole memory-mapped member of a spill file is read from the file by
  positioned reads on a pool of threads; others are copied), then
  issues ``non_blocking`` copies to the card on a dedicated copy
  stream, into tensors allocated on that stream, and records an event.
  A slot is refilled only after its copy's event has completed.
- The hand-over: the consumer makes the current stream (the one B1
  launches on) wait on the chunk's event and marks every placed tensor
  with ``record_stream``, so the caching allocator never reuses one
  under a running kernel.
- The backpressure fence: on the spilled path, chunk i-1's accumulate
  is fenced (an event synchronize) before chunk i dispatches, so the
  queued work holds one chunk's buffers, not all K.
- ``invalidate`` closes the prefetcher, asserts the store is quiesced
  and waits for the copies still in flight, so no buffer is freed
  under a reader or a copy.
- ``ArrayPlacer``: the same staging for chunks that are dicts of
  arrays (the streamed random effect's entity chunks, the fused cycle's
  chunk-and-sidecar pairs), through ``prefetch_stream``.

A failed copy, a dead prefetch thread or a CUDA error raises on the
consumer's thread; nothing carries on synchronously or on the CPU.

The solvers are the reference's host-driven loops: L-BFGS / OWL-QN,
TRON with Steihaug CG, and batched λ-lane L-BFGS, each with mid-solve
snapshots and resume through ``reliability.checkpoint`` (same state
trees and fingerprints as the reference, so a snapshot resumes in
either package).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import mmap
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from photon_ml_torch.data.batch import SparseBatch
from photon_ml_torch.device import resolve_device
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import (
    RegularizationContext,
    SweptRegularization,
)
from photon_ml_torch.optim.base import (
    OptimizationResult,
    OptimizerConfig,
    StatesTracker,
    grad_converged,
    loss_converged,
)
from photon_ml_torch.optim.lbfgs import _pseudo_gradient
from photon_ml_torch.optim.tron import (
    _DELTA_MIN,
    _ETA0,
    _SIGMA1,
    _SIGMA3,
    _boundary_tau,
)
from photon_ml_torch.reliability import checkpoint as _ckpt
from photon_ml_torch.reliability import faults as _faults

logger = logging.getLogger(__name__)

Tensor = torch.Tensor

_CURVATURE_EPS = 1e-10

# Consumer-side stall deadline (seconds): a wedged disk becomes one
# actionable error after this long, never an eternal wait.
DEFAULT_STALL_TIMEOUT_S = 600.0

# The leaves a chunk moves to the card.
_LEAVES = ("values", "col_ids", "labels", "weights", "offsets", "mask")

# Positioned reads of a spilled leaf into staging, in parts of this many
# bytes, on a pool shared by every stager.
_READ_PART_BYTES = 4 << 20
_READ_POOL: ThreadPoolExecutor | None = None
_READ_POOL_LOCK = threading.Lock()


def _read_pool() -> ThreadPoolExecutor:
    global _READ_POOL
    with _READ_POOL_LOCK:
        if _READ_POOL is None:
            _READ_POOL = ThreadPoolExecutor(
                max_workers=os.cpu_count() or 4,
                thread_name_prefix="photon-chunk-read")
        return _READ_POOL


def _file_member(a) -> bool:
    """Whether ``a`` is a whole memory-mapped member of a spill file
    (its own mapping, so its ``filename`` and ``offset`` locate it)."""
    return (isinstance(a, np.memmap) and isinstance(a.base, mmap.mmap)
            and a.filename is not None and a.flags.c_contiguous)


def _read_members(reads: list) -> None:
    """Fill staging views from spill files: ``reads`` holds (view,
    filename, offset); each view is read in parts, the parts in
    parallel.  A short read raises."""
    fds: dict = {}
    jobs = []
    try:
        for view, filename, offset in reads:
            if filename not in fds:
                fds[filename] = os.open(filename, os.O_RDONLY)
            mv = memoryview(view).cast("B")
            for lo in range(0, len(mv), _READ_PART_BYTES):
                part = mv[lo:lo + _READ_PART_BYTES]
                jobs.append((len(part), _read_pool().submit(
                    os.preadv, fds[filename], [part], offset + lo)))
        for want, job in jobs:
            got = job.result()
            if got != want:
                raise OSError(f"short read from a spill file: {got} of "
                              f"{want} bytes")
    finally:
        for job in (j for _, j in jobs):
            job.exception()   # every read done before the fds close
        for fd in fds.values():
            os.close(fd)


# ---------------------------------------------------------------------------
# Placement: host chunk → card
# ---------------------------------------------------------------------------


class _Placed:
    """A placed chunk and the event its copies completed on (None on the
    CPU)."""

    __slots__ = ("batch", "event", "nbytes")

    def __init__(self, batch, event, nbytes: int):
        self.batch = batch
        self.event = event
        self.nbytes = nbytes


class _Slot:
    __slots__ = ("pinned", "views", "event")

    def __init__(self, leaves: dict):
        self.pinned = {}
        self.views = {}
        for name, a in leaves.items():
            a = np.asarray(a)
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            t = torch.empty(a.shape, dtype=dtype, pin_memory=True)
            self.pinned[name] = t
            self.views[name] = t.numpy()
        self.event = None

    def fits(self, leaves: dict) -> bool:
        return (self.views.keys() == leaves.keys()
                and all(self.views[k].shape == np.shape(a)
                        and self.views[k].dtype == np.asarray(a).dtype
                        for k, a in leaves.items()))


class _Stager:
    """Pinned host staging ring and copy stream for one device."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self._slots: list = [None] * max(2, int(slots))
        self._next = 0

    def place_arrays(self, leaves: dict) -> _Placed:
        """Name → host array → name → card tensor, copied through the
        next pinned slot on the copy stream; ``batch`` of the result is
        the dict of placed tensors."""
        k = self._next
        self._next = (k + 1) % len(self._slots)
        slot = self._slots[k]
        if slot is None or not slot.fits(leaves):
            if slot is not None and slot.event is not None:
                slot.event.synchronize()
            slot = self._slots[k] = _Slot(leaves)
        elif slot.event is not None:
            # The slot's previous copy must have finished reading it.
            slot.event.synchronize()
        nbytes = 0
        reads = []
        for name, a in leaves.items():
            if _file_member(a):
                reads.append((slot.views[name], a.filename, a.offset))
            elif np.asarray(a).flags.writeable:
                # torch's copy runs on its intra-op threads.
                slot.pinned[name].copy_(torch.from_numpy(np.asarray(a)))
            else:
                np.copyto(slot.views[name], np.asarray(a), casting="no")
            nbytes += a.nbytes
        _read_members(reads)
        placed = {}
        with torch.cuda.stream(self.stream):
            for name in leaves:
                pin = slot.pinned[name]
                dev = torch.empty(pin.shape, dtype=pin.dtype,
                                  device=self.device)
                dev.copy_(pin, non_blocking=True)
                placed[name] = dev
            event = torch.cuda.Event()
            event.record(self.stream)
        slot.event = event
        return _Placed(placed, event, nbytes)

    def place(self, host: SparseBatch) -> _Placed:
        p = self.place_arrays({leaf: getattr(host, leaf)
                               for leaf in _LEAVES})
        p.batch = dataclasses.replace(host, grr=None, colmajor=None,
                                      **p.batch)
        return p

    def quiesce(self) -> None:
        """Wait for every copy still in flight."""
        for slot in self._slots:
            if slot is not None and slot.event is not None:
                slot.event.synchronize()


def _place_cpu_arrays(leaves: dict) -> _Placed:
    placed = {name: torch.from_numpy(np.array(a))
              for name, a in leaves.items()}
    nbytes = sum(t.numel() * t.element_size() for t in placed.values())
    return _Placed(placed, None, nbytes)


def _place_cpu(host: SparseBatch) -> _Placed:
    p = _place_cpu_arrays({leaf: getattr(host, leaf) for leaf in _LEAVES})
    p.batch = dataclasses.replace(host, grr=None, colmajor=None, **p.batch)
    return p


def _handover(placed: _Placed) -> SparseBatch:
    """The consumer's side: the current stream waits for the chunk's
    copies, and the placed tensors are marked as used on it."""
    if placed.event is not None:
        stream = torch.cuda.current_stream(placed.batch.labels.device)
        stream.wait_event(placed.event)
        for leaf in _LEAVES:
            getattr(placed.batch, leaf).record_stream(stream)
    return placed.batch


class ArrayPlacer:
    """Host array dicts → tensors on ``device``: on CUDA through a
    ``_Stager`` ring (pinned slots, a copy stream, an event a chunk), on
    the CPU by a copy.  ``place`` runs on the prefetch thread, ``handover``
    on the consumer's; ``quiesce`` waits for the copies still in flight
    (before the host arrays may be freed).  The streamed random effect's
    entity chunks and the fused cycle's chunk pairs take this path."""

    def __init__(self, device, slots: int):
        self.device = resolve_device(device)
        self._slots = slots
        self._stager: _Stager | None = None
        self.placed_bytes = 0
        self.placed_chunks = 0

    def place(self, leaves: dict) -> _Placed:
        if self.device.type != "cuda":
            placed = _place_cpu_arrays(leaves)
        else:
            if self._stager is None:
                self._stager = _Stager(self.device, self._slots)
            placed = self._stager.place_arrays(leaves)
        self.placed_bytes += placed.nbytes
        self.placed_chunks += 1
        return placed

    @staticmethod
    def handover(placed: _Placed) -> dict:
        """The placed tensors, usable on the current stream."""
        if placed.event is not None:
            stream = torch.cuda.current_stream(
                next(iter(placed.batch.values())).device)
            stream.wait_event(placed.event)
            for t in placed.batch.values():
                t.record_stream(stream)
        return placed.batch

    def quiesce(self) -> None:
        if self._stager is not None:
            self._stager.quiesce()


# ---------------------------------------------------------------------------
# The prefetch pipeline
# ---------------------------------------------------------------------------


class ChunkPrefetcher:
    """Background disk → host → card pipeline stage.

    One thread walks the sweep's chunk order: ``load(i)`` pulls the host
    chunk (the store's disk read or window hit), ``place`` starts its
    copy to the card, and the result lands in a bounded queue of depth
    ``depth``.  ``next(expect)`` asserts the order, so the chunk visit
    order (and the float-sum order) is the resident path's.  The thread
    registers as a store reader (``ChunkStore.assert_quiesced``), sets
    its CUDA device when ``device`` is one, and delivers its error
    in-band: ``next`` raises it.  ``wait_s`` is the consumer's total
    wait.
    """

    _SENTINEL = object()

    def __init__(self, load, place, depth: int, store=None,
                 stall_timeout_s: float | None = None, device=None):
        self._load = load
        self._place = place
        self._store = store
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.stall_timeout_s = (DEFAULT_STALL_TIMEOUT_S
                                if stall_timeout_s is None
                                else float(stall_timeout_s))
        self._cuda_index = None
        if device is not None and torch.device(device).type == "cuda":
            dev = torch.device(device)
            self._cuda_index = (dev.index if dev.index is not None
                                else torch.cuda.current_device())
        # The consumer's wait, and the producer's time in ``load`` and in
        # ``place`` (read once the thread is joined).
        self.wait_s = self.load_s = self.place_s = 0.0

    def start(self, order) -> None:
        if self._store is not None:
            self._store.begin_read()
        self._thread = threading.Thread(
            target=self._run, args=(list(order),), daemon=True,
            name="photon-chunk-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:  # the loop re-checks the stop flag
                continue
        return False

    def _run(self, order) -> None:
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            for i in order:
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                _faults.fire("prefetch.load", chunk=i)
                host = self._load(i)             # disk -> host
                t1 = time.perf_counter()
                _faults.fire("prefetch.place", chunk=i)
                buf = self._place(host)          # host -> card
                self.load_s += t1 - t0
                self.place_s += time.perf_counter() - t1
                if not self._put((i, host, buf)):
                    return
        except BaseException as e:
            # The error rides the queue to the consumer: the queue's
            # lock orders it after every chunk already delivered.
            logger.warning("chunk prefetch thread died: %r", e)
            self._put((self._SENTINEL, e, None))
        finally:
            if self._store is not None:
                self._store.end_read()

    def next(self, expect: int):
        """The next placed chunk; raises the producer's error and asserts
        the order.  A bounded poll: a producer that died without
        delivering raises at once, a wedged one after
        ``stall_timeout_s``."""
        start = time.perf_counter()
        while True:
            try:
                i, host, buf = self._q.get(timeout=0.05)
                break
            except queue.Empty:
                now = time.perf_counter()
                thread = self._thread
                if ((thread is None or not thread.is_alive())
                        and self._q.empty()):
                    raise RuntimeError(
                        f"prefetch producer died without delivering "
                        f"chunk {expect} (thread gone, queue empty, no "
                        "in-band error); see the run log's "
                        "thread_exception / heartbeat events for the "
                        "stage that stopped")
                if now - start > self.stall_timeout_s:
                    raise TimeoutError(
                        f"prefetch pipeline stalled {now - start:.1f}s "
                        f"waiting for chunk {expect} (stall_timeout_s="
                        f"{self.stall_timeout_s:g}): the disk/staging "
                        "tier is wedged — check spill-dir health; the "
                        "producer thread is still alive, so its "
                        "heartbeat events name the stuck stage")
        self.wait_s += time.perf_counter() - start
        if i is self._SENTINEL:
            raise host   # the producer's exception, delivered in-band
        if i != expect:
            raise AssertionError(
                f"prefetch order violated: got chunk {i}, "
                f"expected {expect}")
        del host
        return buf

    def close(self, join_timeout_s: float = 10.0) -> None:
        """Stop, drain and join the producer within a deadline (a thread
        wedged in a load cannot see the stop flag; it is a daemon and is
        abandoned).  Idempotent."""
        t = self._thread
        if t is None:
            return
        self._stop.set()
        deadline = time.monotonic() + join_timeout_s
        while t.is_alive() and time.monotonic() < deadline:
            try:
                self._q.get_nowait()   # unblock a full-queue producer
            except queue.Empty:
                t.join(timeout=0.05)
        if t.is_alive():
            logger.warning(
                "prefetch thread did not exit within %.1fs (blocked "
                "in a chunk load?); abandoning daemon thread",
                join_timeout_s)
        self._thread = None


def prefetch_stream(load, place, order, depth: int, store=None,
                    device=None):
    """Yield ``(i, placed)`` for every ``i`` in ``order`` through the
    prefetch pipeline (``depth`` chunks ahead), or synchronously when
    ``depth <= 0``.  The prefetcher is closed (and the store reader
    released) whenever the generator exits; ``device`` is the card the
    prefetch thread places on."""
    order = list(order)
    if depth <= 0:
        if store is not None:
            store.begin_read()
        try:
            for i in order:
                yield i, place(load(i))
        finally:
            if store is not None:
                store.end_read()
        return
    pf = ChunkPrefetcher(load, place, depth, store=store, device=device)
    pf.start(order)
    try:
        for i in order:
            yield i, pf.next(i)
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# The chunked objective
# ---------------------------------------------------------------------------


class ChunkedGLMObjective:
    """``GLMObjective`` surface over a ``ChunkedBatch`` (the batch is
    owned: methods take only the coefficients).

    ``max_resident`` placed chunks stay on the card across evaluations
    of a host-resident batch (≥ the chunk count pays the transfer
    once); a spilled batch streams every sweep through the prefetcher.
    ``device``: where the chunks go (default CUDA; ``"cpu"`` when
    asked).  ``sweeps`` counts full chunk sweeps; ``stats`` sums the
    consumer's prefetch wait, the prefetch thread's time loading and
    placing chunks, and the bytes and chunks placed.
    """

    def __init__(self, objective: GLMObjective, batch,
                 max_resident: int = 1, prefetch_depth: int = 2,
                 device=None):
        self.objective = objective
        self.batch = batch
        self.max_resident = max_resident
        self.prefetch_depth = prefetch_depth
        self.device = resolve_device(device)
        self.sweeps = 0
        self.stats = {"consumer_wait_s": 0.0, "load_s": 0.0,
                      "place_s": 0.0, "placed_bytes": 0,
                      "placed_chunks": 0}
        self._cache: dict = {}
        self._active_prefetcher: ChunkPrefetcher | None = None
        self._stager: _Stager | None = None
        self._inner = dataclasses.replace(
            objective, reg=RegularizationContext.none(), prior=None)

    # -- chunk residency ---------------------------------------------------

    def invalidate(self) -> None:
        """Drop placed chunks (after ``ChunkedBatch.set_offsets``): the
        prefetcher is quiesced first, the store must prove it, and the
        copies still in flight finish before anything is freed."""
        pf = self._active_prefetcher
        if pf is not None:
            pf.close()
            self._active_prefetcher = None
        if self.batch.store is not None:
            self.batch.store.assert_quiesced()
        if self._stager is not None:
            self._stager.quiesce()
        self._cache.clear()

    def _place(self, host: SparseBatch) -> _Placed:
        if self.device.type != "cuda":
            placed = _place_cpu(host)
        else:
            if self._stager is None:
                self._stager = _Stager(self.device,
                                       max(self.prefetch_depth, 0) + 2)
            placed = self._stager.place(host)
        self.stats["placed_bytes"] += placed.nbytes
        self.stats["placed_chunks"] += 1
        return placed

    def _get(self, i: int) -> _Placed:
        if i in self._cache:
            return self._cache[i]
        placed = self._place(self.batch.chunk(i))
        if len(self._cache) < self.max_resident:
            self._cache[i] = placed
        return placed

    def _chunk_stream(self):
        """``(chunk_id, placed chunk)`` in order 0..K-1, pipelined: the
        prefetch thread for a spilled batch, else the next chunk's copy
        issued before the current chunk's compute."""
        order = list(range(self.batch.n_chunks))
        if not order:
            return
        if self.batch.store is not None and self.prefetch_depth > 0:
            pf = ChunkPrefetcher(self.batch.chunk, self._place,
                                 self.prefetch_depth,
                                 store=self.batch.store,
                                 device=self.device)
            self._active_prefetcher = pf
            pf.start(order)
            try:
                for i in order:
                    yield i, _handover(pf.next(i))
            finally:
                pf.close()
                self._active_prefetcher = None
                self.stats["consumer_wait_s"] += pf.wait_s
                self.stats["load_s"] += pf.load_s
                self.stats["place_s"] += pf.place_s
            return
        nxt = self._get(order[0])
        for pos, i in enumerate(order):
            cur = nxt
            if pos + 1 < len(order):
                nxt = self._get(order[pos + 1])
            yield i, _handover(cur)

    def _fenced(self):
        """Yield placed chunks, fencing chunk i-1's work before chunk i
        dispatches on the spilled path (the backpressure fence)."""
        bounded = (self.batch.store is not None
                   and self.device.type == "cuda")
        fence = None
        for cid, cur in self._chunk_stream():
            if fence is not None:
                fence.synchronize()
            yield cid, cur
            if bounded:
                fence = torch.cuda.Event()
                fence.record()

    def _sweep(self, per_chunk, combine):
        """Stream every chunk through ``per_chunk`` and fold the partials
        with ``combine``."""
        self.sweeps += 1
        acc = None
        for _cid, cur in self._fenced():
            out = per_chunk(cur)
            acc = out if acc is None else combine(acc, out)
        return acc

    def _w(self, w) -> Tensor:
        return torch.as_tensor(w, dtype=torch.float32).to(self.device)

    # -- the objective surface ---------------------------------------------

    def value(self, w) -> Tensor:
        w = self._w(w)
        val = self._sweep(lambda b: self._inner.value(w, b),
                          lambda a, x: a + x)
        val = val + self.objective.reg.l2_value(w)
        if self.objective.prior is not None:
            val = val + self.objective.prior.value(w)
        return val

    def value_and_gradient(self, w) -> tuple[Tensor, Tensor]:
        w = self._w(w)
        f, g = self._sweep(
            lambda b: self._inner.value_and_gradient(w, b),
            lambda a, x: (a[0] + x[0], a[1] + x[1]))
        reg = self.objective.reg
        f = f + reg.l2_value(w)
        g = g + reg.l2_gradient(w)
        if self.objective.prior is not None:
            f = f + self.objective.prior.value(w)
            g = g + self.objective.prior.gradient(w)
        return f, g

    def gradient(self, w) -> Tensor:
        return self.value_and_gradient(w)[1]

    def hessian_vector(self, w, v) -> Tensor:
        w, v = self._w(w), self._w(v)
        hv = self._sweep(lambda b: self._inner.hessian_vector(w, v, b),
                         lambda a, x: a + x)
        hv = hv + self.objective.reg.l2_hessian_vector(v)
        if self.objective.prior is not None:
            hv = hv + self.objective.prior.hessian_vector(v)
        return hv

    def hvp_pass(self, w, v) -> Tensor:
        """One chunk-accumulated H(w)·v pass for Steihaug CG (the same
        math as ``hessian_vector``)."""
        return self.hessian_vector(w, v)

    def hessian_diagonal(self, w) -> Tensor:
        w = self._w(w)
        hd = self._sweep(lambda b: self._inner.hessian_diagonal(w, b),
                         lambda a, x: a + x)
        hd = hd + self.objective.reg.l2_hessian_diagonal(w)
        if self.objective.prior is not None:
            hd = hd + self.objective.prior.hessian_diagonal()
        return hd

    # -- the swept (λ-lane) surface ------------------------------------------

    def _lane_reg(self, W: Tensor, reg: SweptRegularization | None,
                  method: str) -> Tensor:
        """Per-lane L2 term by the named context method, [L(, d)];
        ``reg`` None applies the objective's own weight to every lane."""
        ctx = self.objective.reg
        if reg is not None:
            ctx = dataclasses.replace(
                ctx, l2_weight=reg.l2_weights.to(W.device))
        return getattr(ctx, method)(W)

    def value_swept(self, W, reg: SweptRegularization | None = None
                    ) -> Tensor:
        """[L, d] lanes → [L] values from one chunk sweep."""
        W = self._w(W)
        val = self._sweep(lambda b: self._inner.value(W, b),
                          lambda a, x: a + x)
        val = val + self._lane_reg(W, reg, "l2_value")
        if self.objective.prior is not None:
            val = val + self.objective.prior.value(W)
        return val

    def value_and_gradient_swept(
        self, W, reg: SweptRegularization | None = None,
    ) -> tuple[Tensor, Tensor]:
        """[L, d] lanes → ([L], [L, d]) from one chunk sweep: the lane
        kernel reads each chunk's ELL streams once for every lane."""
        W = self._w(W)
        f, g = self._sweep(
            lambda b: self._inner.value_and_gradient(W, b),
            lambda a, x: (a[0] + x[0], a[1] + x[1]))
        f = f + self._lane_reg(W, reg, "l2_value")
        g = g + self._lane_reg(W, reg, "l2_gradient")
        if self.objective.prior is not None:
            f = f + self.objective.prior.value(W)
            g = g + self.objective.prior.gradient(W)
        return f, g

    # -- per-example passes --------------------------------------------------

    def _per_example(self, fn) -> np.ndarray:
        """A per-chunk per-example quantity over every chunk → [n] host
        array, through the same pipelined chunk feed."""
        pending = []
        for cid, cur in self._fenced():
            lo, hi = self.batch.chunk_slice(cid)
            pending.append(fn(cur)[: hi - lo])
        if not pending:
            return np.zeros(0, np.float32)
        return torch.cat(pending).cpu().numpy()

    def predict_margins(self, w) -> np.ndarray:
        """Per-example margins (offsets included) over all chunks."""
        w = self._w(w)
        return self._per_example(
            lambda b: self._inner.predict_margins(w, b))

    def x_dot(self, w) -> np.ndarray:
        """Raw X·w per example (offset-free scoring)."""
        w = self._w(w)
        return self._per_example(lambda b: b.x_dot(w))


# ---------------------------------------------------------------------------
# Solver snapshots (the reference's state trees)
# ---------------------------------------------------------------------------


def _host(a) -> np.ndarray:
    if isinstance(a, Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _to(a, device, dtype=torch.float32) -> Tensor:
    return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)


def _tracker_state(tracker: StatesTracker) -> dict:
    """A one-lane tracker as the reference's tree ([T] planes, a 0-d
    int32 count)."""
    return {"values": tracker.values[0], "grad_norms": tracker.grad_norms[0],
            "count": tracker.count[0], "step_sizes": tracker.step_sizes[0],
            "ls_trials": tracker.ls_trials[0]}


def _restore_tracker(st: dict, device) -> StatesTracker:
    def plane(key, like=None):
        a = st.get(key)
        if a is None:
            return torch.full_like(like, float("nan"))
        return _to(a, device)[None]

    values = plane("values")
    return StatesTracker(
        values=values, grad_norms=plane("grad_norms"),
        count=_to(st["count"], device, torch.int32).reshape(1),
        step_sizes=plane("step_sizes", values),
        ls_trials=plane("ls_trials", values))


def _solver_checkpoint(solver_name: str, label: str):
    """(checkpointer, scoped label) when an active checkpoint session has
    mid-solve cadence on, else (None, None)."""
    ck = _ckpt.active()
    if ck is None or ck.every_solver_iters <= 0:
        return None, None
    name = solver_name + (f":{label}" if label else "")
    return ck, ck.solver_label(name)


def _solver_fingerprint(m: int, *arrays) -> str:
    """Identity stamp of a mid-solve snapshot: the warm start and L1
    weights as float32 bytes (and ``m``), as the reference hashes them,
    so a snapshot of a changed objective is rejected."""
    h = hashlib.blake2b(digest_size=16)
    h.update(str(int(m)).encode())
    for a in arrays:
        if a is None:
            h.update(b"|none")
        else:
            arr = np.asarray(_host(a), np.float32)
            h.update(f"|{arr.shape}".encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def _restored_if_matching(ck, ck_label, fp, what: str, label: str):
    restored = ck.load_solver(ck_label) if ck is not None else None
    if restored is not None and restored.get("fp") != fp:
        logger.warning(
            "%s '%s': solver snapshot ignored — objective/warm-start "
            "fingerprint mismatch (config changed since the interrupted "
            "run?)", what, label)
        return None
    return restored


def _one_lane_result(w, f, g_norm, it, converged, tracker
                     ) -> OptimizationResult:
    return OptimizationResult(
        w=w, value=f, grad_norm=g_norm, iterations=int(it),
        converged=bool(converged), tracker=tracker.lane(0))


# ---------------------------------------------------------------------------
# Host-driven L-BFGS / OWL-QN
# ---------------------------------------------------------------------------


def streaming_lbfgs_solve(
    value_and_grad,
    w0,
    config: OptimizerConfig = OptimizerConfig(),
    l1_weight=None,
    value_fn=None,
    label: str = "",
) -> OptimizationResult:
    """Host-driven L-BFGS / OWL-QN over an expensive (streamed)
    ``value_and_grad``: the two-loop recursion, Armijo backtracking with
    the OWL-QN orthant projection, the curvature guard, and the
    reference's convergence tests.

    ``value_fn`` (``w → f``) makes backtracking cheaper: the first trial
    keeps the fused value+gradient pass, later trials are value-only,
    and the gradient is recovered once at an accepted value-only point.
    With an active checkpoint session the loop state is snapshotted at
    iteration boundaries and a resumed run re-enters there.
    """
    m = config.lbfgs_memory
    w = torch.as_tensor(w0, dtype=torch.float32)
    dev = w.device
    owlqn = l1_weight is not None
    solver_name = "streaming_owlqn" if owlqn else "streaming_lbfgs"
    l1 = (torch.as_tensor(l1_weight, dtype=w.dtype, device=dev)
          .expand(w.shape).contiguous() if owlqn else None)

    def l1_term(w_):
        return (l1 * w_.abs()).sum() if owlqn else 0.0

    def full_value_grad(w_):
        f_, g_ = value_and_grad(w_)
        return f_ + l1_term(w_), g_

    full_value = (None if value_fn is None
                  else (lambda w_: value_fn(w_) + l1_term(w_)))

    def pgrad(g_, w_):
        return _pseudo_gradient(g_, w_, l1) if owlqn else g_

    def converged_at(g_norm) -> bool:
        return bool(grad_converged(torch.as_tensor(g_norm),
                                   torch.as_tensor(g0_norm),
                                   config.tolerance))

    ck, ck_label = _solver_checkpoint(solver_name, label)
    fp = _solver_fingerprint(m, w, l1) if ck is not None else None
    restored = _restored_if_matching(ck, ck_label, fp, "streaming lbfgs",
                                     label)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    if restored is not None:
        # Re-enter at the snapshot's iteration boundary: point, value,
        # gradient and the (s, y, ρ) memory; the initial evaluation is
        # not repaid.
        w = _to(restored["w"], dev)
        f = _to(restored["f"], dev)
        g = _to(restored["g"], dev)
        pg = pgrad(g, w)
        g0_norm = float(restored["g0_norm"])
        s_hist = [_to(s, dev) for s in restored["s_hist"]]
        y_hist = [_to(y, dev) for y in restored["y_hist"]]
        rho_hist = [float(r) for r in restored["rho_hist"]]
        tracker = _restore_tracker(restored["tracker"], dev)
        converged = bool(restored["converged"])
        it = int(restored["it"])
        logger.info("streaming lbfgs '%s': resumed at iteration %d",
                    label, it)
    else:
        f, g = full_value_grad(w)
        pg = pgrad(g, w)
        g0_norm = float(torch.linalg.norm(pg))
        tracker = StatesTracker.create(1, config.max_iters, dev)
        if config.track_states:
            tracker.record(0, one, f, torch.as_tensor(g0_norm))
        s_hist, y_hist, rho_hist = [], [], []   # newest first
        converged = converged_at(g0_norm)
        it = 0
    while not converged and it < config.max_iters:
        q = pg
        alphas = []
        for s, y, rho in zip(s_hist, y_hist, rho_hist):
            a = rho * torch.dot(s, q)
            alphas.append(a)
            q = q - a * y
        if s_hist:
            y_new = y_hist[0]
            gamma = 1.0 / torch.clamp(rho_hist[0] * torch.dot(y_new, y_new),
                                      min=_CURVATURE_EPS)
        else:
            gamma = 1.0
        r = gamma * q
        for (s, y, rho), a in zip(
                reversed(list(zip(s_hist, y_hist, rho_hist))),
                reversed(alphas)):
            beta = rho * torch.dot(y, r)
            r = r + s * (a - beta)
        d = -r
        if owlqn:
            d = torch.where(d * -pg > 0.0, d, torch.zeros_like(d))
            xi = torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))
        # Steepest descent on a numerical breakdown.
        if float(torch.dot(pg, d)) >= 0.0:
            d = -pg

        # Backtracking Armijo; after ls_max_steps backtracks the last
        # trial commits anyway, and only a strict decrease is progress.
        alpha = 1.0
        g_try = None
        trials = 0
        for step in range(config.ls_max_steps + 1):
            alpha_used = alpha
            w_try = w + alpha * d
            if owlqn:
                w_try = torch.where(torch.sign(w_try) == xi, w_try,
                                    torch.zeros_like(w_try))
            trials += 1
            if step == 0 or full_value is None:
                f_try, g_try = full_value_grad(w_try)
            else:
                f_try, g_try = full_value(w_try), None
            if float(f_try) <= float(
                    f + config.ls_c1 * torch.dot(pg, w_try - w)):
                break
            alpha *= config.ls_shrink
        if g_try is None and float(f_try) < float(f):
            # An accepted value-only trial: one pass for its gradient.
            f_try, g_try = full_value_grad(w_try)
        elif g_try is None:
            g_try = g   # stalled: the state is not committed below
        w_new, f_new, g_new = w_try, f_try, g_try
        ls_ok = float(f_new) < float(f)
        if ls_ok:
            s = w_new - w
            y = g_new - g
            sy = float(torch.dot(s, y))
            if sy > _CURVATURE_EPS * float(
                    torch.linalg.norm(s) * torch.linalg.norm(y)):
                s_hist.insert(0, s)
                y_hist.insert(0, y)
                rho_hist.insert(0, 1.0 / max(sy, _CURVATURE_EPS))
                del s_hist[m:], y_hist[m:], rho_hist[m:]

        pg_new = pgrad(g_new, w_new)
        g_norm = torch.linalg.norm(pg_new)
        conv = converged_at(g_norm) or bool(
            loss_converged(f_new, f, config.rel_tolerance))
        stalled = not ls_ok
        it += 1
        if config.track_states:
            tracker.record(it, one, f_new, g_norm,
                           step_size=alpha_used if ls_ok else 0.0,
                           ls_trials=float(trials))
        logger.info("streaming lbfgs iter %d: f=%.6f |pg|=%.3e%s", it,
                    float(f_new), float(g_norm),
                    " (stalled)" if stalled else "")
        if ls_ok:
            w, f, g, pg = w_new, f_new, g_new, pg_new
        converged = conv or stalled
        if ck is not None:
            ck.maybe_save_solver(ck_label, it, {
                "fp": fp,
                "w": w, "f": f, "g": g, "g0_norm": float(g0_norm),
                "s_hist": list(s_hist), "y_hist": list(y_hist),
                "rho_hist": [float(r) for r in rho_hist],
                "converged": bool(converged),
                "tracker": _tracker_state(tracker),
                "fleet_seq": -1,
            })

    if ck is not None:
        ck.clear_solver(ck_label)   # superseded by the result
    return _one_lane_result(w, f, torch.linalg.norm(pgrad(g, w)), it,
                            converged, tracker)


# ---------------------------------------------------------------------------
# Host-driven TRON
# ---------------------------------------------------------------------------


def streaming_tron_solve(
    value_and_grad,
    hvp,
    w0,
    config: OptimizerConfig = OptimizerConfig(),
    hessian_diag=None,
    label: str = "",
) -> OptimizationResult:
    """Host-driven trust-region Newton over a chunk-streamed objective:
    Steihaug CG inside the Lin–Moré radius schedule, with the resident
    solver's constants; every Hessian-vector product ``hvp(w, v)`` is a
    full chunk pass (``ChunkedGLMObjective.hvp_pass``).

    ``hessian_diag`` (``w → diag H(w)``) turns on Jacobi
    preconditioning, frozen for the solve: CG runs in the scaled space
    p̂ = D^{1/2} p and the trust region measures ‖p̂‖.  The predicted
    reduction comes from the CG residual (½(p̂ᵀr̂ − ĝᵀp̂)), so an outer
    iteration costs its CG passes plus one trial evaluation.  With
    solver-iteration checkpoints a snapshot is cut after every CG step
    (the CG vectors, radius and outer point), so a resume re-enters at
    the exact Hessian-vector boundary.
    """
    w = torch.as_tensor(w0, dtype=torch.float32)
    dev = w.device
    solver_name = "streaming_tron"
    one = torch.ones(1, dtype=torch.bool, device=dev)

    ck, ck_label = _solver_checkpoint(solver_name, label)
    fp = (_solver_fingerprint(config.cg_max_iters, w)
          if ck is not None else None)
    restored = _restored_if_matching(ck, ck_label, fp, "streaming tron",
                                     label)
    cg_state = None
    if restored is not None:
        w = _to(restored["w"], dev)
        f = _to(restored["f"], dev)
        g = _to(restored["g"], dev)
        delta = float(restored["delta"])
        g0_norm = float(restored["g0_norm"])
        scale = (None if restored.get("scale") is None
                 else _to(restored["scale"], dev))
        tracker = _restore_tracker(restored["tracker"], dev)
        converged = bool(restored["converged"])
        it = int(restored["it"])
        steps = int(restored["steps"])
        cg = restored.get("cg")
        if cg is not None:
            cg_state = (_to(cg["p"], dev), _to(cg["r"], dev),
                        _to(cg["d"], dev), _to(cg["rs"], dev),
                        int(cg["cg_it"]))
        logger.info(
            "streaming tron '%s': resumed at iteration %d%s", label, it,
            f" (mid-CG, step {cg_state[4]})" if cg_state else "")
    else:
        f, g = value_and_grad(w)
        scale = None
        if hessian_diag is not None:
            diag = hessian_diag(w)
            scale = 1.0 / torch.sqrt(torch.clamp(
                torch.as_tensor(diag, dtype=torch.float32), min=1e-12))
        g0_norm = float(torch.linalg.norm(g))
        delta = float(torch.linalg.norm(g if scale is None else scale * g))
        tracker = StatesTracker.create(1, config.max_iters, dev)
        if config.track_states:
            tracker.record(0, one, f, torch.as_tensor(g0_norm))
        converged = bool(grad_converged(torch.as_tensor(g0_norm),
                                        torch.as_tensor(g0_norm),
                                        config.tolerance))
        it = 0
        steps = 0

    def save(cg):
        """Snapshot at the current (outer, CG) boundary; ``steps`` counts
        Hessian-vector passes and outer commits."""
        if ck is None:
            return
        ck.maybe_save_solver(ck_label, steps, {
            "fp": fp, "w": w, "f": f, "g": g,
            "delta": float(delta), "g0_norm": float(g0_norm),
            "scale": scale, "it": it, "steps": steps,
            "converged": bool(converged),
            "tracker": _tracker_state(tracker),
            "fleet_seq": -1,
            "cg": cg,
        })

    while not converged and it < config.max_iters:
        g_hat = g if scale is None else scale * g
        tol_cg = config.cg_tolerance * float(torch.linalg.norm(g_hat))
        if cg_state is not None:
            p, r, d, rs, cg_it = cg_state
            cg_state = None
        else:
            p = torch.zeros_like(g_hat)
            r = -g_hat
            d = r
            rs = torch.dot(r, r)
            cg_it = 0
        # Steihaug CG: one chunked Hessian-vector pass a step.
        while (cg_it < config.cg_max_iters
               and float(torch.sqrt(rs)) > tol_cg):
            hd = (hvp(w, d) if scale is None
                  else scale * hvp(w, scale * d))
            dhd = torch.dot(d, hd)
            cg_it += 1
            steps += 1
            if float(dhd) <= 0.0:
                # Negative curvature: to the boundary, keeping the
                # residual consistent for the predicted reduction.
                tau = _boundary_tau(p, d, delta)
                p = p + tau * d
                r = r - tau * hd
                break
            alpha = rs / torch.clamp(dhd, min=1e-30)
            p_try = p + alpha * d
            if float(torch.linalg.norm(p_try)) >= delta:
                tau = _boundary_tau(p, d, delta)
                p = p + tau * d
                r = r - tau * hd
                break
            p = p_try
            r = r - alpha * hd
            rs_new = torch.dot(r, r)
            beta = rs_new / torch.clamp(rs, min=1e-30)
            d = r + beta * d
            rs = rs_new
            save({"p": p, "r": r, "d": d, "rs": rs, "cg_it": cg_it})

        predicted = float(0.5 * (torch.dot(p, r) - torch.dot(g_hat, p)))
        step = p if scale is None else scale * p
        w_try = w + step
        f_new, g_new = value_and_grad(w_try)
        f_prev = f
        actual = float(f) - float(f_new)
        rho = actual / max(predicted, 1e-30)
        accept = (rho > _ETA0) and (actual > 0.0)
        p_norm = float(torch.linalg.norm(p))
        if rho < _SIGMA1:
            delta = min(delta, p_norm) * _SIGMA1
        elif rho > 0.75:
            delta = max(delta, _SIGMA3 * p_norm / 2.0)
        delta = max(delta, _DELTA_MIN)

        if accept:
            w, f, g = w_try, f_new, g_new
        g_norm = float(torch.linalg.norm(g))
        conv = bool(grad_converged(torch.as_tensor(g_norm),
                                   torch.as_tensor(g0_norm),
                                   config.tolerance))
        if accept and bool(loss_converged(f_new, f_prev,
                                          config.rel_tolerance)):
            conv = True
        # Precision stop: less predicted reduction than float32 resolves.
        if predicted <= 1e-6 * max(abs(float(f_prev)), 1.0):
            conv = True
        stalled = delta <= _DELTA_MIN
        it += 1
        steps += 1
        if config.track_states:
            tracker.record(it, one, f, torch.as_tensor(g_norm),
                           step_size=p_norm if accept else 0.0,
                           ls_trials=float(cg_it))
        logger.info(
            "streaming tron iter %d: f=%.6f |g|=%.3e delta=%.3e "
            "rho=%.3f cg=%d%s", it, float(f), g_norm, delta, rho,
            cg_it, "" if accept else " (rejected)")
        converged = conv
        save(None)
        if stalled:
            break

    if ck is not None:
        ck.clear_solver(ck_label)
    return _one_lane_result(w, f, torch.linalg.norm(g), it, converged,
                            tracker)


# ---------------------------------------------------------------------------
# Host-driven λ-lane L-BFGS / OWL-QN
# ---------------------------------------------------------------------------


def _swept_direction(PG, W, S_buf, Y_buf, Rho, head, count, l1):
    """Per-lane two-loop recursion over circular (s, y) buffers
    [m, L, d] (newest at ``head - 1``), with the OWL-QN projections when
    ``l1`` is given → (D [L, d], Xi [L, d] | None)."""
    m, L, _ = S_buf.shape
    lanes = torch.arange(L, device=W.device)
    head = head.long()
    q = PG
    alphas = []
    for j in range(m):
        idx = (head - 1 - j) % m
        valid = j < count
        s_j, y_j = S_buf[idx, lanes], Y_buf[idx, lanes]
        a = Rho[idx, lanes] * (s_j * q).sum(-1)
        a = torch.where(valid, a, torch.zeros_like(a))
        q = q - a[:, None] * y_j
        alphas.append((a, idx, valid))
    newest = (head - 1) % m
    y_new = Y_buf[newest, lanes]
    gamma = torch.where(
        count > 0,
        1.0 / torch.clamp(Rho[newest, lanes] * (y_new * y_new).sum(-1),
                          min=_CURVATURE_EPS),
        torch.ones_like(Rho[newest, lanes]))
    r = gamma[:, None] * q
    for a, idx, valid in reversed(alphas):
        s_j, y_j = S_buf[idx, lanes], Y_buf[idx, lanes]
        beta = Rho[idx, lanes] * (y_j * r).sum(-1)
        upd = s_j * (a - beta)[:, None]
        r = r + torch.where(valid[:, None], upd, torch.zeros_like(upd))
    D = -r
    Xi = None
    if l1 is not None:
        D = torch.where(D * -PG > 0.0, D, torch.zeros_like(D))
        Xi = torch.where(W != 0.0, torch.sign(W), torch.sign(-PG))
    bad = (PG * D).sum(-1) >= 0.0
    D = torch.where(bad[:, None], -PG, D)
    return D, Xi


def _swept_push(S_buf, Y_buf, Rho, head, count, s, y, good):
    """Masked per-lane circular-buffer push of curvature pairs."""
    m, L, _ = S_buf.shape
    lanes = torch.arange(L, device=s.device)
    h = head.long()
    sy = (s * y).sum(-1)
    S_buf = S_buf.clone()
    Y_buf = Y_buf.clone()
    Rho = Rho.clone()
    S_buf[h, lanes] = torch.where(good[:, None], s, S_buf[h, lanes])
    Y_buf[h, lanes] = torch.where(good[:, None], y, Y_buf[h, lanes])
    Rho[h, lanes] = torch.where(
        good, 1.0 / torch.clamp(sy, min=_CURVATURE_EPS), Rho[h, lanes])
    head = torch.where(good, (head + 1) % m, head)
    count = torch.where(good, torch.clamp(count + 1, max=m), count)
    return S_buf, Y_buf, Rho, head, count


def streaming_lbfgs_solve_swept(
    value_and_grad_swept,
    value_swept,
    w0s,
    config: OptimizerConfig = OptimizerConfig(),
    l1_weights=None,
    label: str = "",
) -> OptimizationResult:
    """Host-driven batched-lane L-BFGS / OWL-QN: the λ grid as one
    streamed solve.  Every per-lane state carries a leading lane axis
    and every update is masked per lane, and every evaluation is one
    shared chunk sweep for all L lanes (``value_and_grad_swept``:
    ``W [L, d] → (F [L], G [L, d])``, per-lane smooth reg included):
    one fused sweep when every searching lane accepts α=1, one shared
    value-only sweep (``value_swept``) a further backtrack, one gradient
    recovery sweep where a lane accepted late.

    ``l1_weights``: None, [L] scalars or [L, d] vectors (OWL-QN on every
    lane).  Returns a lane-batched ``OptimizationResult``.
    """
    m = config.lbfgs_memory
    W = torch.as_tensor(w0s, dtype=torch.float32)
    dev = W.device
    L, d = W.shape
    owlqn = l1_weights is not None
    solver_name = ("streaming_owlqn_swept" if owlqn
                   else "streaming_lbfgs_swept")
    l1 = None
    if owlqn:
        l1 = torch.as_tensor(l1_weights, dtype=W.dtype, device=dev)
        l1 = l1.reshape(L, -1).expand(L, d).contiguous()

    def l1_term(W_):
        return (l1 * W_.abs()).sum(-1) if owlqn else 0.0

    def full_vg(W_):
        F_, G_ = value_and_grad_swept(W_)
        return F_ + l1_term(W_), G_

    def full_val(W_):
        return value_swept(W_) + l1_term(W_)

    def pgrad(G_, W_):
        return _pseudo_gradient(G_, W_, l1) if owlqn else G_

    ck, ck_label = _solver_checkpoint(solver_name, label)
    fp = (_solver_fingerprint(m, W, l1 if owlqn else None)
          if ck is not None else None)
    restored = _restored_if_matching(ck, ck_label, fp,
                                     "streaming swept lbfgs", label)
    i32 = torch.int32
    if restored is not None:
        W = _to(restored["W"], dev)
        F = _to(restored["F"], dev)
        G = _to(restored["G"], dev)
        g0_norm = _to(restored["g0_norm"], dev)
        done = _to(restored["done"], dev, torch.bool)
        converged = _to(restored["converged"], dev, torch.bool)
        iters = _to(restored["iters"], dev, i32)
        S_buf = _to(restored["S_buf"], dev)
        Y_buf = _to(restored["Y_buf"], dev)
        Rho = _to(restored["Rho"], dev)
        head = _to(restored["head"], dev, i32)
        count = _to(restored["count"], dev, i32)
        t_vals = _to(restored["t_vals"], dev)
        t_gn = _to(restored["t_gn"], dev)
        it = int(restored["it"])
        logger.info("streaming swept lbfgs '%s': resumed at iteration "
                    "%d (%d/%d lanes done)", label, it,
                    int(done.sum()), L)
    else:
        F, G = full_vg(W)
        PG = pgrad(G, W)
        g0_norm = torch.linalg.norm(PG, dim=-1)
        done = grad_converged(g0_norm, g0_norm, config.tolerance)
        converged = done.clone()
        iters = torch.zeros(L, dtype=i32, device=dev)
        S_buf = torch.zeros((m, L, d), dtype=W.dtype, device=dev)
        Y_buf = torch.zeros_like(S_buf)
        Rho = torch.zeros((m, L), dtype=W.dtype, device=dev)
        head = torch.zeros(L, dtype=i32, device=dev)
        count = torch.zeros(L, dtype=i32, device=dev)
        t_vals = torch.full((L, config.max_iters + 1), float("nan"),
                            dtype=torch.float32, device=dev)
        t_gn = torch.full_like(t_vals, float("nan"))
        if config.track_states:
            t_vals[:, 0] = F
            t_gn[:, 0] = g0_norm
        it = 0
    while not bool(done.all()) and it < config.max_iters:
        active = ~done
        PG = pgrad(G, W)
        D, Xi = _swept_direction(PG, W, S_buf, Y_buf, Rho, head, count,
                                 l1)

        def project(W_try):
            if not owlqn:
                return W_try
            return torch.where(torch.sign(W_try) == Xi, W_try,
                               torch.zeros_like(W_try))

        def armijo(W_t, F_t):
            return F_t <= F + config.ls_c1 * (PG * (W_t - W)).sum(-1)

        # Trial 0 is the fused value+gradient sweep; later trials are
        # shared value-only sweeps.
        alpha = torch.ones(L, dtype=W.dtype, device=dev)
        W_try = project(W + alpha[:, None] * D)
        trials = 1
        F1, G1 = full_vg(W_try)
        ok = armijo(W_try, F1)
        accepted = ok | done
        commit0 = ok & active
        W_acc = torch.where(commit0[:, None], W_try, W)
        F_acc = torch.where(commit0, F1, F)
        G_acc = torch.where(commit0[:, None], G1, G)
        grad_known = accepted
        W_last, F_last = W_try, F1
        for _ in range(config.ls_max_steps):
            if bool(accepted.all()):
                break
            alpha = torch.where(accepted, alpha, alpha * config.ls_shrink)
            W_try = project(W + alpha[:, None] * D)
            # Accepted lanes re-evaluate at their committed point.
            W_eval = torch.where(accepted[:, None], W_acc, W_try)
            trials += 1
            F_eval = full_val(W_eval)
            ok = armijo(W_eval, F_eval) & ~accepted
            W_acc = torch.where(ok[:, None], W_try, W_acc)
            F_acc = torch.where(ok, F_eval, F_acc)
            accepted = accepted | ok
            still = ~accepted
            W_last = torch.where(still[:, None], W_try, W_last)
            F_last = torch.where(still, F_eval, F_last)
        # Never-accepted lanes commit the last trial; only a strict
        # decrease counts as progress.
        hold = accepted | ~active
        W_new = torch.where(hold[:, None], W_acc, W_last)
        F_new = torch.where(hold, F_acc, F_last)
        need_grad = ~(grad_known | done) & (F_new < F) & active
        if bool(need_grad.any()):
            F_new, G_new = full_vg(W_new)
        else:
            G_new = G_acc

        ls_ok = (F_new < F) & active
        s = W_new - W
        y = G_new - G
        sy = (s * y).sum(-1)
        good = ls_ok & (
            sy > _CURVATURE_EPS * torch.linalg.norm(s, dim=-1)
            * torch.linalg.norm(y, dim=-1))
        S_buf, Y_buf, Rho, head, count = _swept_push(
            S_buf, Y_buf, Rho, head, count, s, y, good)

        PG_new = pgrad(G_new, W_new)
        g_norm = torch.linalg.norm(PG_new, dim=-1)
        conv = (grad_converged(g_norm, g0_norm, config.tolerance)
                | loss_converged(F_new, F, config.rel_tolerance))
        stalled = ~ls_ok & active
        it += 1
        iters = torch.where(active, torch.full_like(iters, it), iters)
        if config.track_states:
            t_vals[:, it] = torch.where(active, F_new, t_vals[:, it])
            t_gn[:, it] = torch.where(active, g_norm, t_gn[:, it])
        W = torch.where(ls_ok[:, None], W_new, W)
        F = torch.where(ls_ok, F_new, F)
        G = torch.where(ls_ok[:, None], G_new, G)
        finished = active & (conv | stalled)
        converged = converged | finished
        done = done | finished
        logger.info("streaming swept lbfgs iter %d: %d/%d lanes done, "
                    "f_best=%.6f (%d trials)", it, int(done.sum()), L,
                    float(F.min()), trials)
        if ck is not None:
            ck.maybe_save_solver(ck_label, it, {
                "fp": fp,
                "W": W, "F": F, "G": G, "g0_norm": g0_norm,
                "done": done, "converged": converged, "iters": iters,
                "S_buf": S_buf, "Y_buf": Y_buf, "Rho": Rho,
                "head": head, "count": count,
                "t_vals": t_vals, "t_gn": t_gn,
                "fleet_seq": -1,
            })

    if ck is not None:
        ck.clear_solver(ck_label)
    nan = torch.full_like(t_vals, float("nan"))
    tracker = StatesTracker(
        values=t_vals, grad_norms=t_gn,
        count=(iters + 1 if config.track_states
               else torch.zeros(L, dtype=i32, device=dev)),
        step_sizes=nan, ls_trials=nan.clone())
    return OptimizationResult(
        w=W, value=F, grad_norm=torch.linalg.norm(pgrad(G, W), dim=-1),
        iterations=iters, converged=converged, tracker=tracker)

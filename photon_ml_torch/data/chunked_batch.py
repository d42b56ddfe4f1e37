"""Chunked batches: a dataset larger than the card, streamed in chunks.

Counterpart of ``photon_ml_tpu/data/chunked_batch.py``.  The dataset is
built once into K congruent chunk batches (the same leaf shapes, the
last chunk padded), and every objective evaluation streams them through
the card, accumulating partials there (``optim.streaming``).  Every
data-side quantity of the GLM objective is a sum over examples, so the
chunked result is exact up to the order of float sums.

Three tiers:

1. **Card** — ``max_resident`` placed chunks kept across evaluations
   (``optim.streaming.ChunkedGLMObjective``).
2. **Host RAM** — without ``spill_dir`` every chunk lives as numpy
   leaves in ``chunks``.
3. **Disk** — with ``spill_dir`` chunks spill to atomic per-chunk
   ``.npz`` files (``data.chunk_store``) and at most
   ``host_max_resident`` decoded chunks stay live; the prefetch thread
   of ``optim.streaming`` overlaps disk read, host staging and the copy
   to the card.  Offsets stay out of the spilled payload: ``chunk(i)``
   overlays the current window, so ``set_offsets`` is an O(n) host
   write and spilled files stay valid across sweeps and runs.

In a training fleet (``parallel.fleet``) a host builds, spills and
streams only its contiguous chunk shard, under its own ``host_NNN``
spill subdirectory; chunk ids stay global, so offsets and checkpoints
keep the full grid, and ``chunk_schedule`` pads the shard with
``EMPTY_CHUNK`` sentinels to the fleet's common step count.

The port builds ELL chunks.  GRR chunks (``layout="grr"``) need the
sharded plan builder and a ``mesh`` the multi-device tier: both raise
``NotImplementedError`` naming ROADMAP A7b.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from photon_ml_torch.data.batch import SparseBatch

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ChunkedBatch:
    """K congruent chunk batches over one example axis.

    Resident mode (``store`` None): ``chunks[i]`` is a ``SparseBatch``
    with host (numpy) leaves.  Spilled mode: ``chunks`` holds
    placeholders, and ``chunk(i)`` pulls from the disk-backed window,
    overlaying the current ``offsets_host`` slice.  Consumers go
    through ``chunk(i)``.
    """

    chunks: list
    dim: int
    n: int                 # real examples (before padding)
    chunk_rows: int        # examples a chunk (the last one padded)
    layout: str
    store: object | None = None  # data.chunk_store.ChunkStore | None
    # Spilled mode: offsets over the padded chunk grid.
    offsets_host: np.ndarray | None = None
    # Fleet mode: the contiguous chunk shard this host owns, and its
    # sentinel-padded schedule (one length on every host).  None: a
    # single-host run, every chunk.
    local_chunk_ids: list | None = None
    schedule: list | None = None

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def owned_chunk_ids(self) -> list:
        """Chunk ids this host streams (all of them outside a fleet)."""
        if self.local_chunk_ids is None:
            return list(range(self.n_chunks))
        return list(self.local_chunk_ids)

    @property
    def chunk_schedule(self) -> list:
        """This host's chunk visit order: its owned chunks, then
        ``fleet.EMPTY_CHUNK`` sentinels up to the fleet's common step
        count (a single host: every chunk)."""
        if self.schedule is None:
            return list(range(self.n_chunks))
        return list(self.schedule)

    def chunk_slice(self, i: int) -> tuple[int, int]:
        """Real-example range [lo, hi) of chunk i."""
        lo = i * self.chunk_rows
        return lo, min(lo + self.chunk_rows, self.n)

    def chunk(self, i: int) -> SparseBatch:
        """Host leaves of chunk i with the current offsets installed."""
        if self.store is None:
            return self.chunks[i]
        c = self.store.get(i)
        off = self.offsets_host[i * self.chunk_rows:
                                (i + 1) * self.chunk_rows]
        return dataclasses.replace(c, offsets=off)

    def set_offsets(self, offsets: np.ndarray) -> None:
        """Install per-example offsets (CD residual passing), zero-padded
        to the chunk grid.  Spilled mode rewrites only the offsets
        window; holders of placed chunks must invalidate them
        (``ChunkedGLMObjective.invalidate``)."""
        offsets = np.asarray(offsets, np.float32)
        if offsets.shape[0] != self.n:
            raise ValueError(
                f"offsets length {offsets.shape[0]} != n {self.n}")
        if self.store is not None:
            self.offsets_host = np.zeros(
                self.n_chunks * self.chunk_rows, np.float32)
            self.offsets_host[: self.n] = offsets
            return
        for i in self.owned_chunk_ids:
            lo, hi = self.chunk_slice(i)
            pad = np.zeros(self.chunk_rows, np.float32)
            pad[: hi - lo] = offsets[lo:hi]
            self.chunks[i] = dataclasses.replace(self.chunks[i],
                                                 offsets=pad)


def _host_chunk(cols, vals, labels, weights, offsets, mask,
                dim) -> SparseBatch:
    """A SparseBatch with host numpy leaves."""
    return SparseBatch(
        values=np.asarray(vals, np.float32),
        col_ids=np.asarray(cols, np.int32),
        labels=np.asarray(labels, np.float32),
        weights=np.asarray(weights, np.float32),
        offsets=np.asarray(offsets, np.float32),
        mask=np.asarray(mask, np.float32),
        dim=dim,
    )


def build_chunked_batch(
    rows,
    dim: int,
    labels: np.ndarray,
    weights: np.ndarray | None = None,
    offsets: np.ndarray | None = None,
    chunk_rows: int | None = None,
    n_chunks: int | None = None,
    layout: str = "ell",
    mesh=None,
    row_capacity: int | None = None,
    cache_dir: str | None = None,
    spill_dir: str | None = None,
    host_max_resident: int = 2,
) -> ChunkedBatch:
    """Build a dataset into K congruent ELL chunk batches on the host.

    ``rows``: ``SparseRows`` or (col_ids, values) pairs.  Exactly one of
    ``chunk_rows`` / ``n_chunks``.  ``spill_dir`` (None = host-resident;
    the ``$PHOTON_ML_TPU_SPILL_DIR`` default is applied by the config
    layer, not here) turns on the disk tier: chunks are built and
    spilled one at a time to content-keyed files, a file that already
    exists for the same key is reused (warm ETL), and a missing or
    corrupt one is rebuilt from ``rows`` when it is read.  An unwritable
    spill dir degrades to the resident build with one warning.
    ``cache_dir`` is the GRR plan cache's, unused by ELL chunks.  Under
    an active fleet context only the host's shard is built and spilled,
    in ``host_dir(spill_dir)``.
    """
    from photon_ml_torch.data.sparse_rows import SparseRows
    from photon_ml_torch.parallel import fleet as _fleet

    del cache_dir  # GRR chunks only (ROADMAP A7b)
    if mesh is not None:
        raise NotImplementedError(
            "chunks x mesh shards are not ported yet (ROADMAP A7b)")
    if layout == "grr":
        raise NotImplementedError(
            "GRR chunk layouts need the sharded plan builder, not ported "
            "yet (ROADMAP A7b); use layout='ell'")
    if layout != "ell":
        raise ValueError(f"unknown chunk layout {layout!r} "
                         "(supported: 'grr', 'ell')")
    if not isinstance(rows, SparseRows):
        rows = SparseRows.from_rows(rows)
    n = len(labels)
    if (chunk_rows is None) == (n_chunks is None):
        raise ValueError("give exactly one of chunk_rows / n_chunks")
    if n_chunks is not None:
        chunk_rows = -(-n // n_chunks)
    n_chunks = -(-n // chunk_rows)

    # Fleet mode: this host builds, spills and streams only its shard.
    fctx = _fleet.active()
    local_ids = schedule = None
    if fctx is not None and fctx.is_fleet:
        local_ids, schedule = _fleet.shard_chunk_ids(
            n_chunks, fctx.host_id, fctx.n_hosts)
    owned = list(range(n_chunks)) if local_ids is None else local_ids
    shard = ("" if local_ids is None else
             f", host {fctx.host_id}/{fctx.n_hosts} shard {len(owned)} "
             "chunks")

    weights = np.ones(n, np.float32) if weights is None else np.asarray(
        weights, np.float32)
    offsets = np.zeros(n, np.float32) if offsets is None else np.asarray(
        offsets, np.float32)
    labels = np.asarray(labels, np.float32)
    k = row_capacity if row_capacity is not None else max(rows.max_nnz, 1)

    def build_chunk(i: int, zero_offsets: bool = False) -> SparseBatch:
        """One chunk, independently of the others (congruent by
        construction: shared k and row count)."""
        lo = i * chunk_rows
        hi = min(lo + chunk_rows, n)
        cols_c, vals_c = rows[lo:hi].to_ell(row_capacity=k,
                                            pad_to=chunk_rows)

        def pad1(a):
            return np.pad(np.asarray(a[lo:hi], np.float32),
                          (0, chunk_rows - (hi - lo)))

        mask = np.zeros(chunk_rows, np.float32)
        mask[: hi - lo] = 1.0
        off = (np.zeros(chunk_rows, np.float32) if zero_offsets
               else pad1(offsets))
        return _host_chunk(cols_c, vals_c, pad1(labels), pad1(weights),
                           off, mask, dim)

    if spill_dir is not None:
        from photon_ml_torch.data.chunk_store import probe_spill_dir

        # Fleet hosts never share chunk files (nor window accounting).
        spill_dir = probe_spill_dir(_fleet.host_dir(spill_dir, fctx))

    if spill_dir is None:
        owned_set = set(owned)
        chunks = [build_chunk(i) if i in owned_set else None
                  for i in range(n_chunks)]
        logger.info("chunked batch: n=%d -> %d chunks x %d rows (%s)%s", n,
                    n_chunks, chunk_rows, layout, shard)
        return ChunkedBatch(chunks=chunks, dim=dim, n=n,
                            chunk_rows=chunk_rows, layout=layout,
                            local_chunk_ids=local_ids, schedule=schedule)

    from photon_ml_torch.data.chunk_store import (
        ChunkStore,
        release_free_heap,
        store_key,
    )

    key = store_key(rows, labels, weights, dim, chunk_rows=chunk_rows,
                    layout=layout, n_dev=1, row_capacity=k)
    store = ChunkStore(spill_dir, key, n_chunks,
                       host_max_resident=host_max_resident,
                       rebuild=lambda i: build_chunk(i, zero_offsets=True))
    missing = [i for i in owned if not store.has(i)]
    # One chunk in flight at a time: the build's peak RSS is the window
    # plus one chunk.
    for i in missing:
        store.put(i, build_chunk(i, zero_offsets=True))
    if missing:
        release_free_heap()
    offsets_host = np.zeros(n_chunks * chunk_rows, np.float32)
    offsets_host[:n] = offsets
    logger.info(
        "chunked batch: n=%d -> %d chunks x %d rows (%s), spilled to %s "
        "(%d built, %d reused; host window %d)%s", n, n_chunks, chunk_rows,
        layout, spill_dir, len(missing), len(owned) - len(missing),
        store.host_max_resident, shard)
    return ChunkedBatch(chunks=[None] * n_chunks, dim=dim, n=n,
                        chunk_rows=chunk_rows, layout=layout, store=store,
                        offsets_host=offsets_host,
                        local_chunk_ids=local_ids, schedule=schedule)

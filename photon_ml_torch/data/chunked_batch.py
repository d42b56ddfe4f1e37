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

Layouts a chunk (``layout=``):

- ``"ell"``: plain ELL (8 bytes a non-zero), B1 on every chunk;
- ``"grr"``: congruent GRR plans (``data.grr.build_sharded_grr_pairs``,
  the chunks as shards of the example axis: one hot and mid set, one
  cap a direction, common padding), B2/B3 on every chunk; the ELL copy
  is dropped (``drop_ell_with_grr``) since the plan serves every
  contraction.

With ``mesh=`` chunks and shards compose: every chunk is built as
``mesh.size`` congruent pieces (``chunk_rows`` rounded up to the grid),
a chunk is the list of this process's pieces, and the streaming
objective places each piece on its shard device and sums the pieces'
partials through the distributed objective.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np

from photon_ml_torch.data.batch import SparseBatch

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ChunkedBatch:
    """K congruent chunk batches over one example axis.

    Resident mode (``store`` None): ``chunks[i]`` is a ``SparseBatch``
    with host (numpy) leaves, or with ``mesh`` the list of this
    process's per-shard pieces.  Spilled mode: ``chunks`` holds
    placeholders, and ``chunk(i)`` pulls from the disk-backed window,
    overlaying the current ``offsets_host`` slice.  Consumers go
    through ``chunk(i)``.
    """

    chunks: list
    dim: int
    n: int                 # real examples (before padding)
    chunk_rows: int        # examples a chunk (the last one padded)
    layout: str
    mesh: object | None = None   # parallel.mesh.Mesh | None
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

    def _with_offsets(self, c, off: np.ndarray):
        """Chunk ``c`` (a batch, or this process's list of pieces) with
        the chunk's offsets ``off`` [chunk_rows] installed."""
        if self.mesh is None:
            return dataclasses.replace(c, offsets=off)
        per = self.chunk_rows // self.mesh.size
        first = self.mesh.first_shard
        return [dataclasses.replace(
            b, offsets=off[(first + j) * per:(first + j + 1) * per])
            for j, b in enumerate(c)]

    def chunk(self, i: int):
        """Host leaves of chunk i with the current offsets installed."""
        if self.store is None:
            return self.chunks[i]
        c = self.store.get(i)
        off = self.offsets_host[i * self.chunk_rows:
                                (i + 1) * self.chunk_rows]
        return self._with_offsets(c, off)

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
            self.chunks[i] = self._with_offsets(self.chunks[i], pad)


def _host_chunk(cols, vals, labels, weights, offsets, mask,
                dim, grr=None) -> SparseBatch:
    """A SparseBatch with host numpy leaves."""
    return SparseBatch(
        values=np.asarray(vals, np.float32),
        col_ids=np.asarray(cols, np.int32),
        labels=np.asarray(labels, np.float32),
        weights=np.asarray(weights, np.float32),
        offsets=np.asarray(offsets, np.float32),
        mask=np.asarray(mask, np.float32),
        dim=dim,
        grr=grr,
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
    drop_ell_with_grr: bool = True,
    cache_dir: str | None = None,
    spill_dir: str | None = None,
    host_max_resident: int = 2,
) -> ChunkedBatch:
    """Build a dataset into K congruent chunk batches on the host.

    ``rows``: ``SparseRows`` or (col_ids, values) pairs.  Exactly one of
    ``chunk_rows`` / ``n_chunks``.  ``layout``: ``"ell"`` or ``"grr"``
    (module docstring); ``cache_dir`` is the plan cache of the GRR chunk
    plans.  With ``mesh`` every chunk is split into ``mesh.size``
    congruent pieces (chunks × shards; ``chunk_rows`` is rounded up to
    the grid) and a process keeps its own pieces.  ``spill_dir`` (None =
    host-resident; the ``$PHOTON_ML_TPU_SPILL_DIR`` default is applied by
    the config layer, not here) turns on the disk tier: ELL chunks are
    built and spilled one at a time, GRR chunks after their congruent
    plan set; a file that already exists for the same key is reused
    (warm ETL), and a missing or corrupt one is rebuilt from ``rows``
    when it is read.  An unwritable spill dir degrades to the resident
    build with one warning.  Under an active fleet context only the
    host's shard is built and spilled, in ``host_dir(spill_dir)``.
    """
    from photon_ml_torch.data.grr import (
        build_sharded_grr_pairs,
        collect_spill_warnings,
    )
    from photon_ml_torch.data.sparse_rows import SparseRows
    from photon_ml_torch.parallel import fleet as _fleet

    if layout not in ("grr", "ell"):
        raise ValueError(f"unknown chunk layout {layout!r} "
                         "(supported: 'grr', 'ell')")
    if not isinstance(rows, SparseRows):
        rows = SparseRows.from_rows(rows)
    n = len(labels)
    if (chunk_rows is None) == (n_chunks is None):
        raise ValueError("give exactly one of chunk_rows / n_chunks")
    n_dev = 1 if mesh is None else mesh.size
    if n_chunks is not None:
        chunk_rows = -(-n // n_chunks)
    # Pieces must be equal: round chunk_rows up to the device grid.
    chunk_rows = -(-chunk_rows // n_dev) * n_dev
    n_chunks = -(-n // chunk_rows)
    per = chunk_rows // n_dev
    # This process's pieces of a chunk (all of them without a world).
    mine = (range(n_dev) if mesh is None
            else range(mesh.first_shard, mesh.first_shard + mesh.local_size))

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
    on_mesh = f", {n_dev}-device mesh" if mesh is not None else ""

    weights = np.ones(n, np.float32) if weights is None else np.asarray(
        weights, np.float32)
    offsets = np.zeros(n, np.float32) if offsets is None else np.asarray(
        offsets, np.float32)
    labels = np.asarray(labels, np.float32)
    k = row_capacity if row_capacity is not None else max(rows.max_nnz, 1)

    def piece_arrays(p: int, zero_offsets: bool):
        """Piece p of the grid (chunk p // n_dev): ELL arrays and the
        per-example planes, padded to ``per`` rows."""
        lo = min(p * per, n)
        hi = min(lo + per, n)
        cols_p, vals_p = rows[lo:hi].to_ell(row_capacity=k, pad_to=per)

        def pad1(a):
            return np.pad(np.asarray(a[lo:hi], np.float32),
                          (0, per - (hi - lo)))

        mask = np.zeros(per, np.float32)
        mask[: hi - lo] = 1.0
        off = (np.zeros(per, np.float32) if zero_offsets
               else pad1(offsets))
        return cols_p, vals_p, (pad1(labels), pad1(weights), off, mask)

    def make(ids, zero_offsets=False) -> dict:
        """The given chunks → {chunk id: chunk}.  GRR chunks share one
        congruent plan set over every piece built here (a fleet host's
        shard: hot and mid sets are then per host, which is sound: the
        plan layout is a per-chunk detail, only the coefficients are
        global)."""
        ps = [c * n_dev + j for c in ids for j in mine]
        arrs = [piece_arrays(p, zero_offsets) for p in ps]
        pairs = [None] * len(ps)
        if layout == "grr":
            pairs = build_sharded_grr_pairs(
                [a[0] for a in arrs], [a[1] for a in arrs], dim,
                cache_dir=cache_dir)
        pieces = []
        for (cols_p, vals_p, aux), pair in zip(arrs, pairs):
            if pair is not None and drop_ell_with_grr:
                # The plan serves every contraction; the ELL copy would
                # only add 8 bytes a non-zero to every chunk's copy.
                cols_p = np.zeros((per, 0), np.int32)
                vals_p = np.zeros((per, 0), np.float32)
            pieces.append(_host_chunk(cols_p, vals_p, *aux, dim, grr=pair))
        m = len(mine)
        return {c: (pieces[i * m:(i + 1) * m] if mesh is not None
                    else pieces[i])
                for i, c in enumerate(ids)}

    if spill_dir is not None:
        from photon_ml_torch.data.chunk_store import probe_spill_dir

        # Fleet hosts never share chunk files (nor window accounting),
        # and neither do the processes of a world (each spills its own
        # pieces).
        spill_dir = _fleet.host_dir(spill_dir, fctx)
        if mesh is not None and mesh.process_count > 1:
            spill_dir = os.path.join(spill_dir,
                                     f"rank_{mesh.process_index:03d}")
        spill_dir = probe_spill_dir(spill_dir)

    if spill_dir is None:
        # One spill-warning scope over every chunk's plans.
        with collect_spill_warnings():
            built = make(owned)
        chunks = [built.get(i) for i in range(n_chunks)]
        logger.info("chunked batch: n=%d -> %d chunks x %d rows (%s%s)%s",
                    n, n_chunks, chunk_rows, layout, on_mesh, shard)
        return ChunkedBatch(chunks=chunks, dim=dim, n=n,
                            chunk_rows=chunk_rows, layout=layout, mesh=mesh,
                            local_chunk_ids=local_ids, schedule=schedule)

    from photon_ml_torch.data.chunk_store import (
        ChunkStore,
        release_free_heap,
        store_key,
    )

    key = store_key(rows, labels, weights, dim, chunk_rows=chunk_rows,
                    layout=layout, n_dev=n_dev, row_capacity=k,
                    drop_ell_with_grr=drop_ell_with_grr)

    def rebuild(i: int):
        """Lineage: an ELL chunk alone; a GRR chunk with its whole
        congruent set (the plan cache makes that one load when
        ``cache_dir`` is set), healing every missing sibling."""
        if layout == "ell":
            return make([i], zero_offsets=True)[i]
        built = make(owned, zero_offsets=True)
        for j, ch in built.items():
            if j != i and not store.has(j):
                store.put(j, ch, keep_resident=False)
        return built[i]

    store = ChunkStore(spill_dir, key, n_chunks,
                       host_max_resident=host_max_resident, rebuild=rebuild)
    missing = [i for i in owned if not store.has(i)]
    with collect_spill_warnings():
        if missing and layout == "ell":
            # One chunk in flight at a time: the build's peak RSS is the
            # window plus one chunk.
            for i in missing:
                store.put(i, make([i], zero_offsets=True)[i])
        elif missing:
            built = make(owned, zero_offsets=True)
            for i in missing:
                store.put(i, built[i])
    if missing:
        release_free_heap()
    offsets_host = np.zeros(n_chunks * chunk_rows, np.float32)
    offsets_host[:n] = offsets
    logger.info(
        "chunked batch: n=%d -> %d chunks x %d rows (%s%s), spilled to %s "
        "(%d built, %d reused; host window %d)%s", n, n_chunks, chunk_rows,
        layout, on_mesh, spill_dir, len(missing), len(owned) - len(missing),
        store.host_max_resident, shard)
    return ChunkedBatch(chunks=[None] * n_chunks, dim=dim, n=n,
                        chunk_rows=chunk_rows, layout=layout, mesh=mesh,
                        store=store, offsets_host=offsets_host,
                        local_chunk_ids=local_ids, schedule=schedule)

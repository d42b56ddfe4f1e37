"""mmap'd random-effect coefficient store for the serving tier.

Counterpart of ``photon_ml_tpu/serving/entity_store.py``, with the same
files: a random effect's rows, in global entity order, are split into
``entity_chunk``-row chunks spilled through ``data.chunk_store`` (atomic
content-keyed ``.npz``, memory-mapped loads, an LRU window), plus one
sidecar ``.npz`` holding the sorted id array, memory-mapped back for the
id join.  A store built by either package is reused by the other.

Unseen entities come back as zero rows with ``hit=False``, so they score
exactly the fixed effect.  A chunk that cannot be read (after bounded
retries of transient errors) is served as zeros too, with the rows
marked ``degraded``: the request is answered fixed-effect-only instead
of failing.  Each chunk read fires the ``serve.store_load`` fault seam
inside its retried attempt; retries, give-ups, unseen-entity rows and
degraded chunks count ``serve.store_retries``, ``serve.store_gave_up``,
``serve.entity_misses`` and ``serve.store_degraded``.  Without a writable spill dir the store holds one resident
[E, p] table.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from photon_ml_torch import telemetry
from photon_ml_torch.cache.plan_cache import atomic_savez
from photon_ml_torch.data.chunk_store import (
    ChunkStore,
    _open_npz_mmap,
    array_content_key,
    decode_array_chunk,
    encode_array_chunk,
    probe_spill_dir,
)
from photon_ml_torch.game.dataset import sorted_id_join
from photon_ml_torch.models.game import RandomEffectModel
from photon_ml_torch.reliability import faults
from photon_ml_torch.reliability.retry import run_with_retries

logger = logging.getLogger(__name__)

# On-disk serve-store format version (rides in the content key).
ENTITY_STORE_VERSION = 1


def _extract_rows(model: RandomEffectModel, lo: int, hi: int,
                  blocks_np: list[np.ndarray]) -> np.ndarray:
    """Coefficient rows [hi-lo, p] for global entity positions [lo, hi)."""
    g = model.grouping
    bucket = np.asarray(g.entity_bucket[lo:hi])
    slot = np.asarray(g.entity_slot[lo:hi])
    out = np.zeros((hi - lo, blocks_np[0].shape[-1]), np.float32)
    for b in np.unique(bucket):
        sel = bucket == b
        out[sel] = blocks_np[b][slot[sel]]
    return out


class EntityServeStore:
    """Per-entity coefficient rows behind an id join.  Construct with
    ``build``; ``lookup`` is the request path."""

    def __init__(self, name: str, ids: np.ndarray, dim: int,
                 entity_chunk: int, store: ChunkStore | None,
                 table: np.ndarray | None):
        self.name = name
        self._ids = ids                  # sorted unique (possibly mmap)
        self.dim = int(dim)
        self.entity_chunk = int(entity_chunk)
        self._store = store              # chunked disk tier, or
        self._table = table              # ...resident fallback
        self.n_entities = int(len(ids))
        self.lookups = 0
        self.misses = 0
        self.degraded_lookups = 0

    @property
    def spilled(self) -> bool:
        return self._store is not None

    @classmethod
    def build(cls, name: str, model: RandomEffectModel,
              spill_dir: str | None, entity_chunk: int = 4096,
              host_max_resident: int = 4) -> "EntityServeStore":
        if model.projection is not None:
            raise ValueError(
                f"random effect '{name}' is projected; the entity "
                "serve store holds width-uniform rows")
        g = model.grouping
        ids = np.asarray(g.entity_ids)
        blocks_np = [np.asarray(b, np.float32)
                     for b in model.coefficient_blocks]
        dim = blocks_np[0].shape[-1]
        E = len(ids)
        C = int(entity_chunk)
        n_chunks = max(1, -(-E // C))

        if probe_spill_dir(spill_dir) is None:
            table = _extract_rows(model, 0, E, blocks_np)
            logger.info("entity serve store '%s': resident (%d entities"
                        " x %d, no spill dir)", name, E, dim)
            return cls(name, ids, dim, C, None, table)

        key = "resrv-" + array_content_key(
            [ids] + blocks_np,
            {"entity_chunk": C, "dim": int(dim),
             "version": ENTITY_STORE_VERSION})

        def build_chunk(i: int) -> dict:
            lo = i * C
            return {"w": _extract_rows(model, lo, min(lo + C, E),
                                       blocks_np)}

        store = ChunkStore(spill_dir, key, n_chunks,
                           host_max_resident=host_max_resident,
                           rebuild=build_chunk,
                           codec=(encode_array_chunk, decode_array_chunk))
        missing = [i for i in range(n_chunks) if not store.has(i)]
        for i in missing:        # one chunk in flight: bounded ETL RSS
            store.put(i, build_chunk(i), keep_resident=False)

        index_path = os.path.join(store.dir, f"{key}-index.npz")
        ids_view = ids
        try:
            if not os.path.exists(index_path):
                atomic_savez(index_path,
                             {"kind": "entity_serve_index",
                              "version": ENTITY_STORE_VERSION,
                              "entity_chunk": C, "dim": int(dim)},
                             {"ids": ids})
            ids_view = _open_npz_mmap(index_path)["ids"]
        except Exception as e:
            # The index file is an optimization; the in-memory ids are
            # authoritative.
            logger.warning("entity serve store '%s': id index at %s "
                           "unavailable (%r); using resident ids",
                           name, index_path, e)
        logger.info(
            "entity serve store '%s': %d entities x %d in %d chunk(s) "
            "at %s (%d built, %d reused; host window %d)", name, E, dim,
            n_chunks, spill_dir, len(missing), n_chunks - len(missing),
            store.host_max_resident)
        return cls(name, ids_view, dim, C, store, None)

    def _chunk_rows(self, c: int):
        """One chunk's coefficient table, through the fault seam and the
        bounded retries (transient OSErrors retry; anything else goes to
        the caller's fallback)."""
        def attempt():
            faults.fire("serve.store_load", chunk=c, store=self.name)
            return self._store.get(c)["w"]

        return run_with_retries(
            attempt, label=f"serve store '{self.name}' chunk {c}",
            retry_counter="serve.store_retries",
            gave_up_counter="serve.store_gave_up")

    def lookup(self, query_ids: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows [m, p] float32, hit [m] bool, degraded [m] bool) for
        ``query_ids``; misses and unreadable chunks give zero rows."""
        query_ids = np.asarray(query_ids)
        m = len(query_ids)
        g = sorted_id_join(np.asarray(self._ids), query_ids)
        hit = g >= 0
        out = np.zeros((m, self.dim), np.float32)
        degraded = np.zeros(m, bool)
        self.lookups += m
        n_miss = int(m - hit.sum())
        if n_miss:
            self.misses += n_miss
            telemetry.count("serve.entity_misses", n_miss)
        if self._table is not None:
            out[hit] = self._table[g[hit]]
            return out, hit, degraded
        gh = g[hit]
        rows_out = np.nonzero(hit)[0]
        for c in np.unique(gh // self.entity_chunk):
            sel = (gh // self.entity_chunk) == c
            try:
                w = self._chunk_rows(int(c))
            except Exception as e:
                # Fixed-effect-only fallback for the rows this chunk
                # would have served; the store stays up.
                degraded[rows_out[sel]] = True
                self.degraded_lookups += int(sel.sum())
                telemetry.count("serve.store_degraded")
                logger.warning(
                    "entity serve store '%s': chunk %d unreadable "
                    "(%r); serving fixed-effect-only for %d row(s)",
                    self.name, int(c), e, int(sel.sum()))
                continue
            out[rows_out[sel]] = w[gh[sel] - int(c) * self.entity_chunk]
        return out, hit, degraded

    def stats(self) -> dict:
        st = {"name": self.name, "entities": self.n_entities,
              "dim": self.dim, "spilled": self.spilled,
              "lookups": self.lookups, "misses": self.misses,
              "degraded_lookups": self.degraded_lookups}
        if self._store is not None:
            st.update({"chunk_loads": self._store.loads,
                       "window_hits": self._store.hits,
                       "peak_resident": self._store.peak_resident})
        return st

    def close(self) -> None:
        """Drop the decoded-chunk window; files stay on disk."""
        if self._store is not None:
            self._store.drop_resident()

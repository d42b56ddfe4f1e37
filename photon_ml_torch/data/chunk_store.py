"""Disk-backed chunk store: the third tier under ``data.chunked_batch``.

Counterpart of ``photon_ml_tpu/data/chunk_store.py``: disk → host
window → card.

- **One atomic ``.npz`` a chunk** under ``<spill_dir>/chunks/``, written
  with ``cache.plan_cache.atomic_savez`` and named by a content key of
  the exact build inputs × the build configuration × the format
  version (``store_key``, ``array_content_key``), so a spill dir is also
  a warm-ETL artifact.  Offsets are not in the payload:
  ``ChunkedBatch`` overlays the current ones at access time.
- **Memory-mapped loads**: members are stored, not deflated, so each is
  a whole ``.npy`` at a known offset and loads as an ``np.memmap``; a
  parse surprise falls back to a copying load, a read failure to a
  rebuild from lineage (``rebuild(i)``) and a re-spill.
- **LRU host window** of ``host_max_resident`` decoded chunks, or one
  budget over several stores (``SharedChunkWindow``).
- **Reader accounting** (``begin_read`` / ``end_read`` /
  ``assert_quiesced``): the prefetch thread registers as a reader, and
  freeing chunks under a live reader is a loud error.
- **Fault seams** ``store.spill`` and ``store.load`` (``reliability
  .faults``), inside the bounded retry of transient I/O.

The keys, file names and member layout are the JAX package's, so a
spill dir built by either package is reused by the other without a
rebuild.  Counters (``loads``, ``hits``, ``rebuilds``, ``spills``,
``peak_resident``, ``access_log``) are the store's own record; with a
telemetry session the same events count as ``store.*`` (and
``store.mmap_loads``/``copy_loads``, ``store.bytes_read``,
``store.bytes_spilled``) and ``reliability.*``.
"""

from __future__ import annotations

import errno
import hashlib
import json
import logging
import os
import shutil
import struct
import threading
import zipfile
from collections import OrderedDict

import numpy as np

from photon_ml_torch import telemetry
from photon_ml_torch.cache.plan_cache import atomic_savez
from photon_ml_torch.reliability import faults as _faults
from photon_ml_torch.reliability import retry as _retry

logger = logging.getLogger(__name__)

CHUNK_FORMAT_VERSION = 1

# Per-piece leaves spilled verbatim; ``offsets`` is CD state, overlaid
# by ``ChunkedBatch.chunk``.
_LEAF_FIELDS = ("values", "col_ids", "labels", "weights", "mask")

# The environment default of the spill dir, shared with the JAX package.
SPILL_DIR_ENV = "PHOTON_ML_TPU_SPILL_DIR"


def release_free_heap() -> None:
    """Return freed allocator arenas to the OS (glibc ``malloc_trim``),
    so a one-chunk-at-a-time spill build's churn does not read as
    resident memory; a no-op off glibc."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # photon-lint: disable=swallowed-exception (non-glibc platforms: nothing to trim)
        pass


def resolve_spill_dir(spill_dir: str | None) -> str | None:
    """Explicit argument, else ``$PHOTON_ML_TPU_SPILL_DIR``, else None.
    Applied by the config and estimator layer only, so library callers
    building a resident baseline are never flipped by the
    environment."""
    if spill_dir is not None:
        return spill_dir
    from photon_ml_torch.config import read_env

    return read_env(SPILL_DIR_ENV) or None


class ChunkStoreSpillError(RuntimeError):
    """A spill write failed for capacity, not transience: one actionable
    error naming the spill dir, the bytes the chunk needed and the bytes
    free."""

    def __init__(self, spill_dir: str, bytes_needed: int,
                 bytes_free: int | None):
        self.spill_dir = spill_dir
        self.bytes_needed = int(bytes_needed)
        self.bytes_free = bytes_free
        free = ("unknown" if bytes_free is None
                else f"{bytes_free / 1e6:.1f} MB")
        super().__init__(
            f"chunk spill to {spill_dir!r} out of space: chunk needs "
            f"~{bytes_needed / 1e6:.1f} MB, {free} free — free disk "
            "space, point spill_dir/$PHOTON_ML_TPU_SPILL_DIR at a "
            "larger volume, or raise chunk granularity "
            "(chunk_rows / re_chunk_entities) to shrink per-chunk "
            "spill size")


def _free_bytes(path: str) -> int | None:
    """Free bytes on the filesystem of ``path`` (its nearest existing
    ancestor), or None."""
    p = os.path.abspath(path)
    while p and not os.path.exists(p):
        parent = os.path.dirname(p)
        if parent == p:
            break
        p = parent
    try:
        return shutil.disk_usage(p).free
    except OSError:  # photon-lint: disable=swallowed-exception (free-space probe is advisory; the spill error then says 'unknown')
        return None


# Spill dirs already warned about: one warning a dir a process.
_DEGRADED_DIRS: set[str] = set()
_DEGRADED_LOCK = threading.Lock()


def probe_spill_dir(spill_dir: str | None) -> str | None:
    """``spill_dir`` if it is writable, else None: the documented
    degradation of an unwritable spill dir to the host-resident path,
    with one warning a dir (a tier choice, not a device fallback)."""
    if spill_dir is None:
        return None
    # A unique probe name: spill dirs are shared across runs.
    probe = os.path.join(spill_dir, "chunks",
                         f".probe-{os.getpid()}-{threading.get_ident()}")
    try:
        os.makedirs(os.path.dirname(probe), exist_ok=True)
        with open(probe, "w") as f:
            f.write("ok")
        os.remove(probe)
        return spill_dir
    except OSError as e:
        with _DEGRADED_LOCK:
            first = spill_dir not in _DEGRADED_DIRS
            _DEGRADED_DIRS.add(spill_dir)
        if first:
            logger.warning(
                "spill dir %r is not writable (%r); DEGRADING to the "
                "host-resident path — host RSS is no longer bounded by "
                "the chunk window for this build", spill_dir, e)
            telemetry.count("reliability.degraded")
        return None


def store_key(rows, labels: np.ndarray, weights: np.ndarray, dim: int,
              chunk_rows: int, layout: str, n_dev: int,
              row_capacity: int, drop_ell_with_grr: bool = True) -> str:
    """Content fingerprint of everything that shapes the spilled chunk
    payloads: exact inputs × build configuration (offsets excluded).
    ``row_capacity`` is part of it, so the ELL capacity decides whether
    the packages share chunk files."""
    from photon_ml_torch.cache.plan_cache import dataset_fingerprint

    cfg_dict = {"chunk_rows": int(chunk_rows), "layout": layout,
                "n_dev": int(n_dev), "k": int(row_capacity)}
    if layout == "grr":
        from photon_ml_torch.data.grr import PLANNER_VERSION

        cfg_dict["planner"] = PLANNER_VERSION
        cfg_dict["drop_ell"] = bool(drop_ell_with_grr)
    fp = dataset_fingerprint(
        np.asarray(rows.indptr), np.asarray(rows.vals, np.float32), dim,
        extra=(np.asarray(rows.cols), np.asarray(labels, np.float32),
               np.asarray(weights, np.float32)))
    cfg = hashlib.blake2b(
        json.dumps(cfg_dict, sort_keys=True).encode(),
        digest_size=6).hexdigest()
    return f"{fp}-{cfg}"


def encode_chunk(chunk) -> tuple[dict, dict]:
    """Chunk (a ``SparseBatch`` with host leaves, or a list of per-device
    pieces) → (manifest, arrays) for ``atomic_savez``."""
    from photon_ml_torch.cache.plan_cache import _encode_node

    pieces = chunk if isinstance(chunk, list) else [chunk]
    arrays: dict = {}
    metas = []
    for j, b in enumerate(pieces):
        pfx = f"p{j}."
        for f in _LEAF_FIELDS:
            arrays[pfx + f] = np.asarray(getattr(b, f))
        metas.append({
            "dim": int(b.dim),
            "grr": _encode_node(b.grr, pfx + "g.", arrays),
        })
    meta = {"version": CHUNK_FORMAT_VERSION,
            "mesh": isinstance(chunk, list), "pieces": metas}
    return meta, arrays


def decode_chunk(meta: dict, arrays):
    """Inverse of ``encode_chunk``; leaves may stay memmap views.
    Offsets come back zero (``ChunkedBatch.chunk`` overlays them)."""
    from photon_ml_torch.cache.plan_cache import _decode_node
    from photon_ml_torch.data.batch import SparseBatch

    if meta.get("version") != CHUNK_FORMAT_VERSION:
        raise ValueError(f"chunk format {meta.get('version')!r} != "
                         f"{CHUNK_FORMAT_VERSION}")
    pieces = []
    for j, pm in enumerate(meta["pieces"]):
        pfx = f"p{j}."
        labels = np.asarray(arrays[pfx + "labels"])
        pieces.append(SparseBatch(
            values=arrays[pfx + "values"],
            col_ids=arrays[pfx + "col_ids"],
            labels=labels,
            weights=arrays[pfx + "weights"],
            offsets=np.zeros(labels.shape[0], np.float32),
            mask=arrays[pfx + "mask"],
            dim=int(pm["dim"]),
            grr=_decode_node(pm["grr"], pfx + "g.", arrays),
        ))
    return pieces if meta["mesh"] else pieces[0]


def encode_array_chunk(chunk: dict) -> tuple[dict, dict]:
    """Flat name → ndarray chunk → (manifest, arrays)."""
    arrays = {k: np.asarray(v) for k, v in chunk.items()}
    meta = {"version": CHUNK_FORMAT_VERSION, "kind": "arrays",
            "keys": sorted(arrays)}
    return meta, arrays


def decode_array_chunk(meta: dict, arrays) -> dict:
    """Inverse of ``encode_array_chunk``; memmap views pass through."""
    if meta.get("version") != CHUNK_FORMAT_VERSION:
        raise ValueError(f"chunk format {meta.get('version')!r} != "
                         f"{CHUNK_FORMAT_VERSION}")
    if meta.get("kind") != "arrays":
        raise ValueError(f"chunk kind {meta.get('kind')!r} != 'arrays'")
    return {k: arrays[k] for k in meta["keys"]}


# Entity-block chunk leaves (streamed random effects): ``C`` padded
# entity problems of one size bucket, x [C, cap, p] and [C, cap] scalar
# planes.  Offsets are CD state, scattered in when a chunk is assembled.
_ENTITY_LEAF_FIELDS = ("x", "labels", "weights", "mask")


def encode_entity_chunk(chunk: dict) -> tuple[dict, dict]:
    """Entity-block chunk (``x``/``labels``/``weights``/``mask``) →
    (manifest, arrays)."""
    arrays = {f: np.asarray(chunk[f]) for f in _ENTITY_LEAF_FIELDS}
    meta = {"version": CHUNK_FORMAT_VERSION, "kind": "entity_blocks"}
    return meta, arrays


def decode_entity_chunk(meta: dict, arrays) -> dict:
    """Inverse of ``encode_entity_chunk``; memmap views pass through."""
    if meta.get("version") != CHUNK_FORMAT_VERSION:
        raise ValueError(f"chunk format {meta.get('version')!r} != "
                         f"{CHUNK_FORMAT_VERSION}")
    if meta.get("kind") != "entity_blocks":
        raise ValueError(
            f"chunk kind {meta.get('kind')!r} != 'entity_blocks'")
    return {f: arrays[f] for f in _ENTITY_LEAF_FIELDS}


ENTITY_CHUNK_CODEC = (encode_entity_chunk, decode_entity_chunk)


# Fused-cycle sidecar chunks: per example chunk, every random effect's
# per-row entity index and (projected) feature plane, "<coordinate>.x"
# [R, p] and "<coordinate>.idx" [R], beside the fixed-effect chunk of
# the same rows, so one prefetched pair feeds a whole fused cycle.


def encode_fused_chunk(chunk: dict) -> tuple[dict, dict]:
    """Fused-cycle sidecar chunk → (manifest, arrays)."""
    arrays = {k: np.asarray(v) for k, v in chunk.items()}
    meta = {"version": CHUNK_FORMAT_VERSION, "kind": "fused_rows",
            "keys": sorted(arrays)}
    return meta, arrays


def decode_fused_chunk(meta: dict, arrays) -> dict:
    """Inverse of ``encode_fused_chunk``; memmap views pass through."""
    if meta.get("version") != CHUNK_FORMAT_VERSION:
        raise ValueError(f"chunk format {meta.get('version')!r} != "
                         f"{CHUNK_FORMAT_VERSION}")
    if meta.get("kind") != "fused_rows":
        raise ValueError(f"chunk kind {meta.get('kind')!r} != "
                         "'fused_rows'")
    return {k: arrays[k] for k in meta["keys"]}


FUSED_CHUNK_CODEC = (encode_fused_chunk, decode_fused_chunk)


def array_content_key(arrays, cfg: dict) -> str:
    """Content fingerprint of chunk payloads derived from host arrays:
    exact input bytes (with dtype/shape framing) × build configuration."""
    h = hashlib.blake2b(digest_size=10)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.view(np.uint8).reshape(-1))
    cfg_h = hashlib.blake2b(
        json.dumps(cfg, sort_keys=True).encode(),
        digest_size=6).hexdigest()
    return f"{h.hexdigest()}-{cfg_h}"


# Parsed member index per (path, mtime_ns, size): a store re-opens the
# same files on every window miss, and the zip + npy header walk cannot
# change without the stat signature changing.
_NPZ_INDEX: dict = {}
_NPZ_INDEX_LOCK = threading.Lock()
_NPZ_INDEX_MAX = 4096


def _npz_index(path: str) -> tuple:
    """[(member name, dtype, shape, payload offset)] of an uncompressed
    ``.npz``: each member is a whole ``.npy`` stored at a knowable
    offset, found from the zip local header and the npy header.  Cached
    by stat signature; raises on anything unexpected."""
    st = os.stat(path)
    sig = (path, st.st_mtime_ns, st.st_size)
    with _NPZ_INDEX_LOCK:
        idx = _NPZ_INDEX.get(sig)
    if idx is not None:
        return idx
    members = []
    with open(path, "rb") as fh, zipfile.ZipFile(fh) as zf:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"compressed member {info.filename!r}")
            fh.seek(info.header_offset)
            hdr = fh.read(30)
            if len(hdr) != 30 or hdr[:4] != b"PK\x03\x04":
                raise ValueError("bad zip local header")
            name_len, extra_len = struct.unpack("<HH", hdr[26:30])
            fh.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(fh)
            if version == (1, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_1_0(fh)
            elif version == (2, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_2_0(fh)
            else:
                raise ValueError(f"npy format {version}")
            if fortran or dtype.hasobject:
                raise ValueError("unsupported npy layout")
            name = info.filename
            if name.endswith(".npy"):
                name = name[:-4]
            members.append((name, dtype, shape, fh.tell()))
    idx = tuple(members)
    with _NPZ_INDEX_LOCK:
        if len(_NPZ_INDEX) >= _NPZ_INDEX_MAX:
            _NPZ_INDEX.clear()
        _NPZ_INDEX[sig] = idx
    return idx


def _open_npz_mmap(path: str) -> dict:
    """Memory-mapped views of every member of an uncompressed ``.npz``.
    Raises on anything unexpected (the caller falls back to a copying
    load)."""
    return {name: np.memmap(path, mode="r", dtype=dtype, shape=shape,
                            offset=offset)
            for name, dtype, shape, offset in _npz_index(path)}


class SharedChunkWindow:
    """One LRU residency budget over several chunk stores: admission
    evicts the least recently used chunk of any member store.  Lock
    order: the group's lock first, a store's second; eviction is a
    reference drop, so a reader holding a chunk is never invalidated."""

    def __init__(self, budget: int):
        self.budget = max(1, int(budget))
        self._lock = threading.RLock()
        self._order: OrderedDict = OrderedDict()  # (id(store), i) -> store
        self.evictions = 0

    @property
    def n_resident(self) -> int:
        with self._lock:
            return len(self._order)

    def admit(self, store: "ChunkStore", i: int) -> None:
        with self._lock:
            key = (id(store), i)
            if key in self._order:
                self._order.move_to_end(key)
                return
            while len(self._order) >= self.budget:
                (_, j), victim = self._order.popitem(last=False)
                victim._drop(j)
                self.evictions += 1
            self._order[key] = store

    def touch(self, store: "ChunkStore", i: int) -> None:
        with self._lock:
            key = (id(store), i)
            if key in self._order:
                self._order.move_to_end(key)

    def drop_store(self, store: "ChunkStore") -> None:
        """Forget every entry of ``store``."""
        with self._lock:
            for key in [k for k, s in self._order.items() if s is store]:
                del self._order[key]


class ChunkStore:
    """Spilled chunks on disk + an LRU window of decoded host chunks.

    ``rebuild(i) -> chunk`` is the lineage fallback for a missing or
    unreadable file.  ``codec`` is an (encode, decode) pair; the default
    is the training codec (``encode_chunk`` / ``decode_chunk``).  ``get``
    is safe from the prefetch thread and the main thread.
    """

    def __init__(self, spill_dir: str, key: str, n_chunks: int,
                 host_max_resident: int = 2, rebuild=None, codec=None,
                 window_group: SharedChunkWindow | None = None):
        self.dir = os.path.join(spill_dir, "chunks")
        self.key = key
        self.n_chunks = n_chunks
        self.host_max_resident = max(1, int(host_max_resident))
        self._rebuild = rebuild
        self._window_group = window_group
        self._encode, self._decode = codec or (encode_chunk, decode_chunk)
        self._resident: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self._readers = 0
        self.loads = 0        # disk loads (misses)
        self.hits = 0         # window hits
        self.rebuilds = 0     # lineage rebuilds taken
        self.spills = 0       # chunk files written
        self.peak_resident = 0
        self.access_log: list[int] = []   # miss and hit order

    def path(self, i: int) -> str:
        return os.path.join(
            self.dir, f"{self.key}-c{i:05d}-v{CHUNK_FORMAT_VERSION}.npz")

    def has(self, i: int) -> bool:
        return os.path.exists(self.path(i))

    # -- window ------------------------------------------------------------

    @property
    def n_resident(self) -> int:
        with self._lock:
            return len(self._resident)

    @property
    def resident_nbytes(self) -> int:
        """Anonymous host bytes the window pins (memmap leaves count
        zero: their pages are file-backed)."""
        total = 0
        with self._lock:
            chunks = list(self._resident.values())
        for ch in chunks:
            if isinstance(ch, dict):
                leaves = list(ch.values())
            else:
                leaves = [getattr(b, f)
                          for b in (ch if isinstance(ch, list) else [ch])
                          for f in _LEAF_FIELDS]
            for a in leaves:
                if not isinstance(a, np.memmap):
                    total += np.asarray(a).nbytes
        return total

    def _admit(self, i: int, chunk) -> None:
        if self._window_group is not None:
            with self._lock:
                self._resident[i] = chunk
                self._resident.move_to_end(i)
                self.peak_resident = max(self.peak_resident,
                                         len(self._resident))
            self._window_group.admit(self, i)
            return
        with self._lock:
            if i in self._resident:
                self._resident.move_to_end(i)
                return
            while len(self._resident) >= self.host_max_resident:
                self._resident.popitem(last=False)
            self._resident[i] = chunk
            self.peak_resident = max(self.peak_resident,
                                     len(self._resident))

    def _drop(self, i: int) -> None:
        """Group-eviction callback."""
        with self._lock:
            self._resident.pop(i, None)

    def join_window_group(self, group: SharedChunkWindow | None) -> None:
        """Install (or clear) a shared residency group on a live store;
        resident chunks register in their LRU order."""
        old = self._window_group
        if old is not None and old is not group:
            old.drop_store(self)
        self._window_group = group
        if group is None:
            return
        with self._lock:
            resident = list(self._resident)
        for i in resident:
            group.admit(self, i)

    def drop_resident(self) -> None:
        """Free the whole window (only when quiesced)."""
        self.assert_quiesced()
        with self._lock:
            self._resident.clear()
        if self._window_group is not None:
            self._window_group.drop_store(self)

    # -- reader accounting -------------------------------------------------

    def begin_read(self) -> None:
        with self._lock:
            self._readers += 1

    def end_read(self) -> None:
        with self._lock:
            self._readers -= 1

    def assert_quiesced(self) -> None:
        """Raise if a prefetch reader is still active."""
        with self._lock:
            if self._readers:
                raise RuntimeError(
                    f"chunk store has {self._readers} active prefetch "
                    "reader(s); quiesce the pipeline before freeing "
                    "chunks")

    # -- spill / load ------------------------------------------------------

    def put(self, i: int, chunk, keep_resident: bool | None = None) -> None:
        """Spill chunk ``i`` (atomic write, transient errors retried) and
        optionally admit it (default: the first ``host_max_resident``
        chunks, the ones a sweep wants first)."""
        meta, arrays = self._encode(chunk)
        path = self.path(i)

        def _write():
            # Inside the attempt: an injected transient error takes the
            # same retry a real one would.
            _faults.fire("store.spill", path=path, chunk=i)
            atomic_savez(path, meta, arrays)

        try:
            _retry.run_with_retries(_write, f"chunk spill {path}")
        except OSError as e:
            if e.errno == errno.ENOSPC:
                telemetry.count("reliability.actionable_errors")
                raise ChunkStoreSpillError(
                    os.path.dirname(self.dir) or self.dir,
                    sum(int(np.asarray(a).nbytes)
                        for a in arrays.values()),
                    _free_bytes(self.dir)) from e
            raise
        with self._lock:
            self.spills += 1
        telemetry.count("store.spills")
        if telemetry.active() is not None:
            try:
                telemetry.count("store.bytes_spilled",
                                os.path.getsize(path))
            except OSError:  # photon-lint: disable=swallowed-exception (racing cleanup; the size metric is best-effort)
                pass
        if keep_resident is None:
            keep_resident = i < self.host_max_resident
        if keep_resident:
            self._admit(i, chunk)

    def get(self, i: int):
        """Chunk ``i``: window hit, else memory-mapped disk load, else
        rebuild from lineage + re-spill."""
        with self._lock:
            hit = self._resident.get(i)
            if hit is not None:
                self._resident.move_to_end(i)
                self.hits += 1
                self.access_log.append(i)
        if hit is not None:
            telemetry.count("store.hits")
            if self._window_group is not None:
                self._window_group.touch(self, i)
            return hit
        chunk = self._load(i)
        self._admit(i, chunk)
        return chunk

    def _load(self, i: int):
        path = self.path(i)
        with self._lock:
            self.access_log.append(i)
            self.loads += 1
        telemetry.count("store.loads")

        def _attempt():
            _faults.fire("store.load", path=path, chunk=i)
            try:
                arrays = _open_npz_mmap(path)
                telemetry.count("store.mmap_loads")
            except (zipfile.BadZipFile, ValueError, OSError):
                arrays = dict(np.load(path, allow_pickle=False))
                telemetry.count("store.copy_loads")
            if telemetry.active() is not None:
                try:
                    telemetry.count("store.bytes_read",
                                    os.path.getsize(path))
                except OSError:  # photon-lint: disable=swallowed-exception (best-effort size metric; racing cleanup)
                    pass
            meta = json.loads(bytes(np.asarray(arrays["__meta__"]))
                              .decode())
            return self._decode(meta, arrays)

        try:
            # Transient read errors retry with backoff; corruption and a
            # missing file go straight to the rebuild.
            return _retry.run_with_retries(_attempt, f"chunk load {path}")
        except Exception as e:
            if self._rebuild is None:
                raise
            logger.warning("chunk store: unreadable chunk %s (%r); "
                           "rebuilding", path, e)
            with self._lock:
                self.rebuilds += 1
            telemetry.count("store.rebuilds")
            chunk = self._rebuild(i)
            try:
                self.put(i, chunk, keep_resident=False)
            except Exception as we:   # the re-spill is best-effort
                logger.warning("chunk store: re-spill of chunk %d "
                               "failed (%r)", i, we)
            return chunk

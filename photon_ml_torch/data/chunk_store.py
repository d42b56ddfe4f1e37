"""Disk-backed chunk store: what the serving entity store needs of it.

Counterpart of ``photon_ml_tpu/data/chunk_store.py``.  Chunks are atomic
uncompressed ``.npz`` files under ``<spill_dir>/chunks/``, named by a
content key and the format version, memory-mapped back on load, and
kept in a small LRU window of decoded chunks.  A missing or unreadable
file is rebuilt from lineage (``rebuild(i)``) and re-spilled.

The content keys (``array_content_key``), file names and member layout
are the JAX package's, so a spill dir built by one package is reused by
the other without rebuilding a chunk.  The training codecs, the shared
window group and the fault seams come with the training path.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import threading
import zipfile
from collections import OrderedDict

import numpy as np

from photon_ml_torch.cache.plan_cache import atomic_savez
from photon_ml_torch.reliability import retry as _retry

logger = logging.getLogger(__name__)

CHUNK_FORMAT_VERSION = 1


def probe_spill_dir(spill_dir: str | None) -> str | None:
    """``spill_dir`` if it is writable, else None (the caller degrades
    to a host-resident path, with one warning here)."""
    if spill_dir is None:
        return None
    probe = os.path.join(spill_dir, "chunks",
                         f".probe-{os.getpid()}-{threading.get_ident()}")
    try:
        os.makedirs(os.path.dirname(probe), exist_ok=True)
        with open(probe, "w") as f:
            f.write("ok")
        os.remove(probe)
        return spill_dir
    except OSError as e:
        logger.warning("spill dir %r is not writable (%r); degrading to "
                       "the host-resident path", spill_dir, e)
        return None


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


class ChunkStore:
    """Spilled chunks on disk + an LRU window of decoded host chunks.

    ``rebuild(i) -> chunk`` is the lineage fallback for a missing or
    unreadable file.  ``get`` is thread-safe; the counters (``loads``,
    ``hits``, ``spills``, ``peak_resident``) feed the entity store's
    stats and the window-bound and warm-reuse tests.
    """

    def __init__(self, spill_dir: str, key: str, n_chunks: int,
                 host_max_resident: int = 2, rebuild=None, codec=None):
        self.dir = os.path.join(spill_dir, "chunks")
        self.key = key
        self.n_chunks = n_chunks
        self.host_max_resident = max(1, int(host_max_resident))
        self._rebuild = rebuild
        self._encode, self._decode = codec or (encode_array_chunk,
                                               decode_array_chunk)
        self._resident: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.loads = 0
        self.hits = 0
        self.spills = 0
        self.peak_resident = 0

    def path(self, i: int) -> str:
        return os.path.join(
            self.dir, f"{self.key}-c{i:05d}-v{CHUNK_FORMAT_VERSION}.npz")

    def has(self, i: int) -> bool:
        return os.path.exists(self.path(i))

    def _admit(self, i: int, chunk) -> None:
        with self._lock:
            if i in self._resident:
                self._resident.move_to_end(i)
                return
            while len(self._resident) >= self.host_max_resident:
                self._resident.popitem(last=False)
            self._resident[i] = chunk
            self.peak_resident = max(self.peak_resident,
                                     len(self._resident))

    def drop_resident(self) -> None:
        with self._lock:
            self._resident.clear()

    def put(self, i: int, chunk, keep_resident: bool | None = None) -> None:
        """Spill chunk ``i`` (atomic write, transient errors retried)
        and optionally admit it to the window."""
        meta, arrays = self._encode(chunk)
        path = self.path(i)
        _retry.run_with_retries(lambda: atomic_savez(path, meta, arrays),
                                f"chunk spill {path}")
        with self._lock:
            self.spills += 1
        if keep_resident is None:
            keep_resident = i < self.host_max_resident
        if keep_resident:
            self._admit(i, chunk)

    def get(self, i: int):
        """Chunk ``i``: window hit, else memory-mapped disk load, else
        rebuild from lineage + re-spill."""
        with self._lock:
            if i in self._resident:
                self._resident.move_to_end(i)
                self.hits += 1
                return self._resident[i]
        chunk = self._load(i)
        self._admit(i, chunk)
        return chunk

    def _load(self, i: int):
        path = self.path(i)
        with self._lock:
            self.loads += 1

        def _attempt():
            try:
                arrays = _open_npz_mmap(path)
            except (zipfile.BadZipFile, ValueError, OSError):
                arrays = dict(np.load(path, allow_pickle=False))
            meta = json.loads(bytes(np.asarray(arrays["__meta__"]))
                              .decode())
            return self._decode(meta, arrays)

        try:
            return _retry.run_with_retries(_attempt, f"chunk load {path}")
        except Exception as e:
            if self._rebuild is None:
                raise
            logger.warning("chunk store: unreadable chunk %s (%r); "
                           "rebuilding", path, e)
            chunk = self._rebuild(i)
            try:
                self.put(i, chunk, keep_resident=False)
            except Exception as we:   # re-spill is best-effort
                logger.warning("chunk store: re-spill of chunk %d "
                               "failed (%r)", i, we)
            return chunk

"""Chunked score sinks: the scoring driver's output writers.

Counterpart of ``photon_ml_tpu/io/score_sink.py`` (host code).  Both
sinks take finished chunks, so output memory is bounded by one chunk:

- ``NpzScoreSink`` — the ``.npz`` contract (``scores`` /
  ``predictions`` / ``labels``), written incrementally: each member is a
  preallocated ``.npy`` memmap, zipped STORED into the final ``.npz`` at
  close (``np.load`` reads it like any ``savez`` output).
- ``AvroScoreSink`` — an Avro object container of
  ``ScoringResultAvro`` records with ONE BLOCK A CHUNK, encoded by a
  schema-specific batch encoder straight from the arrays.

The reference's ``telemetry.count`` calls (rows, blocks and bytes
written) come with the telemetry tier, ROADMAP A8b.
"""

from __future__ import annotations

import io
import os
import struct
import zipfile

import numpy as np

from photon_ml_torch.io.avro import MAGIC, SYNC_SIZE, Schema, write_long
from photon_ml_torch.io.avro_schemas import SCORING_RESULT_SCHEMA


class NpzScoreSink:
    """Incremental ``.npz`` writer for the scoring driver's output
    contract.  ``write(lo, hi, ...)`` may arrive in any order (ranges
    must tile [0, n)); ``close()`` assembles the zip."""

    _MEMBERS = ("scores", "predictions", "labels")

    def __init__(self, path: str, n: int):
        self.path = path
        self.n = int(n)
        self._tmp = {}
        self._mm = {}
        self._failed = False
        for name in self._MEMBERS:
            tmp = path + f".{name}.tmp.npy"
            self._mm[name] = np.lib.format.open_memmap(
                tmp, mode="w+", dtype=np.float32, shape=(self.n,))
            self._tmp[name] = tmp
        self._written = 0

    def write(self, lo: int, hi: int, margins, predictions,
              labels, ids: dict | None = None) -> None:
        del ids   # the npz contract carries no entity-id columns
        try:
            self._mm["scores"][lo:hi] = np.asarray(margins, np.float32)
            self._mm["predictions"][lo:hi] = np.asarray(predictions,
                                                        np.float32)
            self._mm["labels"][lo:hi] = np.asarray(labels, np.float32)
        except BaseException:
            # A failed chunk write (shape mismatch, I/O error on a
            # member) poisons the sink: close() must refuse to
            # assemble the zip instead of publishing rows this chunk
            # never landed.
            self._failed = True
            raise
        self._written += hi - lo

    def close(self) -> None:
        if self._failed or self._written != self.n:
            self._cleanup()
            raise ValueError(
                f"npz sink: {self._written} of {self.n} rows written"
                + (" (a chunk write failed)" if self._failed else ""))
        for mm in self._mm.values():
            mm.flush()
        self._mm.clear()
        tmp_zip = self.path + ".tmp"
        try:
            with zipfile.ZipFile(tmp_zip, "w", zipfile.ZIP_STORED) as zf:
                for name in self._MEMBERS:
                    zf.write(self._tmp[name], arcname=name + ".npy")
            os.replace(tmp_zip, self.path)
        finally:
            try:
                os.remove(tmp_zip)
            except OSError:  # photon-lint: disable=swallowed-exception (tmp already os.replace'd or never created)
                pass
            self._cleanup()

    def _cleanup(self) -> None:
        self._mm.clear()
        for tmp in self._tmp.values():
            try:
                os.remove(tmp)
            except OSError:  # photon-lint: disable=swallowed-exception (idempotent cleanup; member tmp may already be gone)
                pass

    def abort(self) -> None:
        self._cleanup()


def _encode_scoring_block(uids, predictions, labels, ids: dict) -> bytes:
    """One Avro block's worth of ``ScoringResultAvro`` records, encoded
    by direct struct packing in schema field order (uid long,
    predictionScore double, label union[null,double], ids map<string>).

    ``ids``: entity-key → [rows] integer array (stringified per the
    driver's convention).  The per-row work is this loop and nothing
    else — no dicts, no recursive schema dispatch."""
    out = io.BytesIO()
    w = out.write
    preds = np.asarray(predictions, np.float64)
    labs = None if labels is None else np.asarray(labels, np.float64)
    id_items = [(k.encode("utf-8"), np.asarray(v)) for k, v in ids.items()]
    pack_d = struct.Struct("<d").pack
    for j, uid in enumerate(np.asarray(uids, np.int64)):
        write_long(out, int(uid))
        w(pack_d(preds[j]))
        if labs is None:
            w(b"\x00")                       # union branch 0: null
        else:
            w(b"\x02")                       # union branch 1 (zigzag 1)
            w(pack_d(labs[j]))
        if id_items:
            write_long(out, len(id_items))
            for key, col in id_items:
                write_long(out, len(key))
                w(key)
                sval = str(int(col[j])).encode("utf-8")
                write_long(out, len(sval))
                w(sval)
        w(b"\x00")                           # map terminator
    return out.getvalue()


class AvroScoreSink:
    """Avro object-container sink: one container block per chunk.

    The container header/sync framing matches ``io.avro
    .write_container``; blocks may arrive in any order (each is
    self-delimited), deflate-compressed by default like the reference's
    output files."""

    def __init__(self, path: str, ids_keys: tuple = (),
                 codec: str = "deflate",
                 schema: Schema = SCORING_RESULT_SCHEMA):
        import zlib

        if codec not in ("null", "deflate"):
            raise ValueError(f"unsupported codec {codec!r}")
        self._zlib = zlib
        self.path = path
        self.codec = codec
        self.ids_keys = tuple(ids_keys)
        self._sync = os.urandom(SYNC_SIZE)
        self._tmp = path + ".tmp"
        self._f = open(self._tmp, "wb")
        self._f.write(MAGIC)
        from photon_ml_torch.io.avro import _META_SCHEMA, _encode

        _encode(_META_SCHEMA, _META_SCHEMA.root,
                {"avro.schema": schema.to_json().encode(),
                 "avro.codec": codec.encode()}, self._f)
        self._f.write(self._sync)
        self.records_written = 0
        self.blocks_written = 0
        self._failed = False

    def write(self, lo: int, hi: int, margins, predictions,
              labels, ids: dict | None = None) -> None:
        del margins   # the Avro record carries mean-space scores only
        count = hi - lo
        if count <= 0:
            return
        ids = ids or {}
        if self.ids_keys:
            # The declared keys fix the emitted id-map contents and
            # order (deterministic blocks regardless of caller dict
            # ordering).
            ids = {k: ids[k] for k in self.ids_keys}
        payload = _encode_scoring_block(
            np.arange(lo, hi, dtype=np.int64), predictions, labels, ids)
        if self.codec == "deflate":
            c = self._zlib.compressobj(wbits=-15)
            payload = c.compress(payload) + c.flush()
        block_start = self._f.tell()
        try:
            write_long(self._f, count)
            write_long(self._f, len(payload))
            self._f.write(payload)
            self._f.write(self._sync)
        except BaseException:
            # Torn-block rollback: truncate back to the last block
            # boundary so the container stays valid, and poison the
            # sink — close() refuses to publish short data.
            self._failed = True
            try:
                self._f.seek(block_start)
                self._f.truncate()
            except (OSError, ValueError):  # photon-lint: disable=swallowed-exception (rollback is best-effort on a failing file; the sink is poisoned and close() aborts)
                pass
            raise
        self.records_written += count
        self.blocks_written += 1

    def close(self) -> None:
        if self._failed:
            self.abort()
            raise ValueError(
                "avro sink: a block write failed upstream; the partial "
                f"container {self._tmp!r} was removed instead of being "
                "published short")
        self._f.close()
        os.replace(self._tmp, self.path)

    def abort(self) -> None:
        self._f.close()
        try:
            os.remove(self._tmp)
        except OSError:  # photon-lint: disable=swallowed-exception (idempotent abort; tmp may already be gone)
            pass

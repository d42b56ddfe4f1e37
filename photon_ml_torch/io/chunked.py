"""Chunked (bounded-memory) dataset ingestion.

Counterpart of ``photon_ml_tpu/io/chunked.py`` (host only, copied over
the port's ``io.libsvm``).  The readers stream a file in byte windows
split at line boundaries and parse each window into a ``SparseRows``
chunk with the same tokenizer and canonicalization as the whole-file
reader, so a chunked read is byte for byte the whole-file read; peak
host memory is the dataset plus one window.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from photon_ml_torch.data.sparse_rows import SparseRows


def _iter_byte_windows(path: str, chunk_bytes: int) -> Iterator[bytes]:
    """Yield file contents in windows split at line boundaries."""
    with open(path, "rb") as f:
        carry = b""
        while True:
            block = f.read(chunk_bytes)
            if not block:
                if carry.strip():
                    yield carry
                return
            block = carry + block
            cut = block.rfind(b"\n")
            if cut < 0:
                carry = block
                continue
            yield block[: cut + 1]
            carry = block[cut + 1:]


def iter_libsvm_chunks(
    path: str,
    chunk_bytes: int = 64 << 20,
    n_features: int | None = None,
    zero_based: bool = False,
) -> Iterator[tuple[SparseRows, np.ndarray]]:
    """Stream a LIBSVM file as (SparseRows, raw labels) chunks.

    Labels are not mapped {-1,+1} → {0,1} here: that needs the whole
    file's label set.  ``read_libsvm_chunked`` maps them at assembly."""
    from photon_ml_torch.io.libsvm import parse_libsvm_bytes

    for window in _iter_byte_windows(path, chunk_bytes):
        yield parse_libsvm_bytes(window, n_features=n_features,
                                 zero_based=zero_based, where=path)


def read_libsvm_chunked(
    path: str,
    n_features: int | None = None,
    zero_based: bool = False,
    binary_labels_to_01: bool = True,
    chunk_bytes: int = 64 << 20,
) -> tuple[SparseRows, np.ndarray, int]:
    """``io.libsvm.read_libsvm`` with a windowed peak memory."""
    from photon_ml_torch.io.libsvm import map_binary_labels

    parts: list[SparseRows] = []
    label_parts: list[np.ndarray] = []
    for rows, labels in iter_libsvm_chunks(
        path, chunk_bytes=chunk_bytes, n_features=n_features,
        zero_based=zero_based,
    ):
        parts.append(rows)
        label_parts.append(labels)
    rows = SparseRows.concat(parts)
    y = (np.concatenate(label_parts) if label_parts
         else np.zeros(0, np.float32))
    dim = n_features if n_features is not None else rows.max_col + 1
    if binary_labels_to_01:
        y = map_binary_labels(y)
    return rows, y, dim


def iter_jsonl_chunks(path: str, chunk_records: int = 100_000
                      ) -> Iterator[list]:
    """Stream parsed JSONL records in batches of ``chunk_records``."""
    import json

    batch: list = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            batch.append(json.loads(line))
            if len(batch) >= chunk_records:
                yield batch
                batch = []
    if batch:
        yield batch

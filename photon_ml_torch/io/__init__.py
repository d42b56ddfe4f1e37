"""Data I/O: LIBSVM readers and writers, chunked readers, feature
indexing, model serialization (counterpart of ``photon_ml_tpu/io``)."""

from photon_ml_torch.io.chunked import (
    iter_jsonl_chunks,
    iter_libsvm_chunks,
    read_libsvm_chunked,
)
from photon_ml_torch.io.libsvm import read_libsvm, write_libsvm

__all__ = [
    "iter_jsonl_chunks",
    "iter_libsvm_chunks",
    "read_libsvm",
    "read_libsvm_chunked",
    "write_libsvm",
]

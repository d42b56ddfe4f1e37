"""LIBSVM-format reader and writer.

Counterpart of ``photon_ml_tpu/io/libsvm.py`` (numpy only, copied).  The
output is host-side ``SparseRows`` plus numpy labels, which
``data.batch.make_sparse_batch`` places on the device.  The native C++
tokenizer parses when it is available; the Python tokenizer is the
fallback; either way ``SparseRows.from_flat`` canonicalizes (sort within
a row, sum duplicate ids, drop ``col >= n_features``).
"""

from __future__ import annotations

import numpy as np

from photon_ml_torch.data.sparse_rows import SparseRows


def parse_libsvm_bytes(
    data: bytes,
    n_features: int | None = None,
    zero_based: bool = False,
    where: str = "<bytes>",
) -> tuple[SparseRows, np.ndarray]:
    """LIBSVM text bytes → (canonical SparseRows, raw float32 labels).

    Uses the native C++ tokenizer when available; the Python tokenizer
    is the fallback.  Either way canonicalization (sort within row, sum
    duplicate ids, drop ``col >= n_features``) happens in ONE vectorized
    ``SparseRows.from_flat`` pass.
    """
    from photon_ml_torch.native import libsvm_parse_native, native_available

    base = 0 if zero_based else 1
    if native_available():
        parsed = libsvm_parse_native(data)
        if parsed is not None:
            labels, row_ptr, cols, vals, _ = parsed
            cols = cols.astype(np.int64) - base
            if cols.size and cols.min() < 0:
                raise ValueError(
                    f"{where}: feature index below {base} "
                    f"(zero_based={zero_based})"
                )
            rows = SparseRows.from_flat(row_ptr.astype(np.int64), cols,
                                        vals, clip_dim=n_features)
            return rows, np.asarray(labels, np.float32)

    counts: list[int] = []
    idxs: list[int] = []
    vs: list[float] = []
    labels_l: list[float] = []
    for line in data.decode().splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        labels_l.append(float(parts[0]))
        cnt = 0
        for tok in parts[1:]:
            i_str, v_str = tok.split(":")
            i = int(i_str) - base
            if i < 0:
                raise ValueError(
                    f"{where}: feature index below {base} "
                    f"(zero_based={zero_based})"
                )
            idxs.append(i)
            vs.append(float(v_str))
            cnt += 1
        counts.append(cnt)
    indptr = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(np.asarray(counts, np.int64), out=indptr[1:])
    rows = SparseRows.from_flat(indptr, np.asarray(idxs, np.int64),
                                np.asarray(vs, np.float64),
                                clip_dim=n_features)
    return rows, np.asarray(labels_l, np.float32)


def map_binary_labels(y: np.ndarray) -> np.ndarray:
    """{-1,+1} labels → {0,1} when the label set is exactly that
    (the reference's binary-classification convention)."""
    if set(np.unique(y)) <= {-1.0, 1.0}:
        return ((y + 1.0) / 2.0).astype(np.float32)
    return y


def read_libsvm(
    path: str,
    n_features: int | None = None,
    zero_based: bool = False,
    binary_labels_to_01: bool = True,
) -> tuple[SparseRows, np.ndarray, int]:
    """Parse a LIBSVM file → (rows, labels, dim).

    Args:
      path: file path. Lines: ``label idx:val idx:val ...`` (# comments ok).
      n_features: feature-space width; inferred as max index + 1 if None.
        Features outside the declared space (e.g. test-set indices a
        model never saw) are dropped, never allowed to dot into
        out-of-range coefficients.
      zero_based: whether indices in the file start at 0 (LIBSVM default
        is 1-based, e.g. a1a).
      binary_labels_to_01: map {-1,+1} labels to {0,1}.

    Returns:
      rows: ``SparseRows`` (CSR-backed; indexes/iterates as per-example
        (col_ids int32[], values float32[]) pairs) with column ids
        deduplicated (duplicate indices summed, as SparseBatch requires
        unique ids per row).
      labels: float32 [n].
      dim: feature-space width.
    """
    with open(path, "rb") as f:
        data = f.read()
    rows, y = parse_libsvm_bytes(data, n_features=n_features,
                                 zero_based=zero_based, where=path)
    dim = n_features if n_features is not None else rows.max_col + 1
    if binary_labels_to_01:
        y = map_binary_labels(y)
    return rows, y, dim


def write_libsvm(
    path: str,
    rows,
    labels: np.ndarray,
    zero_based: bool = False,
) -> None:
    """Inverse of ``read_libsvm`` (fixture generation / round-trip tests)."""
    off = 0 if zero_based else 1
    with open(path, "w") as f:
        for (c, v), y in zip(rows, labels):
            feats = " ".join(f"{int(i) + off}:{val:g}" for i, val in zip(c, v))
            f.write(f"{y:g} {feats}\n".rstrip() + "\n")

"""Array-backed sparse example rows (CSR): the ETL container.

Counterpart of ``photon_ml_tpu/data/sparse_rows.py`` (numpy only, copied).
Three flat arrays (``indptr``, ``cols``, ``vals``) hold every example;
rows are kept CANONICAL (within a row, ``cols`` strictly increasing,
duplicates summed), which ``SparseBatch`` relies on for its Hessian
diagonal.  It quacks like a ``list[(col_ids, values)]`` (``len``,
indexing, slicing, iteration).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from photon_ml_torch import telemetry


@dataclasses.dataclass
class SparseRows:
    """CSR-layout sparse rows: example i owns ``cols/vals[indptr[i]:indptr[i+1]]``."""

    indptr: np.ndarray  # int64 [n+1], monotone, indptr[0] == 0
    cols: np.ndarray    # int32 [nnz], strictly increasing within each row
    vals: np.ndarray    # float32 [nnz]

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_rows(rows) -> "SparseRows":
        """From a ``list[(col_ids, values)]`` (or any sized iterable of
        pairs); canonicalizes."""
        if isinstance(rows, SparseRows):
            return rows
        counts = np.fromiter((len(c) for c, _ in rows), np.int64,
                             count=len(rows))
        indptr = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        cols = np.empty(int(indptr[-1]), np.int64)
        vals = np.empty(int(indptr[-1]), np.float64)
        at = 0
        for c, v in rows:
            cols[at:at + len(c)] = c
            vals[at:at + len(c)] = v
            at += len(c)
        return SparseRows.from_flat(indptr, cols, vals)

    @staticmethod
    def concat(parts: list["SparseRows"]) -> "SparseRows":
        """Row-wise concatenation."""
        if not parts:
            return SparseRows(np.zeros(1, np.int64), np.zeros(0, np.int32),
                              np.zeros(0, np.float32))
        indptrs = [np.zeros(1, np.int64)]
        base = 0
        for p in parts:
            indptrs.append(p.indptr[1:] + base)
            base += p.nnz
        return SparseRows(indptr=np.concatenate(indptrs),
                          cols=np.concatenate([p.cols for p in parts]),
                          vals=np.concatenate([p.vals for p in parts]))

    @staticmethod
    def from_flat(indptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                  clip_dim: int | None = None) -> "SparseRows":
        """From raw CSR arrays (e.g. the native LIBSVM parser's output):
        one vectorized pass sorts each row by column id, sums duplicate
        ids, and (optionally) drops entries with ``col >= clip_dim``.

        ``cols`` may arrive in any order and with repeats; negative ids
        raise (they indicate an upstream indexing bug).  In a telemetry
        session the call is the span ``data.from_flat``."""
        with telemetry.span("data.from_flat", cat="setup"):
            return SparseRows._from_flat(indptr, cols, vals, clip_dim)

    @staticmethod
    def _from_flat(indptr, cols, vals, clip_dim) -> "SparseRows":
        indptr = np.asarray(indptr, np.int64)
        n = len(indptr) - 1
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if cols.size and int(cols.min()) < 0:
            raise ValueError("negative column id in sparse rows")
        row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        if clip_dim is not None:
            keep = cols < clip_dim
            if not bool(keep.all()):
                cols, vals, row_of = cols[keep], vals[keep], row_of[keep]
        # Already-canonical fast path: most parsers emit rows sorted and
        # unique (LIBSVM convention), and the O(nnz) check is ~50×
        # cheaper than the O(nnz log nnz) lexsort it skips — at 10⁸ nnz
        # the sort is minutes, the check is a second.
        if len(cols) == 0 or bool(
            ((cols[1:] > cols[:-1]) | (row_of[1:] != row_of[:-1])).all()
        ):
            counts0 = np.bincount(row_of, minlength=n)
            out_indptr0 = np.zeros(n + 1, np.int64)
            np.cumsum(counts0, out=out_indptr0[1:])
            return SparseRows(
                indptr=out_indptr0,
                cols=np.ascontiguousarray(cols, np.int32),
                vals=np.ascontiguousarray(vals, np.float32),
            )
        # Sort by (row, col); detect duplicate (row, col) groups; sum
        # each group with one reduceat.
        order = np.lexsort((cols, row_of))
        cols_s = cols[order]
        vals_s = vals[order]
        row_s = row_of[order]
        if len(cols_s):
            new_group = np.empty(len(cols_s), bool)
            new_group[0] = True
            np.logical_or(row_s[1:] != row_s[:-1], cols_s[1:] != cols_s[:-1],
                          out=new_group[1:])
            starts = np.flatnonzero(new_group)
            g_cols = cols_s[starts]
            g_rows = row_s[starts]
            g_vals = np.add.reduceat(vals_s.astype(np.float64), starts)
            counts = np.bincount(g_rows, minlength=n)
        else:
            g_cols = cols_s
            g_rows = row_s
            g_vals = vals_s
            counts = np.zeros(n, np.int64)
        out_indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=out_indptr[1:])
        return SparseRows(
            indptr=out_indptr,
            cols=np.ascontiguousarray(g_cols, np.int32),
            vals=np.ascontiguousarray(g_vals, np.float32),
        )

    # -- shape / stats ------------------------------------------------------

    def __len__(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def counts(self) -> np.ndarray:
        """Per-row nnz [n]."""
        return np.diff(self.indptr)

    @property
    def max_nnz(self) -> int:
        return int(self.counts().max()) if len(self) else 0

    @property
    def max_col(self) -> int:
        return int(self.cols.max()) if self.nnz else -1

    def row_of(self) -> np.ndarray:
        """Row index of each stored entry [nnz]."""
        return np.repeat(np.arange(len(self), dtype=np.int64), self.counts())

    # -- legacy row-list protocol ------------------------------------------

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                return self.take(np.arange(start, stop, step))
            lo, hi = self.indptr[start], self.indptr[stop]
            return SparseRows(
                indptr=self.indptr[start:stop + 1] - lo,
                cols=self.cols[lo:hi], vals=self.vals[lo:hi],
            )
        if isinstance(i, (np.ndarray, list)):
            return self.take(np.asarray(i))
        i = int(i)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(f"row {i} out of range for {len(self)} rows")
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.cols[lo:hi], self.vals[lo:hi]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- vectorized transforms ---------------------------------------------

    def take(self, idx: np.ndarray) -> "SparseRows":
        """Row subset/reorder (train/validation splits, shard slicing) —
        vectorized; no per-row Python."""
        idx = np.asarray(idx, np.int64)
        counts = self.counts()[idx]
        out_indptr = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(counts, out=out_indptr[1:])
        # Source position of each output entry: for output row j at
        # offset t, src = indptr[idx[j]] + t.
        row_of_out = np.repeat(np.arange(len(idx), dtype=np.int64), counts)
        within = np.arange(int(out_indptr[-1]), dtype=np.int64) \
            - out_indptr[row_of_out]
        src = self.indptr[idx[row_of_out]] + within
        return SparseRows(indptr=out_indptr, cols=self.cols[src],
                          vals=self.vals[src])

    def with_constant_col(self, col: int, value: float = 1.0) -> "SparseRows":
        """Append one column (id ``col``, same ``value``) to every row —
        the intercept transform.  ``col`` must exceed every stored id
        (canonical order is preserved by appending at row ends)."""
        if self.nnz and col <= self.max_col:
            raise ValueError(
                f"intercept column {col} must be > max col {self.max_col}")
        n = len(self)
        out_indptr = self.indptr + np.arange(n + 1, dtype=np.int64)
        nnz_out = int(out_indptr[-1])
        # Each row's new entry sits at its (exclusive) end; everything
        # else copies over in order.  Two boolean-scatter passes total —
        # O(nnz) with small constants (this runs on 10⁸-entry inputs).
        cols = np.empty(nnz_out, np.int32)
        vals = np.empty(nnz_out, np.float32)
        keep = np.ones(nnz_out, bool)
        keep[out_indptr[1:] - 1] = False
        cols[~keep] = col
        vals[~keep] = value
        cols[keep] = self.cols
        vals[keep] = self.vals
        return SparseRows(indptr=out_indptr, cols=cols, vals=vals)

    def to_ell(self, row_capacity: int | None = None,
               pad_to: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Densify to the padded-ELL pair ``(col_ids [n_out, k],
        values [n_out, k])`` in one vectorized scatter.  Padding entries
        are (col 0, value 0.0) per the SparseBatch convention."""
        n = len(self)
        k = row_capacity if row_capacity is not None else max(self.max_nnz, 1)
        if self.max_nnz > k:
            bad = int(np.argmax(self.counts() > k))
            raise ValueError(
                f"row {bad} nnz {int(self.counts()[bad])} exceeds "
                f"capacity {k}")
        n_out = max(pad_to or n, n)
        cols2d = np.zeros((n_out, max(k, 1)), np.int32)
        vals2d = np.zeros((n_out, max(k, 1)), np.float32)
        row = self.row_of()
        pos = np.arange(self.nnz, dtype=np.int64) - self.indptr[row]
        cols2d[row, pos] = self.cols
        vals2d[row, pos] = self.vals
        return cols2d, vals2d

    def dot_dense(self, w: np.ndarray) -> np.ndarray:
        """Host-side X·w [n] (transformer scoring path) — one segment
        reduction instead of a per-row Python loop."""
        contrib = self.vals.astype(np.float64) * w[self.cols]
        # Row sums via prefix-sum differences — exact for empty rows,
        # no scatter.
        cs = np.zeros(self.nnz + 1, np.float64)
        np.cumsum(contrib, out=cs[1:])
        return (cs[self.indptr[1:]] - cs[self.indptr[:-1]]).astype(np.float32)

    def to_dense(self, dim: int) -> np.ndarray:
        """Densify to [n, dim] float32 (narrow shards only)."""
        x = np.zeros((len(self), dim), np.float32)
        x[self.row_of(), self.cols] = self.vals
        return x

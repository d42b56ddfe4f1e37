"""Example batches on the device: dense, and padded-ELL sparse.

Counterpart of ``photon_ml_tpu/data/batch.py``.

- ``DenseBatch`` — ``x: [n, d]`` dense features; margins are one matmul.
- ``SparseBatch`` — padded ELL: ``values/col_ids: [n, k]``, padding
  entries (col 0, value 0).  Two layouts for the contractions:

  - ``grr`` (``data.grr.GrrPair``, ``make_sparse_batch(..., grr=True)``):
    both directions run through the compiled GRR plan (the B2/B3 CUDA
    kernels on the card), hot columns through one matmul;
  - plain ELL: ``X·w`` through the ``gather_rowsum`` kernel (B1) and
    ``Xᵀr`` through ``index_add_``.

Both carry per-example ``labels, weights, offsets`` and a validity
``mask`` (1 = real example, 0 = padding row).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from photon_ml_torch.data.grr import GrrPair, build_grr_pair
from photon_ml_torch.device import resolve_device
from photon_ml_torch.ops.kernels import gather_rowsum

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DenseBatch:
    """Dense feature batch; ``x[i]`` is example i's feature vector."""

    x: Tensor          # [n, d]
    labels: Tensor     # [n]
    weights: Tensor    # [n]
    offsets: Tensor    # [n]
    mask: Tensor       # [n], 1.0 = real example, 0.0 = padding

    @property
    def dim(self) -> int:
        return self.x.shape[-1]

    def margins(self, w: Tensor) -> Tensor:
        return self.x @ w + self.offsets

    def xt_dot(self, r: Tensor) -> Tensor:
        return self.x.T @ r

    def x_dot(self, v: Tensor) -> Tensor:
        return self.x @ v


@dataclasses.dataclass(frozen=True)
class SparseBatch:
    """Padded-ELL sparse batch, optionally with its GRR plan."""

    values: Tensor     # [n, k] f32 ([n, 0] when the plan serves alone)
    col_ids: Tensor    # [n, k] i32
    labels: Tensor     # [n]
    weights: Tensor    # [n]
    offsets: Tensor    # [n]
    mask: Tensor       # [n]
    dim: int
    grr: "GrrPair | None" = None

    def margins(self, w: Tensor) -> Tensor:
        """Σ_k values[i,k]·w[col_ids[i,k]] + offset."""
        return self.x_dot(w) + self.offsets

    def xt_dot(self, r: Tensor) -> Tensor:
        """Xᵀr — the GRR plan, else a scatter-add into [dim].

        The scatter accumulates in float64: it adds a column's terms one
        after another (atomics on the card), and a power-law head column
        collects a term from nearly every row, which float32 would sum
        with ~n·2⁻²⁴ relative error."""
        if self.grr is not None:
            return self.grr.t_dot(r)
        out = torch.zeros(self.dim, dtype=torch.float64, device=r.device)
        out.index_add_(0, self.col_ids.reshape(-1),
                       (self.values * r[:, None]).reshape(-1).double())
        return out.to(r.dtype)

    def x_dot(self, v: Tensor) -> Tensor:
        """X·v — the GRR plan, else the ``gather_rowsum`` kernel."""
        if self.grr is not None:
            return self.grr.dot(v)
        return gather_rowsum(v, self.values, self.col_ids)

    def to_dense(self) -> DenseBatch:
        """Densify (tests, small dims)."""
        n, k = self.values.shape
        x = torch.zeros((n, self.dim), dtype=self.values.dtype,
                        device=self.values.device)
        rows = torch.arange(n, device=x.device).repeat_interleave(k)
        x.index_put_((rows, self.col_ids.reshape(-1).long()),
                     self.values.reshape(-1), accumulate=True)
        return DenseBatch(x=x, labels=self.labels, weights=self.weights,
                          offsets=self.offsets, mask=self.mask)


Batch = Union[DenseBatch, SparseBatch]


def make_sparse_batch(
    rows,
    dim: int,
    labels: np.ndarray,
    weights: np.ndarray | None = None,
    offsets: np.ndarray | None = None,
    row_capacity: int | None = None,
    pad_to: int | None = None,
    col_major: bool = False,
    grr: bool = False,
    keep_ell: bool = True,
    cache_dir: str | None = None,
    device=None,
) -> SparseBatch:
    """Build a padded-ELL SparseBatch on ``device`` (default CUDA;
    ``"cpu"`` when asked).

    Args:
      rows: ``SparseRows``, or per-example ``(col_ids, values)`` pairs
        (unique ids within a row; duplicates raise).
      dim: feature-space width.
      row_capacity: per-row nnz capacity; defaults to the max observed.
      pad_to: pad the example count to this.
      col_major: the transposed-ELL layout, not ported (ROADMAP A2).
      grr: compile the GRR plan (``data.grr.build_grr_pair``).
      keep_ell: with ``grr``, whether the ELL arrays also go to the
        device (feature statistics need them; the plan does not).
      cache_dir: the on-disk GRR plan cache, shared with the JAX package.
    """
    if col_major:
        raise NotImplementedError(
            "col_major (the transposed-ELL layout) is not ported yet: "
            "ROADMAP A2")
    from photon_ml_torch.data.sparse_rows import SparseRows

    dev = resolve_device(device)
    n = len(rows)
    if isinstance(rows, SparseRows):
        k = max(row_capacity or rows.max_nnz, 1)
        n_out = max(pad_to or n, n)
        cols, vals = rows.to_ell(row_capacity=k, pad_to=n_out)
    else:
        k = max(row_capacity or max((len(c) for c, _ in rows), default=1), 1)
        n_out = max(pad_to or n, n)
        vals = np.zeros((n_out, k), np.float32)
        cols = np.zeros((n_out, k), np.int32)
        for i, (c, v) in enumerate(rows):
            if len(c) > k:
                raise ValueError(f"row {i} nnz {len(c)} exceeds capacity {k}")
            # Duplicate ids would give Σv² instead of (Σv)² in the
            # Hessian diagonal: reject them.
            if len(np.unique(c)) != len(c):
                raise ValueError(
                    f"row {i} has duplicate column ids; SparseBatch "
                    "requires unique col_ids per row (pre-sum duplicates "
                    "on the host)")
            vals[i, : len(c)] = v
            cols[i, : len(c)] = c
    weights = np.ones(n) if weights is None else np.asarray(weights)
    offsets = np.zeros(n) if offsets is None else np.asarray(offsets)

    def padded(a) -> Tensor:
        out = np.zeros(n_out, np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    pair = (build_grr_pair(cols, vals, dim, cache_dir=cache_dir, device=dev)
            if grr else None)
    if grr and not keep_ell:
        vals = np.zeros((n_out, 0), np.float32)
        cols = np.zeros((n_out, 0), np.int32)
    return SparseBatch(
        values=torch.from_numpy(np.ascontiguousarray(vals, np.float32)).to(dev),
        col_ids=torch.from_numpy(np.ascontiguousarray(cols, np.int32)).to(dev),
        labels=padded(labels), weights=padded(weights),
        offsets=padded(offsets), mask=padded(np.ones(n)),
        dim=dim, grr=pair)

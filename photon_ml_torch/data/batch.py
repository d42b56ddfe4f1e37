"""Example batches on the device: dense, and padded-ELL sparse.

Counterpart of ``photon_ml_tpu/data/batch.py``.

- ``DenseBatch`` — ``x: [n, d]`` dense features; margins are one matmul.
- ``SparseBatch`` — padded ELL: ``values/col_ids: [n, k]``, padding
  entries (col 0, value 0).  Two layouts for the contractions:

  - ``grr`` (``data.grr.GrrPair``, ``make_sparse_batch(..., grr=True)``):
    both directions run through the compiled GRR plan (the B2/B3 CUDA
    kernels on the card), hot columns through one matmul;
  - ``colmajor`` (``data.colmajor.ColMajorSlice``,
    ``make_sparse_batch(..., col_major=True)``): ``X·w`` through B1 on
    the row ELL, ``Xᵀr`` through B1 on the transposed ELL plus a small
    sorted fold;
  - plain ELL: ``X·w`` through the ``gather_rowsum`` kernel (B1) and
    ``Xᵀr`` through ``index_add_``.

  The products also take a λ-lane axis (the swept fit, the counterpart
  of ``jax.vmap`` of these products over a shared batch): W [L, d] →
  [L, n] and R [L, n] → [L, d].  ``X·Wᵀ`` (and the transposed ELL's
  ``XᵀR``) run the lane kernel ``gather_rowsum_lanes`` once for every
  lane, so the ELL streams are read once; one lane stays on
  ``gather_rowsum``.  The plain-ELL ``XᵀR`` is one float64
  ``index_add_`` into a [d, L] target.  GRR runs the lanes one after
  another through its plan.

Both carry per-example ``labels, weights, offsets`` and a validity
``mask`` (1 = real example, 0 = padding row).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from photon_ml_torch.data.colmajor import ColMajorSlice, build_colmajor
from photon_ml_torch.data.grr import GrrPair, build_grr_pair
from photon_ml_torch.device import resolve_device
from photon_ml_torch.ops.kernels import lane_gather_rowsum

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DenseBatch:
    """Dense feature batch; ``x[i]`` is example i's feature vector.

    With a leading lane axis (``x`` [E, c, p], the per-example fields
    [E, c]) it holds E independent problems, and the products take
    coefficients [E, p]: the random-effect buckets, where ``p`` is a few
    features, so the products are elementwise ops and reductions.  A
    shared ``x`` [n, d] with λ-lane coefficients W [L, d] (the swept
    fit) gives [L, n] margins and takes [L, n] residuals."""

    x: Tensor          # [n, d]
    labels: Tensor     # [n]
    weights: Tensor    # [n]
    offsets: Tensor    # [n]
    mask: Tensor       # [n], 1.0 = real example, 0.0 = padding

    @property
    def dim(self) -> int:
        return self.x.shape[-1]

    def margins(self, w: Tensor) -> Tensor:
        return self.x_dot(w) + self.offsets

    def xt_dot(self, r: Tensor) -> Tensor:
        if self.x.dim() == 2:
            return self.x.T @ r if r.dim() == 1 else r @ self.x
        return (self.x * r[..., None]).sum(-2)

    def x_dot(self, v: Tensor) -> Tensor:
        if self.x.dim() == 2:
            return self.x @ v if v.dim() == 1 else v @ self.x.T
        return (self.x * v[..., None, :]).sum(-1)


@dataclasses.dataclass(frozen=True)
class SparseBatch:
    """Padded-ELL sparse batch, optionally with its transposed ELL or its
    GRR plan."""

    values: Tensor     # [n, k] f32 ([n, 0] when the plan serves alone)
    col_ids: Tensor    # [n, k] i32
    labels: Tensor     # [n]
    weights: Tensor    # [n]
    offsets: Tensor    # [n]
    mask: Tensor       # [n]
    dim: int
    grr: "GrrPair | None" = None
    colmajor: "ColMajorSlice | None" = None

    def margins(self, w: Tensor) -> Tensor:
        """Σ_k values[i,k]·w[col_ids[i,k]] + offset ([L, n] for W [L, d])."""
        return self.x_dot(w) + self.offsets

    def xt_dot(self, r: Tensor) -> Tensor:
        """Xᵀr — the GRR plan, else the transposed ELL, else a
        scatter-add into [dim] (R [L, n] → [L, dim]).

        The scatter accumulates in float64: it adds a column's terms one
        after another (atomics on the card), and a power-law head column
        collects a term from nearly every row, which float32 would sum
        with ~n·2⁻²⁴ relative error."""
        if self.grr is not None:
            if r.dim() == 2:
                return torch.stack([self.grr.t_dot(r_l) for r_l in r])
            return self.grr.t_dot(r)
        if self.colmajor is not None:
            return self.colmajor.xt_dot(r)
        if r.dim() == 2:
            # One call for every lane: rows of a [dim, L] target.
            lanes = r.shape[0]
            out = torch.zeros((self.dim, lanes), dtype=torch.float64,
                              device=r.device)
            out.index_add_(0, self.col_ids.reshape(-1),
                           (self.values[..., None] * r.T[:, None, :])
                           .reshape(-1, lanes).double())
            return out.T.to(r.dtype)
        out = torch.zeros(self.dim, dtype=torch.float64, device=r.device)
        out.index_add_(0, self.col_ids.reshape(-1),
                       (self.values * r[:, None]).reshape(-1).double())
        return out.to(r.dtype)

    def x_dot(self, v: Tensor) -> Tensor:
        """X·v — the GRR plan, else the ``gather_rowsum`` kernel; X·Wᵀ
        [L, n] for W [L, d], through ``gather_rowsum_lanes``."""
        if self.grr is not None:
            if v.dim() == 2:
                return torch.stack([self.grr.dot(v_l) for v_l in v])
            return self.grr.dot(v)
        return lane_gather_rowsum(v, self.values, self.col_ids)

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


def make_dense_batch(x: np.ndarray, labels: np.ndarray,
                     weights: np.ndarray | None = None,
                     offsets: np.ndarray | None = None,
                     device=None) -> DenseBatch:
    """A DenseBatch on ``device`` (default CUDA) from host arrays."""
    dev = resolve_device(device)
    n = x.shape[0]

    def col(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return DenseBatch(
        x=col(x), labels=col(labels),
        weights=col(np.ones(n) if weights is None else weights),
        offsets=col(np.zeros(n) if offsets is None else offsets),
        mask=col(np.ones(n)))


def make_sparse_batch(
    rows,
    dim: int,
    labels: np.ndarray,
    weights: np.ndarray | None = None,
    offsets: np.ndarray | None = None,
    row_capacity: int | None = None,
    pad_to: int | None = None,
    col_major: bool = False,
    col_capacity: int | None = None,
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
      col_major: also build the transposed ELL (``data.colmajor``), so
        Xᵀr runs on B1 instead of ``index_add_``.
      col_capacity: its virtual-row capacity (default: from the column
        occupancy, ``choose_capacity``).
      grr: compile the GRR plan (``data.grr.build_grr_pair``); it
        supersedes ``col_major``.
      keep_ell: with ``grr``, whether the ELL arrays also go to the
        device (feature statistics need them; the plan does not).
      cache_dir: the on-disk GRR plan cache, shared with the JAX package.
    """
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

    cm = (build_colmajor(cols, vals, dim, capacity=col_capacity, device=dev)
          if col_major and not grr else None)
    pair = (build_grr_pair(cols, vals, dim, cache_dir=cache_dir, device=dev)
            if grr else None)
    if grr and not keep_ell:
        vals = np.zeros((n_out, 0), np.float32)
        cols = np.zeros((n_out, 0), np.int32)
    return SparseBatch(
        values=torch.from_numpy(
            np.ascontiguousarray(vals, np.float32)).to(dev),
        col_ids=torch.from_numpy(np.ascontiguousarray(cols, np.int32)).to(dev),
        labels=padded(labels), weights=padded(weights),
        offsets=padded(offsets), mask=padded(np.ones(n)),
        dim=dim, grr=pair, colmajor=cm)

"""Column-major (transposed-ELL) layout: ``Xᵀr`` without a scatter.

Counterpart of ``photon_ml_tpu/data/colmajor.py``.  A second, transposed
copy of the design matrix lets the gradient read irregularly instead of
writing irregularly:

    part[v] = Σ_k tvals[v,k] · r[trows[v,k]]     (gather + row-sum, B1)
    g[j]    = Σ_{v: vcol[v] = j} part[v]         (a small sorted fold)

so both directions of the objective run the same ``gather_rowsum``
kernel (``csrc/gather_rowsum.cu`` on the card).  Power-law column skew is
bounded by *virtual rows*: column j is chopped into ⌈nnz_j / C⌉ rows of
capacity C (``choose_capacity``: the 75th-percentile column, clamped to
[8, 512] and rounded up to a multiple of 8), and the fold runs over the
V virtual rows, not the nnz entries.

The fold accumulates in float64: a head column spans thousands of
virtual rows, and a float32 fold of their partial sums drifts (the same
reason the plain-ELL ``Xᵀr`` accumulates in float64).

The build is host numpy, or the C++ counting sort of
``native/fast_etl.cpp`` (``pml_colmajor_vrows``/``pml_colmajor_fill``);
both give byte-identical arrays, and the JAX package's build too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_torch.device import resolve_device
from photon_ml_torch.ops.kernels import lane_gather_rowsum, vrow_pad

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ColMajorSlice:
    """Transposed-ELL arrays of one row batch.

    ``tvals/trows`` [V, C]: virtual rows of capacity C; ``trows`` are row
    indices into the paired row batch.  Padding slots carry ``tvals ==
    0`` and point at row 0.  ``vcol`` [V]: the (sorted, repeated) output
    column of each virtual row; padding virtual rows point at column 0
    with all-zero values."""

    tvals: Tensor   # [V, C] float32
    trows: Tensor   # [V, C] int32
    vcol: Tensor    # [V] int64 (index_add_'s index type), sorted
    dim: int

    @property
    def n_virtual_rows(self) -> int:
        return self.tvals.shape[-2]

    @property
    def capacity(self) -> int:
        return self.tvals.shape[-1]

    def xt_dot(self, r: Tensor) -> Tensor:
        """Xᵀr: B1 over the virtual rows with ``r`` as the table, then
        the float64 fold over ``vcol``.  R [L, n] → [L, dim]: every lane
        in one ``gather_rowsum_lanes`` over the table Rᵀ [n, L], and one
        fold into a [dim, L] target."""
        part = lane_gather_rowsum(r.contiguous(), self.tvals, self.trows)
        if r.dim() == 1:                                          # [V]
            out = torch.zeros(self.dim, dtype=torch.float64,
                              device=r.device)
            out.index_add_(0, self.vcol, part.double())
            return out.to(r.dtype)
        out = torch.zeros((self.dim, r.shape[0]), dtype=torch.float64,
                          device=r.device)
        out.index_add_(0, self.vcol, part.T.double())          # [V, L]
        return out.T.to(r.dtype)

    def squared(self) -> "ColMajorSlice":
        """Values → values² (for the Hessian diagonal)."""
        return dataclasses.replace(self, tvals=self.tvals * self.tvals)


def choose_capacity(counts: np.ndarray) -> int:
    """Virtual-row capacity: the 75th-percentile column in one virtual
    row, clamped to [8, 512], rounded up to a multiple of 8."""
    nz = counts[counts > 0]
    if nz.size == 0:
        return 8
    c = int(np.percentile(nz, 75.0))
    c = max(8, min(512, c))
    return int((c + 7) // 8 * 8)


def build_colmajor_arrays(
    col_ids: np.ndarray,
    values: np.ndarray,
    dim: int,
    capacity: int | None = None,
    pad_vrows_to_multiple: int | None = None,
    pad_vrows_to: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tvals [V, C] f32, trows [V, C] i32, vcol [V] i32) on the host
    from row-ELL arrays; entries with value 0 are dropped.

    Args:
      col_ids, values: [n, k] row-major ELL (padding slots carry 0).
      dim: feature-space width.
      capacity: virtual-row capacity C (default ``choose_capacity``).
      pad_vrows_to_multiple: pad V up to a multiple of this (default 8,
        ``vrow_pad``) with all-zero virtual rows.
      pad_vrows_to: pad V to exactly this (equal-shape shards under data
        parallelism, ``parallel.mesh.shard_sparse_batch``).
    """
    col_ids = np.asarray(col_ids)
    values = np.asarray(values)
    n, k = col_ids.shape
    counts_all = None
    if capacity is None:
        counts_all = np.bincount(
            col_ids.reshape(-1)[values.reshape(-1) != 0], minlength=dim)
        capacity = choose_capacity(counts_all)

    from photon_ml_torch.native import colmajor_build_native

    native = colmajor_build_native(
        col_ids, values, dim, capacity,
        pad_vrows_to_multiple=pad_vrows_to_multiple,
        pad_vrows_to=pad_vrows_to)
    if native is not None:
        return native

    flat_c = col_ids.reshape(-1)
    flat_v = values.reshape(-1)
    flat_r = np.repeat(np.arange(n, dtype=np.int64), k)
    keep = flat_v != 0
    flat_c, flat_v, flat_r = flat_c[keep], flat_v[keep], flat_r[keep]
    order = np.argsort(flat_c, kind="stable")
    sc, sv, sr = flat_c[order], flat_v[order], flat_r[order]

    counts = (counts_all if counts_all is not None
              else np.bincount(sc, minlength=dim))
    C = capacity
    vrows_per_col = -(-counts // C)                     # ceil, 0 if empty
    vrow_base = np.zeros(dim + 1, np.int64)
    np.cumsum(vrows_per_col, out=vrow_base[1:])
    V = int(vrow_base[-1])
    V_pad = vrow_pad(V, pad_vrows_to_multiple)
    if pad_vrows_to is not None:
        if pad_vrows_to < V:
            raise ValueError(f"pad_vrows_to={pad_vrows_to} < V={V}")
        V_pad = pad_vrows_to

    offs = np.zeros(dim + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    pos = np.arange(sc.size, dtype=np.int64) - offs[sc]  # rank in column
    vidx = vrow_base[sc] + pos // C
    slot = pos % C

    tvals = np.zeros((V_pad, C), np.float32)
    trows = np.zeros((V_pad, C), np.int32)
    tvals[vidx, slot] = sv
    trows[vidx, slot] = sr
    vcol = np.zeros(V_pad, np.int32)
    vcol[:V] = np.repeat(np.arange(dim, dtype=np.int32),
                         vrows_per_col.astype(np.int64))
    return tvals, trows, vcol


def build_colmajor(
    col_ids: np.ndarray,
    values: np.ndarray,
    dim: int,
    capacity: int | None = None,
    device=None,
    pad_vrows_to_multiple: int | None = None,
    pad_vrows_to: int | None = None,
) -> ColMajorSlice:
    """``build_colmajor_arrays`` placed on ``device`` (default CUDA;
    ``"cpu"`` when asked)."""
    dev = resolve_device(device)
    tvals, trows, vcol = build_colmajor_arrays(
        col_ids, values, dim, capacity=capacity,
        pad_vrows_to_multiple=pad_vrows_to_multiple,
        pad_vrows_to=pad_vrows_to)
    return ColMajorSlice(
        tvals=torch.from_numpy(tvals).to(dev),
        trows=torch.from_numpy(trows).to(dev),
        vcol=torch.from_numpy(vcol.astype(np.int64)).to(dev),
        dim=dim)

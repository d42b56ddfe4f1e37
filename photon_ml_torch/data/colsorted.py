"""Column-sorted copy of a plain-ELL batch's slots: ``Xᵀr`` as a
segmented sum, without a scatter.

The row-major ELL (``values/col_ids`` [n, k]) serves ``X·w``; for
``g = Xᵀr`` each slot's term ``vals · r[row]`` belongs to its column, so
a scatter over the row-major slots writes at random.  This copy keeps
the same slots sorted by column once, when the batch is placed:

    rows    [nnz] int32    each slot's row, ascending within a column
    vals    [nnz] float32  each slot's value
    col_ptr [dim + 1] int64  column j's slots are [col_ptr[j], col_ptr[j+1])

(int64: a resident batch can pass 2³¹ slots), with slots whose value is
0 (the ELL's padding) dropped, as ``data.colmajor`` drops them.  Then
``g[j]`` is a streaming sum over a contiguous range
(``ops.kernels.sorted_colsum``: ``csrc/sorted_colsum.cu`` on the card).
``tiles`` is that kernel's merge-path partition of the copy, which
depends on ``col_ptr`` alone and so is built with it.

The build runs on the batch's device with PyTorch's own sort (set-up
code, not a hot-path kernel).  It has no counterpart in the JAX package,
whose plain-ELL ``Xᵀr`` is ``jax.ops.segment_sum`` over the row-major
slots.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_torch.ops.kernels import sorted_colsum, sorted_colsum_tiles

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ColumnSorted:
    """The slots of one row batch sorted by column (see the module)."""

    rows: Tensor      # [nnz] int32
    vals: Tensor      # [nnz] float32
    col_ptr: Tensor   # [dim + 1] int64
    tiles: Tensor     # [tiles + 1] int64, ``sorted_colsum_tiles``

    @property
    def dim(self) -> int:
        return self.col_ptr.numel() - 1

    def xt_dot(self, r: Tensor) -> Tensor:
        """Xᵀr for one residual vector r [n] → [dim]."""
        return sorted_colsum(r, self.rows, self.vals, self.col_ptr,
                             self.tiles)

    def squared(self) -> "ColumnSorted":
        """Values → values² (for the Hessian diagonal)."""
        return dataclasses.replace(self, vals=self.vals * self.vals)


def build_column_sorted(col_ids: Tensor, values: Tensor,
                        dim: int) -> ColumnSorted:
    """The column-sorted copy of row-ELL ``col_ids/values`` [n, k], on
    their device.

    A stable sort of the slots by column keeps rows ascending within a
    column; zero-valued slots sort past every column (key ``dim``) and
    are cut off.  ``col_ptr`` is a ``bincount`` of the kept columns and
    its ``cumsum``."""
    dev = values.device
    k = values.shape[-1]
    flat_v = values.reshape(-1)
    keys = torch.where(flat_v != 0, col_ids.reshape(-1),
                       torch.full((), dim, dtype=col_ids.dtype, device=dev))
    keys, order = torch.sort(keys, stable=True)
    counts = torch.bincount(keys, minlength=dim + 1)
    del keys
    col_ptr = torch.zeros(dim + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts[:dim], 0, out=col_ptr[1:])
    nnz = int(col_ptr[-1])
    order = order[:nnz]
    return ColumnSorted(
        rows=torch.div(order, k, rounding_mode="floor").to(torch.int32),
        vals=flat_v[order],
        col_ptr=col_ptr,
        tiles=sorted_colsum_tiles(col_ptr, nnz))

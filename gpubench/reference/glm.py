"""The plain logistic-regression objective the configurations state.

Value = Σ_i c_i·(softplus(m_i) − y_i·m_i) + ½·Σ_l λ_l·‖mask ⊙ w_l‖², with
m_i = Σ_j x_ij·w_j + offset_i, over rows given as CSR arrays and worked
out here from them (row of each entry, the intercept column appended):
nothing the program built is read.  Sums run in the dtype asked for.
The row weights c_i are 1 unless given (a fault planted in the
reference sets them).
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _weights(weights, n: int, dtype, device) -> Tensor:
    if weights is None:
        return torch.ones(n, dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(weights, np.float64)).to(
        device=device, dtype=dtype)


class SparseLogistic:
    """Logistic loss over CSR rows for one or more coefficient lanes."""

    def __init__(self, indptr, cols, vals, labels, dim: int,
                 intercept: bool, dtype, device, weights=None):
        indptr = np.asarray(indptr, np.int64)
        counts = np.diff(indptr)
        n = len(counts)
        row_of = np.repeat(np.arange(n, dtype=np.int64), counts)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float64)
        if intercept:
            row_of = np.concatenate([row_of, np.arange(n, dtype=np.int64)])
            cols = np.concatenate([cols, np.full(n, dim, np.int64)])
            vals = np.concatenate([vals, np.ones(n)])
            dim += 1
        self.n, self.dim = n, dim
        self.row_of = torch.from_numpy(row_of).to(device)
        self.cols = torch.from_numpy(cols).to(device)
        self.vals = torch.from_numpy(vals).to(device=device, dtype=dtype)
        self.labels = torch.as_tensor(np.asarray(labels, np.float64)).to(
            device=device, dtype=dtype)
        mask = np.ones(dim)
        if intercept:
            mask[-1] = 0.0
        self.mask = torch.from_numpy(mask).to(device=device, dtype=dtype)
        self.offsets = torch.zeros(n, dtype=dtype, device=device)
        self.weights = _weights(weights, n, dtype, device)
        self.dtype, self.device = dtype, device

    def margins(self, w: Tensor) -> Tensor:
        """X·w for each lane of w [L, dim] → [L, n] (no offsets)."""
        out = torch.zeros((w.shape[0], self.n), dtype=self.dtype,
                          device=self.device)
        for lane in range(w.shape[0]):
            out[lane].index_add_(0, self.row_of,
                                 self.vals * w[lane, self.cols])
        return out

    def _l2(self, w: Tensor, lams: Tensor) -> Tensor:
        wm = w * self.mask
        return 0.5 * lams * (wm * wm).sum(-1)

    def value(self, w: Tensor, lams: Tensor) -> Tensor:
        m = self.margins(w) + self.offsets
        loss = torch.nn.functional.softplus(m) - self.labels * m
        return (self.weights * loss).sum(-1) + self._l2(w, lams)

    def value_and_grad(self, w: Tensor, lams: Tensor):
        m = self.margins(w) + self.offsets
        loss = torch.nn.functional.softplus(m) - self.labels * m
        r = self.weights * (torch.sigmoid(m) - self.labels)
        g = torch.zeros_like(w)
        for lane in range(w.shape[0]):
            g[lane].index_add_(0, self.cols, self.vals * r[lane, self.row_of])
        g = g + lams[:, None] * self.mask * w
        return (self.weights * loss).sum(-1) + self._l2(w, lams), g

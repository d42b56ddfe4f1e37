"""Per-feature summary statistics over a batch.

Counterpart of ``photon_ml_tpu/data/statistics.py``: one pass of masked
reductions (sums via ``index_add_``, extrema via ``scatter_reduce``) over
the unweighted examples.  They feed ``compute_normalization``.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_torch.data.batch import Batch, DenseBatch, SparseBatch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FeatureStatistics:
    """Per-feature [dim] summaries over the real (unmasked) examples."""

    count: Tensor      # scalar — number of real examples
    mean: Tensor       # [dim]
    variance: Tensor   # [dim] (population variance)
    std: Tensor        # [dim]
    min: Tensor        # [dim]
    max: Tensor        # [dim]
    max_abs: Tensor    # [dim]
    num_nonzeros: Tensor  # [dim]

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]


def _partials(batch: Batch) -> tuple:
    """(n, Σx, Σx², nnz, min, max) over one batch's real examples: sums
    by ``index_add_``, extrema by ``scatter_reduce`` (±inf where a
    feature has no stored entry)."""
    mask = batch.mask
    n = mask.sum()
    dim = batch.dim
    real = mask[:, None] > 0.0
    inf = torch.tensor(float("inf"), dtype=mask.dtype, device=mask.device)
    if isinstance(batch, DenseBatch):
        xm = batch.x * mask[:, None]
        s1 = xm.sum(0)
        s2 = (xm * batch.x).sum(0)
        nnz = ((batch.x != 0.0) & real).sum(0).to(mask.dtype)
        x_min = torch.where(real, batch.x, inf).amin(0)
        x_max = torch.where(real, batch.x, -inf).amax(0)
        return n, s1, s2, nnz, x_min, x_max
    assert isinstance(batch, SparseBatch)
    v = batch.values
    cols = batch.col_ids.reshape(-1).long()
    vm = v * mask[:, None]
    zeros = torch.zeros(dim, dtype=v.dtype, device=v.device)
    s1 = zeros.index_add(0, cols, vm.reshape(-1))
    s2 = zeros.index_add(0, cols, (vm * v).reshape(-1))
    real_entry = (v != 0.0) & real
    nnz = zeros.index_add(0, cols, real_entry.to(v.dtype).reshape(-1))
    x_min = torch.full((dim,), float("inf"), dtype=v.dtype,
                       device=v.device).scatter_reduce(
        0, cols, torch.where(real_entry, v, inf).reshape(-1), "amin")
    x_max = torch.full((dim,), -float("inf"), dtype=v.dtype,
                       device=v.device).scatter_reduce(
        0, cols, torch.where(real_entry, v, -inf).reshape(-1), "amax")
    return n, s1, s2, nnz, x_min, x_max


def compute_statistics(batch) -> FeatureStatistics:
    """Masked reductions → FeatureStatistics.  Sparse batches are not
    densified; a feature absent from some rows has implicit zeros, so
    its extrema include 0.  A ``parallel.mesh.ShardedBatch`` folds its
    shards' partials in shard order (and across the world's processes
    when its mesh spans them)."""
    from photon_ml_torch.parallel.mesh import (
        ShardedBatch,
        all_reduce_max,
        all_reduce_sum,
        spans_world,
    )

    if isinstance(batch, ShardedBatch):
        dev = batch.mesh.device
        parts = [tuple(t.to(dev) for t in _partials(b))
                 for b in batch.shards]
        n, s1, s2, nnz, x_min, x_max = parts[0]
        for pn, p1, p2, pz, pmin, pmax in parts[1:]:
            n, s1, s2, nnz = n + pn, s1 + p1, s2 + p2, nnz + pz
            x_min = torch.minimum(x_min, pmin)
            x_max = torch.maximum(x_max, pmax)
        if spans_world(batch.mesh):
            n, s1, s2, nnz = all_reduce_sum([n, s1, s2, nnz])
            neg_min, x_max = all_reduce_max([-x_min, x_max])
            x_min = -neg_min
    else:
        n, s1, s2, nnz, x_min, x_max = _partials(batch)
    # A feature stored in fewer rows than there are has implicit zeros.
    implicit_zero = nnz < n
    x_min = torch.where(implicit_zero, x_min.clamp(max=0.0), x_min)
    x_max = torch.where(implicit_zero, x_max.clamp(min=0.0), x_max)

    # Unseen features: clean zeros, not ±inf.
    x_min = torch.where(torch.isfinite(x_min), x_min, 0.0)
    x_max = torch.where(torch.isfinite(x_max), x_max, 0.0)

    n_safe = n.clamp(min=1.0)
    mean = s1 / n_safe
    var = (s2 / n_safe - mean * mean).clamp(min=0.0)
    return FeatureStatistics(
        count=n, mean=mean, variance=var, std=var.sqrt(), min=x_min,
        max=x_max, max_abs=torch.maximum(x_min.abs(), x_max.abs()),
        num_nonzeros=nnz)

"""The distributed GLM objective: per-shard partials and one reduction.

Counterpart of ``photon_ml_tpu/parallel/distributed_objective.py``,
where the reference ``shard_map``s the local objective over the mesh and
``psum``s its partials.  Here every method runs the inner
``GLMObjective`` on each shard of a ``parallel.mesh.ShardedBatch`` (each
shard's own layout: B1 on its ELL and transposed ELL, B2/B3 on its GRR
plan) and sums the partials with ``mesh.reduce_partials``: in shard
order on the mesh's first device, then across the processes of an
initialized ``torch.distributed`` world.

Every data-side quantity is a sum over examples, so the reduced partials
equal the single-device result up to the order of float sums.
Regularization and the prior are example-independent: they are added
once, outside the sum.  Scoring (``predict_margins``, ``x_dot``) stays
shard-local: a shard's layout indexes only its own rows.

``OptimizationProblem.run`` takes this objective in place of the local
one (it reads the inner objective's ``reg`` and ``prior``).
Coefficients may carry a leading λ-lane axis ([L, d]), which every
shard's products take.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import RegularizationContext
from photon_ml_torch.parallel.mesh import Mesh, ShardedBatch, reduce_partials

Tensor = torch.Tensor


class DistributedGLMObjective:
    """``GLMObjective``'s surface over an example-sharded batch.  A plain
    class over the shards: the inner objective holds every parameter."""

    def __init__(self, objective: GLMObjective, mesh: Mesh):
        self.objective = objective
        self.mesh = mesh
        # Regularization and prior are added once, outside the sum.
        self._data_obj = dataclasses.replace(
            objective, reg=RegularizationContext.none(), prior=None)

    def replace(self, objective: GLMObjective) -> "DistributedGLMObjective":
        return DistributedGLMObjective(objective, self.mesh)

    # The inner objective's regularization and prior, so that
    # ``OptimizationProblem`` routes this objective as it does the local
    # one (OWL-QN on an L1 weight; TRON refuses one).
    @property
    def reg(self) -> RegularizationContext:
        return self.objective.reg

    @property
    def prior(self):
        return self.objective.prior

    def _each(self, batch: ShardedBatch, fn, *vectors) -> list:
        """``fn(*vectors, shard)`` a shard, the vectors copied once a
        distinct device."""
        copies: dict = {}
        out = []
        for b in batch.shards:
            dev = b.labels.device
            vs = copies.get(dev)
            if vs is None:
                vs = copies[dev] = [v.to(dev) for v in vectors]
            out.append(fn(*vs, b))
        return out

    def _sum(self, parts: list, like: Tensor):
        total = reduce_partials(parts, self.mesh)
        if isinstance(total, tuple):
            return tuple(t.to(like.device) for t in total)
        return total.to(like.device)

    def value(self, w: Tensor, batch: ShardedBatch) -> Tensor:
        val = self._sum(self._each(batch, self._data_obj.value, w), w)
        val = val + self.objective.reg.l2_value(w)
        if self.objective.prior is not None:
            val = val + self.objective.prior.value(w)
        return val

    def value_and_gradient(self, w: Tensor, batch: ShardedBatch
                           ) -> tuple[Tensor, Tensor]:
        v, g = self._sum(
            self._each(batch, self._data_obj.value_and_gradient, w), w)
        reg = self.objective.reg
        v, g = v + reg.l2_value(w), g + reg.l2_gradient(w)
        if self.objective.prior is not None:
            v = v + self.objective.prior.value(w)
            g = g + self.objective.prior.gradient(w)
        return v, g

    def gradient(self, w: Tensor, batch: ShardedBatch) -> Tensor:
        return self.value_and_gradient(w, batch)[1]

    def hessian_vector(self, w: Tensor, v: Tensor, batch: ShardedBatch
                       ) -> Tensor:
        hv = self._sum(
            self._each(batch, self._data_obj.hessian_vector, w, v), w)
        hv = hv + self.objective.reg.l2_hessian_vector(v)
        if self.objective.prior is not None:
            hv = hv + self.objective.prior.hessian_vector(v)
        return hv

    def hessian_diagonal(self, w: Tensor, batch: ShardedBatch) -> Tensor:
        hd = self._sum(
            self._each(batch, self._data_obj.hessian_diagonal, w), w)
        hd = hd + self.objective.reg.l2_hessian_diagonal(w)
        if self.objective.prior is not None:
            hd = hd + self.objective.prior.hessian_diagonal()
        return hd

    # Scoring: no reduction; this process's rows in shard order.
    def predict_margins(self, w: Tensor, batch: ShardedBatch) -> Tensor:
        return torch.cat([m.to(self.mesh.device) for m in self._each(
            batch, self._data_obj.predict_margins, w)], dim=-1)

    def x_dot(self, v: Tensor, batch: ShardedBatch) -> Tensor:
        """Raw X·v per example of this process's shards: a shard's layout
        indexes only its own rows, so the contraction is shard-local."""
        return torch.cat([m.to(self.mesh.device) for m in self._each(
            batch, lambda v_, b: b.x_dot(v_), v)], dim=-1)

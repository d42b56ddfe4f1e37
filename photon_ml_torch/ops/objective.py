"""The GLM objective: value, gradient and Hessian-vector over a batch.

Counterpart of ``photon_ml_tpu/ops/objective.py``: margin contraction →
elementwise loss → masked reduce / transposed contraction.  Total value
= Σ_i weight_i·ℓ(margin_i, y_i) + ½·λ₂·‖w‖² (+ the prior); L1 is the
optimizer's (OWL-QN).  The batch is passed per call, so one objective
serves many batches.

Every method also takes E independent problems at once: a lane-stacked
``DenseBatch`` (``x`` [E, c, p]) and coefficients [E, p] give [E]
values and [E, p] vectors (the reductions run over the last axis), the
counterpart of ``jax.vmap`` of these methods as the random-effect
buckets run them.

The swept (stacked-λ) surface, ``sweep_value_and_gradient`` and
``sweep_value``, is the same objective over one shared batch with
coefficients W [L, d] and a per-lane L2 weight [L] installed in its
regularization context: the products take the lane axis
(``SparseBatch``: one read of the ELL streams for every lane), the
arithmetic is this module's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from photon_ml_torch.data.batch import Batch, DenseBatch, SparseBatch
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.ops.losses import PointwiseLoss
from photon_ml_torch.ops.prior import GaussianPrior
from photon_ml_torch.ops.regularization import RegularizationContext

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    """(loss, regularization, normalization[, prior]) over a batch."""

    loss: PointwiseLoss
    reg: RegularizationContext
    norm: NormalizationContext
    prior: GaussianPrior | None = None

    # ---- internals --------------------------------------------------------

    def _margins(self, w: Tensor, batch: Batch) -> Tensor:
        m = batch.margins(self.norm.model_to_raw(w))
        if not self.norm.is_identity:
            m = m - self.norm.margin_correction(w)[..., None]
        return m

    def _residual_to_grad(self, r: Tensor, batch: Batch) -> Tensor:
        """r (masked and weighted, [n]) → model-space gradient [dim]."""
        return self.norm.grad_to_model(batch.xt_dot(r), r.sum(-1))

    # ---- value / gradient / Hessian ---------------------------------------

    def value(self, w: Tensor, batch: Batch) -> Tensor:
        m = self._margins(w, batch)
        wl = batch.weights * batch.mask
        val = (wl * self.loss.loss(m, batch.labels)).sum(-1) \
            + self.reg.l2_value(w)
        if self.prior is not None:
            val = val + self.prior.value(w)
        return val

    def value_and_gradient(self, w: Tensor, batch: Batch
                           ) -> tuple[Tensor, Tensor]:
        """The hot path: (value, gradient) from one margin pass and one
        transposed contraction."""
        m = self._margins(w, batch)
        wl = batch.weights * batch.mask
        val = (wl * self.loss.loss(m, batch.labels)).sum(-1) \
            + self.reg.l2_value(w)
        r = wl * self.loss.d1(m, batch.labels)
        grad = self._residual_to_grad(r, batch) + self.reg.l2_gradient(w)
        if self.prior is not None:
            val = val + self.prior.value(w)
            grad = grad + self.prior.gradient(w)
        return val, grad

    def gradient(self, w: Tensor, batch: Batch) -> Tensor:
        return self.value_and_gradient(w, batch)[1]

    def hessian_vector(self, w: Tensor, v: Tensor, batch: Batch) -> Tensor:
        """Xᵀ diag(wl·d2) X v (+ λ₂ v), with the normalization algebra of
        the forward pass on Xv."""
        m = self._margins(w, batch)
        wl = batch.weights * batch.mask
        d2 = wl * self.loss.d2(m, batch.labels)
        xv = batch.x_dot(self.norm.model_to_raw(v))
        if not self.norm.is_identity:
            xv = xv - self.norm.margin_correction(v)[..., None]
        out = self._residual_to_grad(d2 * xv, batch) \
            + self.reg.l2_hessian_vector(v)
        if self.prior is not None:
            out = out + self.prior.hessian_vector(v)
        return out

    def hessian_diagonal(self, w: Tensor, batch: Batch) -> Tensor:
        """diag(Xᵀ diag(wl·d2) X) + λ₂; with shifts, the cross terms of
        (x_j − s_j)² = x_j² − 2·s_j·x_j + s_j² are included."""
        m = self._margins(w, batch)
        wl = batch.weights * batch.mask
        d2 = wl * self.loss.d2(m, batch.labels)
        prior_diag = (self.prior.hessian_diagonal()
                      if self.prior is not None else 0.0)
        diag_raw = _elementwise_square_batch(batch).xt_dot(d2)
        if self.norm.is_identity:
            return diag_raw + self.reg.l2_hessian_diagonal(w) + prior_diag
        f = (self.norm.factors if self.norm.factors is not None
             else torch.ones_like(w))
        diag = diag_raw * f * f
        if self.norm.shifts is not None:
            s = self.norm.shifts
            cross = batch.xt_dot(d2)            # Σ_i d2_i · x_ij
            total = d2.sum(-1)                  # Σ_i d2_i
            diag = diag - 2.0 * f * f * s * cross + f * f * s * s * total
        return diag + self.reg.l2_hessian_diagonal(w) + prior_diag

    # ---- conveniences -----------------------------------------------------

    def predict_margins(self, w: Tensor, batch: Batch) -> Tensor:
        return self._margins(w, batch)

    def predict_means(self, w: Tensor, batch: Batch) -> Tensor:
        return self.loss.mean(self._margins(w, batch))


def _elementwise_square_batch(batch: Batch) -> Batch:
    """The batch with x_ij → x_ij² (same sparsity)."""
    if isinstance(batch, DenseBatch):
        return dataclasses.replace(batch, x=batch.x * batch.x)
    assert isinstance(batch, SparseBatch)
    return dataclasses.replace(
        batch, values=batch.values * batch.values,
        colmajor=(None if batch.colmajor is None
                  else batch.colmajor.squared()),
        colsorted=(None if batch.colsorted is None
                   else batch.colsorted.squared()),
        grr=None if batch.grr is None else batch.grr.squared())


def _lane_objective(obj: GLMObjective, l2_weights: Tensor) -> GLMObjective:
    """``obj`` with a per-lane L2 weight [L] installed.  Only the smooth
    L2 part varies across lanes; per-lane L1 is the optimizer's
    (OWL-QN)."""
    return dataclasses.replace(obj, reg=dataclasses.replace(
        obj.reg, l2_weight=l2_weights))


def sweep_value_and_gradient(obj: GLMObjective, W: Tensor, batch: Batch,
                             l2_weights: Tensor) -> tuple[Tensor, Tensor]:
    """(W [L, dim], shared batch) → (values [L], gradients [L, dim]),
    with lane l's L2 weight ``l2_weights[l]``."""
    return _lane_objective(obj, l2_weights).value_and_gradient(W, batch)


def sweep_value(obj: GLMObjective, W: Tensor, batch: Batch,
                l2_weights: Tensor) -> Tensor:
    """Value-only lane sweep (line-search trials): W [L, dim] → [L]."""
    return _lane_objective(obj, l2_weights).value(W, batch)


class ObjectiveFns(NamedTuple):
    """Plain-function view for optimizers that take callables."""

    value_and_grad: Callable
    hvp: Callable


def as_fns(obj: GLMObjective, batch: Batch) -> ObjectiveFns:
    return ObjectiveFns(
        value_and_grad=lambda w: obj.value_and_gradient(w, batch),
        hvp=lambda w, v: obj.hessian_vector(w, v, batch))

"""Gaussian-process regression over observed (config, evaluation) pairs.

Counterpart of ``photon_ml_tpu/hyperparameter/gp.py``: an exact GP with
Cholesky solves (tuning histories are tens of points), its kernel
hyperparameters chosen by the log marginal likelihood over a small grid.
On the CPU: the kernel matrices in float32 from float32 points, as the
reference computes them; the Cholesky factor, the solves and the
likelihood in float64.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from photon_ml_torch.hyperparameter.kernels import KernelType, kernel_fn

Tensor = torch.Tensor


@dataclasses.dataclass
class GaussianProcessModel:
    """Posterior state: predict mean/std at new points."""

    x_train: Tensor         # [n, d] rescaled observations (float32)
    chol: Tensor            # [n, n] Cholesky of K + σ_n² I
    alpha: Tensor           # [n] (K + σ_n² I)⁻¹ (y − μ)
    y_mean: Tensor          # scalar target mean (centering)
    kind: KernelType
    amplitude: float
    lengthscale: float
    noise: float

    def predict(self, x) -> tuple[Tensor, Tensor]:
        """Posterior (mean, std) at [m, d] candidate points."""
        x = torch.as_tensor(x, dtype=torch.float32)
        k = kernel_fn(self.kind)
        k_star = k(self.x_train, x, self.amplitude,
                   self.lengthscale).double()
        mean = self.y_mean + k_star.T @ self.alpha
        v = torch.linalg.solve_triangular(self.chol, k_star, upper=False)
        var = torch.clamp(self.amplitude**2 - (v * v).sum(0), min=1e-12)
        return mean, torch.sqrt(var)


def _fit_fixed(x: Tensor, y: Tensor, kind: KernelType, amplitude,
               lengthscale, noise):
    k = kernel_fn(kind)
    n = x.shape[0]
    y_mean = y.mean()
    yc = (y - y_mean).double()
    gram = (k(x, x, amplitude, lengthscale).double()
            + (noise**2 + 1e-8) * torch.eye(n, dtype=torch.float64))
    chol, info = torch.linalg.cholesky_ex(gram)
    if info != 0:
        # Not positive definite at the float32 kernel's resolution (points
        # closer than it resolves): NaN, as the reference's factorization
        # gives, so this grid point never wins the likelihood.
        chol = torch.full_like(gram, float("nan"))
    alpha = torch.cholesky_solve(yc[:, None], chol)[:, 0]
    lml = (-0.5 * torch.dot(yc, alpha)
           - torch.log(torch.diagonal(chol)).sum()
           - 0.5 * n * math.log(2.0 * math.pi))
    return chol, alpha, y_mean, lml


def fit_gp(
    x,
    y,
    kind: KernelType = KernelType.MATERN52,
    lengthscales=(0.1, 0.2, 0.4, 0.8),
    noises=(1e-3, 1e-2, 1e-1),
) -> GaussianProcessModel:
    """Fit by marginal-likelihood model selection over a small grid.

    Amplitude is std(y) (empirical-Bayes scaling); lengthscale and noise
    are chosen by LML over the grid."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32)
    amplitude = float(y.std(unbiased=False)) or 1.0

    best = None
    for ls in lengthscales:
        for nz in noises:
            chol, alpha, y_mean, lml = _fit_fixed(
                x, y, kind, amplitude, ls, nz)
            if best is None or float(lml) > best[0]:
                best = (float(lml), chol, alpha, y_mean, ls, nz)
    _, chol, alpha, y_mean, ls, nz = best
    return GaussianProcessModel(
        x_train=x, chol=chol, alpha=alpha, y_mean=y_mean, kind=kind,
        amplitude=amplitude, lengthscale=ls, noise=nz)

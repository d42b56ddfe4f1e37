"""Coefficient variances from the Hessian at the optimum.

Counterpart of ``photon_ml_tpu/optim/variance.py``:

- SIMPLE: var_j = 1 / H_jj, one Hessian-diagonal pass;
- FULL:   var_j = (H⁻¹)_jj, H built from d Hessian-vector products
  against the identity's columns, then a Cholesky solve.

SIMPLE also takes lane-stacked problems (the random-effect buckets, one
lane an entity), as the objective does.
"""

from __future__ import annotations

import enum

import torch

from photon_ml_torch.data.batch import Batch
from photon_ml_torch.ops.objective import GLMObjective

Tensor = torch.Tensor


class VarianceComputationType(str, enum.Enum):
    NONE = "NONE"
    SIMPLE = "SIMPLE"
    FULL = "FULL"


def simple_variances(obj: GLMObjective, w: Tensor, batch: Batch) -> Tensor:
    """1 / diag(H) at w."""
    return 1.0 / torch.clamp(obj.hessian_diagonal(w, batch), min=1e-12)


def materialize_hessian(obj: GLMObjective, w: Tensor, batch: Batch
                        ) -> Tensor:
    """[d, d] Hessian, one HVP per identity column (H is symmetric, so
    the stacked products are H itself)."""
    eye = torch.eye(w.shape[-1], dtype=w.dtype, device=w.device)
    return torch.stack([obj.hessian_vector(w, v, batch) for v in eye])


def full_variances(obj: GLMObjective, w: Tensor, batch: Batch) -> Tensor:
    """diag(H⁻¹) at w via Cholesky (H is SPD for a convex GLM + L2); a
    1e-8 jitter keeps nearly flat unregularized directions factorable."""
    dim = w.shape[-1]
    eye = torch.eye(dim, dtype=w.dtype, device=w.device)
    h = materialize_hessian(obj, w, batch)
    chol = torch.linalg.cholesky(h + 1e-8 * eye)
    return torch.diagonal(torch.cholesky_solve(eye, chol))


def compute_variances(obj: GLMObjective, w: Tensor, batch: Batch,
                      variance_type: VarianceComputationType
                      ) -> Tensor | None:
    if variance_type == VarianceComputationType.NONE:
        return None
    if variance_type == VarianceComputationType.SIMPLE:
        return simple_variances(obj, w, batch)
    return full_variances(obj, w, batch)

"""Parity of ``photon_ml_torch.ops.losses`` with the JAX package's losses
(value, both derivatives and the mean) on the same numpy inputs, in
float32; margins reach past the Poisson soft-exp switch at z = 30.
Tolerance ``rtol=1e-6, atol=1e-6``: the same elementwise formulas."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jl
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.ops import losses as tl
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)

NAMES = ["logistic", "squared", "poisson", "smoothed_hinge"]


def _zy(seed: int = 0):
    rng = np.random.default_rng(seed)
    z = np.concatenate([rng.normal(0, 3, 200), [-40.0, -1.0, 0.0, 0.5,
                                                1.0, 29.9, 30.0, 31.5,
                                                45.0]]).astype(np.float32)
    y = rng.integers(0, 2, len(z)).astype(np.float32)
    return z, y


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("fn", ["loss", "d1", "d2", "mean"])
def test_loss_parity_with_jax(name, fn):
    z, y = _zy()
    jf, tf = getattr(jl.get_loss(name), fn), getattr(tl.get_loss(name), fn)
    if fn == "mean":
        want = np.asarray(jf(jnp.asarray(z)))
        got = tf(torch.from_numpy(z))
    else:
        want = np.asarray(jf(jnp.asarray(z), jnp.asarray(y)))
        got = tf(torch.from_numpy(z), torch.from_numpy(y))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_poisson_mean_is_soft_exp_not_exp():
    z = torch.tensor([10.0, 30.0, 35.0])
    m = tl.POISSON.mean(z)
    assert torch.isfinite(m).all()
    assert m[2] < torch.exp(torch.tensor(35.0))
    assert float(m[0]) == pytest.approx(float(torch.exp(z[0])), rel=1e-6)


def test_task_aliases_match_jax():
    for task in TaskType:
        assert task.loss.name == jl.get_loss(task.value).name
    with pytest.raises(ValueError, match="Unknown loss"):
        tl.get_loss("hinge_of_doom")

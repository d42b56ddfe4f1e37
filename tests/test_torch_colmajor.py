"""Parity of the port's transposed-ELL layout (``data.colmajor``) with the
JAX package's.

Same seeded numpy inputs to both packages, the port on CPU tensors
(where ``gather_rowsum`` is its plain version).  Tolerances: the built
arrays identical to the JAX build, with the native builder on and off;
``xt_dot`` within 1e-5·max|g| at capacities 8, 16 and auto, on the shapes
of ``tests/test_colmajor.py``; objective surfaces on a transposed-ELL
batch within 2e-5 of the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_torch.data import colmajor as tcm
from photon_ml_torch.data.batch import make_sparse_batch
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.ops import kernels as tk
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import RegularizationContext
from test_torch_training import (  # noqa: F401  (C1, C5)
    jax_c1,
    jax_fresh_caches,
)

CPU = "cpu"


def _random_rows(rng, n, dim, max_nnz):
    rows = []
    for _ in range(n):
        nnz = int(rng.integers(1, max_nnz + 1))
        cols = rng.choice(dim, size=nnz, replace=False).astype(np.int64)
        rows.append((cols, rng.normal(0, 1, nnz)))
    return rows


def _skewed_rows(rng, n, dim, max_nnz):
    """Column 0 and 1 in every row: virtual-row splitting at small C."""
    rows = []
    for _ in range(n):
        nnz = int(rng.integers(2, max_nnz + 1))
        cold = 2 + rng.choice(dim - 2, size=nnz - 2, replace=False)
        cols = np.concatenate([[0, 1], cold]).astype(np.int64)
        rows.append((cols, rng.normal(0, 1, nnz)))
    return rows


def _ell(rows, dim):
    from photon_ml_tpu.data.batch import make_sparse_batch as jmake

    b = jmake(rows, dim, np.zeros(len(rows)))
    return np.array(b.col_ids), np.array(b.values)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("capacity", [8, 16, None])
@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_build_identical_to_reference(native, capacity, drop, monkeypatch):
    import photon_ml_torch.native as tnat
    import photon_ml_tpu.native as jnat
    from photon_ml_tpu.data.colmajor import build_colmajor as jbuild

    if native:
        if not (tnat.native_available() and jnat.native_available()):
            pytest.skip("native library unavailable (no g++)")
    else:
        monkeypatch.setattr(tnat, "_lib", None)
        monkeypatch.setattr(jnat, "_lib", None)
    rng = np.random.default_rng(3)
    cols, vals = _ell(_skewed_rows(rng, 64, 40, 12), 40)
    vals[rng.random(vals.shape) < drop] = 0.0      # dropped entries
    ref = jbuild(cols, vals, 40, capacity=capacity)
    got = tcm.build_colmajor(cols, vals, 40, capacity=capacity, device=CPU)
    for name in ("tvals", "trows", "vcol"):
        want = np.asarray(getattr(ref, name))
        have = getattr(got, name).numpy()
        assert have.shape == want.shape, name
        np.testing.assert_array_equal(have, want.astype(have.dtype), name)
    assert got.dim == ref.dim == 40


def test_native_and_numpy_builds_are_byte_identical(monkeypatch):
    import photon_ml_torch.native as tnat

    if not tnat.native_available():
        pytest.skip("native library unavailable (no g++)")
    rng = np.random.default_rng(4)
    cols, vals = _ell(_random_rows(rng, 200, 300, 20), 300)
    native = tcm.build_colmajor_arrays(cols, vals, 300)
    monkeypatch.setattr(tnat, "_lib", None)
    numpy_ = tcm.build_colmajor_arrays(cols, vals, 300)
    for a, b in zip(native, numpy_):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("maker", [_random_rows, _skewed_rows])
@pytest.mark.parametrize("capacity", [8, 16, None])
def test_xt_dot_matches_reference(maker, capacity):
    from photon_ml_tpu.data.colmajor import build_colmajor as jbuild
    import jax.numpy as jnp

    rng = np.random.default_rng(42)
    n, dim = 64, 40
    cols, vals = _ell(maker(rng, n, dim, 12), dim)
    r = rng.normal(0, 1, n).astype(np.float32)
    want = np.asarray(jbuild(cols, vals, dim, capacity=capacity)
                      .xt_dot(jnp.asarray(r)))
    cm = tcm.build_colmajor(cols, vals, dim, capacity=capacity, device=CPU)
    before = tk.gather_rowsum.launches
    got = cm.xt_dot(torch.from_numpy(r)).numpy()
    assert tk.gather_rowsum.launches == before        # plain on the CPU
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    dense = np.zeros((n, dim))
    np.add.at(dense, (np.repeat(np.arange(n), cols.shape[1]),
                      cols.reshape(-1)), vals.reshape(-1))
    np.testing.assert_allclose(got, dense.T @ r, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_splitting_and_capacity_rule():
    rng = np.random.default_rng(5)
    cols, vals = _ell(_skewed_rows(rng, 64, 40, 6), 40)
    cm = tcm.build_colmajor(cols, vals, 40, capacity=8, device=CPU)
    assert int((cm.vcol == 0).sum()) >= 8
    assert cm.capacity == 8 and cm.n_virtual_rows % 8 == 0
    from photon_ml_tpu.data.colmajor import choose_capacity as jchoose

    for counts in (np.zeros(10, np.int64), np.full(10, 3),
                   np.full(10, 100000), np.full(10, 100),
                   rng.zipf(1.5, 1000)):
        assert tcm.choose_capacity(counts) == jchoose(counts)


def test_squared_and_fold_in_float64():
    """``squared`` squares the values; the fold of many partial sums
    into one head column accumulates in float64."""
    n = 1 << 14
    cols = np.zeros((n, 1), np.int32)
    vals = np.ones((n, 1), np.float32)
    cm = tcm.build_colmajor(cols, vals, 1, capacity=8, device=CPU)
    assert cm.n_virtual_rows == n // 8
    r = torch.full((n,), 0.1)
    got = float(cm.xt_dot(r)[0])
    assert abs(got - n * np.float32(0.1)) <= 1e-6 * n * 0.1
    sq = dataclasses.replace(cm, tvals=cm.tvals * 2).squared()
    assert torch.equal(sq.tvals, torch.full_like(cm.tvals, 4.0))


def test_objective_surfaces_on_colmajor_batch(jax_c1):
    """``make_sparse_batch(col_major=True)`` against the reference's
    transposed-ELL batch, normalization shifts included; the Hessian
    diagonal goes through ``squared()``."""
    import jax.numpy as jnp

    from photon_ml_tpu.data.batch import make_sparse_batch as jmake
    from photon_ml_tpu.data.normalization import NormalizationContext as JN
    from photon_ml_tpu.ops import losses as jl
    from photon_ml_tpu.ops.objective import GLMObjective as JO
    from photon_ml_tpu.ops.regularization import RegularizationContext as JR

    rng = np.random.default_rng(6)
    n, dim = 48, 30
    rows = _random_rows(rng, n, dim, 10)
    labels = (rng.uniform(size=n) < 0.5).astype(np.float64)
    weights = rng.uniform(0.5, 2.0, n)
    jb = jmake(rows, dim, labels, weights=weights, col_major=True,
               col_capacity=8)
    tb = make_sparse_batch(rows, dim, labels, weights=weights, col_major=True,
                           col_capacity=8, device=CPU)
    assert tb.colmajor is not None and tb.colmajor.capacity == 8
    shift = rng.normal(0, 1, dim).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, dim).astype(np.float32)
    jo = JO(loss=jl.LOGISTIC, reg=JR.l2(0.3),
            norm=JN(factors=jnp.asarray(1 / scale), shifts=jnp.asarray(shift)))
    to = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(0.3),
                      NormalizationContext(factors=torch.from_numpy(1 / scale),
                                           shifts=torch.from_numpy(shift)))
    w = rng.normal(0, 0.5, dim).astype(np.float32)
    v = rng.normal(0, 1.0, dim).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    for name in ("value", "gradient", "hessian_diagonal"):
        want = np.asarray(getattr(jo, name)(jw, jb))
        got = getattr(to, name)(tw, tb).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=2e-5 * max(1.0, np.abs(want).max()),
                                   err_msg=name)
    np.testing.assert_allclose(
        to.hessian_vector(tw, torch.from_numpy(v), tb).numpy(),
        np.asarray(jo.hessian_vector(jw, jnp.asarray(v), jb)),
        rtol=2e-5, atol=2e-5)

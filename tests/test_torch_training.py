"""Parity of the port's fixed-effect training path with the JAX package.

LIBSVM → ``make_sparse_batch`` (plain ELL or GRR) → statistics and
normalization → ``GLMObjective`` → ``OptimizationProblem.run`` (L-BFGS,
OWL-QN) → ``GeneralizedLinearModel`` → AUC, on the same numpy inputs in
both packages, the port on CPU tensors.  Tolerances: objective surfaces
``rtol=1e-5`` (float32, sums in another order; gradients with an
absolute floor of 1e-5·max|g|); a fit's final loss 1e-5 relative, its
coefficients 1e-3, its held-out AUC 1e-3.

The reference's L2 evaluations need the ``trace_state_clean`` shim
(ROADMAP C1): jax 0.9 moved it out of ``jax.core``.  The ``jax_c1``
fixture installs it with ``monkeypatch`` for one test at a time, so it
never leaks into the reference's own test files.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_torch.data.batch import DenseBatch, make_sparse_batch
from photon_ml_torch.data.normalization import (
    NormalizationContext,
    NormalizationType,
    compute_normalization,
)
from photon_ml_torch.data.statistics import compute_statistics
from photon_ml_torch.evaluation import evaluators as tev
from photon_ml_torch.io.libsvm import read_libsvm, write_libsvm
from photon_ml_torch.models import (
    Coefficients,
    GeneralizedLinearModel,
    TaskType,
)
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import (
    RegularizationContext,
    SweptRegularization,
    exclude_intercept_mask,
)
from photon_ml_torch.optim.base import OptimizerConfig, OptimizerType
from photon_ml_torch.optim.problem import OptimizationProblem

RESOURCES = os.path.join(os.path.dirname(__file__), "resources")
CPU = "cpu"


@pytest.fixture
def jax_c1(monkeypatch):
    """The JAX package with ``jax.core.trace_state_clean`` restored for
    this test only (ROADMAP C1).  The reference caches a constant the
    first time the call succeeds (``regularization._HALF``); it is put
    back too, so later tests in this worker see the package unchanged."""
    import jax
    import jax._src.core

    from photon_ml_tpu.ops import regularization

    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)
    monkeypatch.setattr(regularization, "_HALF", regularization._HALF)
    return jax


def _a1a(n, seed=7):
    from photon_ml_tpu.utils.synthetic import make_a1a_like

    rows, labels, _ = make_a1a_like(n=n, seed=seed)
    return rows, labels


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def _assert_grad_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _ref_objective(jax, reg, norm=None):
    from photon_ml_tpu.data.normalization import NormalizationContext as JN
    from photon_ml_tpu.ops import losses as jl
    from photon_ml_tpu.ops.objective import GLMObjective as JO

    return JO(loss=jl.LOGISTIC, reg=reg, norm=norm or JN.identity())


# -- objective surfaces --------------------------------------------------------------


@pytest.mark.parametrize("layout", ["ell", "grr"])
@pytest.mark.parametrize("normalized", [False, True])
def test_objective_surfaces_match_reference(jax_c1, layout, normalized):
    import jax.numpy as jnp

    from photon_ml_tpu.data.batch import make_sparse_batch as jmake
    from photon_ml_tpu.data.normalization import (
        NormalizationType as JNT,
        compute_normalization as jnorm,
    )
    from photon_ml_tpu.data.statistics import compute_statistics as jstats
    from photon_ml_tpu.ops.regularization import RegularizationContext as JR

    rows, labels = _a1a(600, seed=3)
    dim = 123
    grr = layout == "grr"
    jb = jmake(rows, dim, labels, grr=grr)
    tb = make_sparse_batch(rows, dim, labels, grr=grr, device=CPU)
    if grr:
        assert tb.grr is not None
    jn, tn = None, NormalizationContext.identity()
    if normalized:
        js = jstats(jb)
        jn = jnorm(js.mean, js.std, js.max_abs, JNT.STANDARDIZATION)
        ts = compute_statistics(tb)
        tn = compute_normalization(ts.mean, ts.std, ts.max_abs,
                                   NormalizationType.STANDARDIZATION)
    jo = _ref_objective(jax_c1, JR.l2(0.5), jn)
    to = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(0.5), tn)
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.2, dim).astype(np.float32)
    v = rng.normal(0, 1, dim).astype(np.float32)
    jv, jg = jo.value_and_gradient(jnp.asarray(w), jb)
    tv, tg = to.value_and_gradient(_t(w), tb)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    _assert_grad_close(tg.numpy(), jg)
    np.testing.assert_allclose(float(to.value(_t(w), tb)), float(jv),
                               rtol=1e-5)
    _assert_grad_close(to.hessian_vector(_t(w), _t(v), tb).numpy(),
                       jo.hessian_vector(jnp.asarray(w), jnp.asarray(v), jb))
    _assert_grad_close(to.hessian_diagonal(_t(w), tb).numpy(),
                       jo.hessian_diagonal(jnp.asarray(w), jb))
    np.testing.assert_allclose(
        to.predict_means(_t(w), tb).numpy(),
        np.asarray(jo.predict_means(jnp.asarray(w), jb)), rtol=1e-5,
        atol=1e-6)


def test_dense_batch_matches_sparse():
    rows, labels = _a1a(300, seed=4)
    sb = make_sparse_batch(rows, 123, labels, device=CPU)
    db = sb.to_dense()
    assert isinstance(db, DenseBatch) and db.dim == 123
    obj = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(1.0),
                       NormalizationContext.identity())
    w = _t(np.random.default_rng(0).normal(0, 0.3, 123))
    for a, b in zip(obj.value_and_gradient(w, sb),
                    obj.value_and_gradient(w, db)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(obj.hessian_diagonal(w, sb).numpy(),
                               obj.hessian_diagonal(w, db).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_statistics_match_reference():
    from photon_ml_tpu.data.batch import make_sparse_batch as jmake
    from photon_ml_tpu.data.statistics import compute_statistics as jstats

    rng = np.random.default_rng(2)
    rows = [(np.sort(rng.choice(40, rng.integers(1, 8), replace=False)),
             rng.normal(0, 2, 8)) for _ in range(150)]
    rows = [(c.astype(np.int32), v[: len(c)].astype(np.float32))
            for c, v in rows]
    labels = (rng.random(150) < 0.5).astype(np.float32)
    js = jstats(jmake(rows, 50, labels, pad_to=160))
    ts = compute_statistics(make_sparse_batch(rows, 50, labels, pad_to=160,
                                              device=CPU))
    for f in ("mean", "variance", "std", "min", "max", "max_abs",
              "num_nonzeros"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    assert float(ts.count) == float(js.count) == 150


# -- fits ----------------------------------------------------------------------------


def _ref_fit(jax, rows, labels, dim, reg, norm_type, max_iters=200,
             tolerance=1e-6):
    import jax.numpy as jnp

    from photon_ml_tpu.data.batch import make_sparse_batch as jmake
    from photon_ml_tpu.data.normalization import (
        NormalizationContext as JN,
        compute_normalization as jnorm,
    )
    from photon_ml_tpu.data.statistics import compute_statistics as jstats
    from photon_ml_tpu.optim import OptimizationProblem as JP
    from photon_ml_tpu.optim import OptimizerConfig as JC

    batch = jmake(rows, dim, labels)
    norm = JN.identity()
    if norm_type is not None:
        s = jstats(batch)
        norm = jnorm(s.mean, s.std, s.max_abs, norm_type)
    prob = JP(objective=_ref_objective(jax, reg, norm),
              config=JC(max_iters=max_iters, tolerance=tolerance))
    res = jax.jit(prob.run)(batch, jnp.zeros(dim, jnp.float32))
    return res, norm


def test_config1_flow_matches_reference(jax_c1, tmp_path):
    """The config-1 flow of ``tests/test_e2e_glm.py`` (LIBSVM on disk,
    STANDARDIZATION, L-BFGS, L2) on both layouts of the port."""
    from photon_ml_tpu.data.normalization import NormalizationType as JNT
    from photon_ml_tpu.evaluation import auc as jauc
    from photon_ml_tpu.io import read_libsvm as jread
    from photon_ml_tpu.ops.regularization import RegularizationContext as JR
    from photon_ml_tpu.utils.synthetic import make_a1a_like

    rows, labels, _ = make_a1a_like(n=3000)
    path = str(tmp_path / "a1a_like.libsvm")
    write_libsvm(path, rows, 2.0 * labels - 1.0)
    rows_r, y, dim = read_libsvm(path, n_features=123)
    assert dim == 123 and len(rows_r) == 3000
    jrows, jy, _ = jread(path, n_features=123)
    np.testing.assert_array_equal(y, np.asarray(jy))
    n_train = 2000

    ref, jn = _ref_fit(jax_c1, jrows[:n_train], jy[:n_train], dim,
                       JR.l2(1.0), JNT.STANDARDIZATION)
    from photon_ml_tpu.data.batch import make_sparse_batch as jmake

    jtest = jmake(jrows[n_train:], dim, jy[n_train:])
    ref_auc = float(jauc(jtest.margins(jn.model_to_raw(ref.w))
                         - jn.margin_correction(ref.w), jtest.labels,
                         mask=jtest.mask))

    for layout in ("ell", "grr"):
        train = make_sparse_batch(rows_r[:n_train], dim, y[:n_train],
                                  grr=layout == "grr", device=CPU)
        test = make_sparse_batch(rows_r[n_train:], dim, y[n_train:],
                                 grr=layout == "grr", device=CPU)
        stats = compute_statistics(train)
        norm = compute_normalization(stats.mean, stats.std, stats.max_abs,
                                     NormalizationType.STANDARDIZATION)
        obj = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(1.0),
                           norm)
        res = OptimizationProblem(
            obj, config=OptimizerConfig(max_iters=200, tolerance=1e-6)
        ).run(train, torch.zeros(dim))
        assert res.converged
        model = GeneralizedLinearModel(
            Coefficients(norm.model_to_raw(res.w)),
            TaskType.LOGISTIC_REGRESSION)
        shift = norm.margin_correction(res.w)
        test_auc = float(tev.auc(model.compute_score(test) - shift,
                                 test.labels, mask=test.mask))
        assert test_auc >= 0.80, (layout, test_auc)
        assert abs(test_auc - ref_auc) <= 1e-3, (layout, test_auc, ref_auc)
        np.testing.assert_allclose(float(res.value), float(ref.value),
                                   rtol=1e-5, err_msg=layout)
        np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w),
                                   atol=1e-3, err_msg=layout)


def test_owlqn_elastic_net_matches_reference(jax_c1):
    from photon_ml_tpu.ops.regularization import RegularizationContext as JR

    rows, labels = _a1a(800, seed=5)
    dim = 123
    ref, _ = _ref_fit(jax_c1, rows, labels, dim, JR.elastic_net(4.0, 0.5),
                      None, max_iters=150, tolerance=1e-6)
    problem = OptimizationProblem(
        GLMObjective(losses.LOGISTIC,
                     RegularizationContext.elastic_net(4.0, 0.5),
                     NormalizationContext.identity()),
        config=OptimizerConfig(max_iters=150, tolerance=1e-6))
    assert problem.has_l1()
    res = problem.run(make_sparse_batch(rows, dim, labels, device=CPU),
                      torch.zeros(dim))
    np.testing.assert_allclose(float(res.value), float(ref.value),
                               rtol=1e-5)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), atol=1e-3)
    zeros_ref = np.asarray(ref.w) == 0.0
    assert zeros_ref.sum() > 10                       # L1 made it sparse
    assert (res.w.numpy()[zeros_ref] == 0.0).mean() > 0.95


def test_config1_golden_reproduced():
    """The committed ``config1.libsvm`` golden (``tests/test_fixtures.py``:
    intercept, L2 1.0 sparing the intercept, L-BFGS 100 iterations)
    through the port's reader and solver."""
    with open(os.path.join(RESOURCES, "golden.json")) as f:
        want = json.load(f)["config1"]

    def read(path, n_features=None):
        rows, y, dim = read_libsvm(path, n_features=n_features)
        return rows.with_constant_col(dim), y, dim

    train_rows, y, dim = read(os.path.join(RESOURCES, "config1.libsvm"))
    valid_rows, yv, _ = read(os.path.join(RESOURCES, "config1.t.libsvm"),
                             n_features=dim)
    mask = exclude_intercept_mask(dim + 1, dim, device=CPU)
    problem = OptimizationProblem(
        GLMObjective(losses.LOGISTIC, RegularizationContext.l2(1.0, mask),
                     NormalizationContext.identity()),
        config=OptimizerConfig(max_iters=100, tolerance=1e-6))
    res = problem.run(make_sparse_batch(train_rows, dim + 1, y, device=CPU),
                      torch.zeros(dim + 1))
    np.testing.assert_allclose(res.w.numpy(), np.asarray(want["coefficients"]),
                               rtol=2e-3, atol=2e-3)
    valid = make_sparse_batch(valid_rows, dim + 1, yv, device=CPU)
    got_auc = float(tev.auc(valid.margins(res.w), valid.labels,
                            mask=valid.mask))
    assert abs(got_auc - want["auc"]) < 2e-3


# -- pieces ----------------------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False])
def test_read_libsvm_matches_reference(native, monkeypatch):
    import photon_ml_torch.native as tnat
    import photon_ml_tpu.native as jnat
    from photon_ml_tpu.io import read_libsvm as jread

    if not native:
        monkeypatch.setattr(tnat, "_lib", None)
        monkeypatch.setattr(jnat, "_lib", None)
    path = os.path.join(RESOURCES, "config1.libsvm")
    rows, y, dim = read_libsvm(path)
    jrows, jy, jdim = jread(path)
    assert dim == jdim
    np.testing.assert_array_equal(y, jy)
    for f in ("indptr", "cols", "vals"):
        a, b = getattr(rows, f), getattr(jrows, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("name", ["AUC", "RMSE", "LOGISTIC_LOSS",
                                  "POISSON_LOSS", "SQUARED_LOSS"])
def test_evaluators_match_reference(name):
    import jax.numpy as jnp

    from photon_ml_tpu.evaluation import evaluators as jev

    rng = np.random.default_rng(len(name))
    n = 500
    scores = np.round(rng.normal(0, 1, n), 1).astype(np.float32)  # ties
    labels = (rng.random(n) < 0.4).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, n).astype(np.float32)
    mask = (rng.random(n) < 0.9).astype(np.float32)
    got = tev.evaluate(tev.EvaluatorType(name), _t(scores), _t(labels),
                       _t(weights), _t(mask))
    want = jev.evaluate(jev.EvaluatorType(name), jnp.asarray(scores),
                        jnp.asarray(labels), jnp.asarray(weights),
                        jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_regularization_and_prior_match_reference():
    import jax.numpy as jnp

    from photon_ml_tpu.ops.prior import GaussianPrior as JG
    from photon_ml_tpu.ops.regularization import (
        exclude_intercept_mask as jmask,
    )

    from photon_ml_torch.ops.prior import GaussianPrior

    rng = np.random.default_rng(3)
    w = rng.normal(0, 1, 20).astype(np.float32)
    mask = exclude_intercept_mask(20, 19, device=CPU)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask(20, 19)))
    assert exclude_intercept_mask(20, None, device=CPU) is None
    reg = RegularizationContext.elastic_net(2.0, 0.25, mask)
    assert (reg.l1_weight, reg.l2_weight) == (0.5, 1.5)
    l1 = OptimizationProblem(GLMObjective(
        losses.LOGISTIC, reg, NormalizationContext.identity()))._l1_vector(
        _t(w))
    np.testing.assert_array_equal(l1.numpy(), 0.5 * mask.numpy())
    means = rng.normal(0, 1, 20).astype(np.float32)
    var = rng.uniform(0.1, 2, 20).astype(np.float32)
    tp = GaussianPrior.from_model(_t(means), _t(var), weight=0.7)
    jp = JG.from_model(jnp.asarray(means), jnp.asarray(var), weight=0.7)
    np.testing.assert_allclose(float(tp.value(_t(w))),
                               float(jp.value(jnp.asarray(w))), rtol=1e-6)
    np.testing.assert_allclose(tp.gradient(_t(w)).numpy(),
                               np.asarray(jp.gradient(jnp.asarray(w))),
                               rtol=1e-6)
    obj = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(0.3, mask),
                       NormalizationContext.identity(), prior=tp)
    rows, labels = _a1a(100, seed=9)
    rows = [(c, v) for c, v in rows if c.max() < 19]
    batch = make_sparse_batch(rows, 20, labels[: len(rows)], device=CPU)
    val, grad = obj.value_and_gradient(_t(w), batch)
    w64 = torch.from_numpy(w.astype(np.float64)).requires_grad_()
    f64 = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(
        0.3, mask.double()), NormalizationContext.identity(),
        prior=GaussianPrior(tp.means.double(), tp.precisions.double(), 0.7))
    b64 = DenseBatch(batch.to_dense().x.double(), batch.labels.double(),
                     batch.weights.double(), batch.offsets.double(),
                     batch.mask.double())
    f64.value(w64, b64).backward()
    np.testing.assert_allclose(grad.numpy(), w64.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_unported_options_raise():
    """The transposed ELL, TRON, the swept λ solve and the chunked fixed
    effect are ported now (they ran into ``NotImplementedError`` naming
    A2, A6 and A5 before); a swept solve of a TRON coordinate raises
    ``ValueError`` as in the reference, and the options still missing
    raise, naming their ROADMAP items: the streamed random effect (A5b)
    and GRR chunks (A7)."""
    from photon_ml_torch.data.chunked_batch import build_chunked_batch
    from photon_ml_torch.game.coordinates import (
        ChunkedFixedEffectCoordinate,
        FixedEffectCoordinate,
        build_streamed_random_effect_coordinate,
    )

    rows, labels = _a1a(50)
    batch = make_sparse_batch(rows, 123, labels, col_major=True, device=CPU)
    assert batch.colmajor is not None
    problem = OptimizationProblem(
        GLMObjective(losses.LOGISTIC, RegularizationContext.l2(1.0),
                     NormalizationContext.identity()),
        optimizer=OptimizerType.TRON)
    res = problem.run(batch, torch.zeros(123))
    assert res.converged and res.iterations > 0
    coord = FixedEffectCoordinate("global", batch, problem)
    with pytest.raises(ValueError, match="LBFGS/OWL-QN lanes only"):
        coord.train_swept(torch.zeros(50), SweptRegularization.from_grid(
            "L2", [1.0, 0.1]))
    # The chunked fixed effect (A5a) and the streamed random effect
    # (A5b) are ported; a mesh and GRR chunks (A7) still raise.
    assert ChunkedFixedEffectCoordinate.train_swept
    with pytest.raises(NotImplementedError, match="A7"):
        build_streamed_random_effect_coordinate(
            "u", None, "re", None, spill_dir="/tmp/s", chunk_entities=4,
            mesh=object())
    with pytest.raises(NotImplementedError, match="A7"):
        build_chunked_batch(rows, 123, labels, n_chunks=2, layout="grr")


def test_duplicate_ids_rejected():
    rows = [(np.array([1, 1], np.int32), np.array([1.0, 2.0], np.float32))]
    with pytest.raises(ValueError, match="duplicate column ids"):
        make_sparse_batch(rows, 4, np.zeros(1), device=CPU)


def test_keep_ell_false_keeps_only_the_plan():
    rows, labels = _a1a(300, seed=8)
    full = make_sparse_batch(rows, 123, labels, grr=True, device=CPU)
    lean = make_sparse_batch(rows, 123, labels, grr=True, keep_ell=False,
                             device=CPU)
    assert lean.values.shape == (300, 0)
    obj = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(1.0),
                       NormalizationContext.identity())
    w = _t(np.random.default_rng(1).normal(0, 0.2, 123))
    for a, b in zip(obj.value_and_gradient(w, full),
                    obj.value_and_gradient(w, lean)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_solver_tracker_records_iterations():
    rows, labels = _a1a(400, seed=6)
    res = OptimizationProblem(
        GLMObjective(losses.LOGISTIC, RegularizationContext.l2(1.0),
                     NormalizationContext.identity()),
        config=OptimizerConfig(max_iters=15)).run(
        make_sparse_batch(rows, 123, labels, device=CPU), torch.zeros(123))
    t = res.tracker
    assert t.count == res.iterations + 1
    vals = t.values[: t.count].numpy()
    assert np.all(np.diff(vals) <= 0)                 # monotone descent
    assert np.isnan(t.values[t.count:].numpy()).all()
    assert float(res.value) == pytest.approx(float(vals[-1]))

"""Parity of the port's chunk-accumulated training with the JAX package.

Mirrors ``tests/test_chunked.py``: ``build_chunked_batch`` (ELL and GRR
chunks, alone or × mesh shards) →
``ChunkedGLMObjective`` → the streaming L-BFGS / OWL-QN / TRON solvers →
``ChunkedFixedEffectCoordinate`` → ``GameEstimator`` with
``chunk_rows``, the port on the CPU.  Tolerances: chunked surfaces
against resident, value 1e-5 relative and vectors 1e-4·max|v|; the
streaming solvers against their resident solvers and against the
reference's streaming solvers, final loss 1e-3 relative and
coefficients 5e-3; the estimator's chunked fit against the resident one
and the reference's, held-out AUC 1e-3.  The reference's L2 paths use
the ``jax_c1`` fixture (ROADMAP C1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_torch.config import (
    CoordinateConfig,
    CoordinateKind,
    NormalizationType,
    OptimizerSettings,
    TrainingConfig,
)
from photon_ml_torch.data.batch import make_sparse_batch
from photon_ml_torch.data.chunked_batch import build_chunked_batch
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.estimators.game_estimator import GameEstimator
from photon_ml_torch.evaluation.evaluators import EvaluatorType, auc
from photon_ml_torch.game.coordinates import ChunkedFixedEffectCoordinate
from photon_ml_torch.game.dataset import GameDataset
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.prior import GaussianPrior
from photon_ml_torch.ops.regularization import (
    RegularizationContext,
    RegularizationType,
    SweptRegularization,
)
from photon_ml_torch.optim.base import OptimizerConfig, OptimizerType
from photon_ml_torch.optim.lbfgs import lbfgs_solve
from photon_ml_torch.optim.streaming import (
    ChunkedGLMObjective,
    streaming_lbfgs_solve,
    streaming_lbfgs_solve_swept,
    streaming_tron_solve,
)
from photon_ml_torch.optim.tron import tron_solve
from photon_ml_torch.optim.variance import VarianceComputationType

from test_torch_training import (  # noqa: F401  (C1, C5)
    jax_c1,
    jax_fresh_caches,
)

CPU = "cpu"
VALUE_RTOL = 1e-5
VECTOR_RTOL = 1e-4        # × max|v|
LOSS_RTOL = 1e-3
W_ATOL = 5e-3
AUC_ATOL = 1e-3


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _sparse_problem(rng, n=2000, d=900, k=8):
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    w_true = rng.normal(0, 0.8, d) * (rng.uniform(size=d) < 0.3)
    m = np.einsum("nk,nk->n", vals, w_true[cols])
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, n).astype(np.float32)
    offsets = rng.normal(0, 0.1, n).astype(np.float32)
    indptr = np.arange(n + 1, dtype=np.int64) * k
    rows = SparseRows.from_flat(indptr, cols.reshape(-1).astype(np.int64),
                                vals.reshape(-1))
    return rows, labels, weights, offsets


def _ref_rows(rows):
    from photon_ml_tpu.data.sparse_rows import SparseRows as JRows

    return JRows.from_flat(rows.indptr, rows.cols.astype(np.int64),
                           rows.vals)


def _objective(reg=None, prior=None):
    return GLMObjective(
        loss=losses.LOGISTIC,
        reg=reg if reg is not None else RegularizationContext.l2(0.7),
        norm=NormalizationContext.identity(), prior=prior)


def _ref_objective(l2=0.7, l1=0.0):
    from photon_ml_tpu.data.normalization import NormalizationContext as JN
    from photon_ml_tpu.ops import losses as jl
    from photon_ml_tpu.ops.objective import GLMObjective as JObj
    from photon_ml_tpu.ops.regularization import RegularizationContext as JR

    return JObj(loss=jl.LOGISTIC, reg=JR(l1_weight=l1, l2_weight=l2),
                norm=JN.identity())


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def _close_vec(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=VECTOR_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("max_resident", [0, 8])
def test_chunked_matches_resident(jax_c1, rng, max_resident):
    """Every chunked surface equals the resident batch's, and the
    reference's chunked objective gives the same value and gradient."""
    from photon_ml_tpu.data.chunked_batch import (
        build_chunked_batch as jbuild,
    )
    from photon_ml_tpu.optim.streaming import ChunkedGLMObjective as JCO

    rows, labels, weights, offsets = _sparse_problem(rng)
    d = 900
    obj = _objective()
    resident = make_sparse_batch(rows, d, labels, weights=weights,
                                 offsets=offsets, device=CPU)
    cb = build_chunked_batch(rows, d, labels, weights=weights,
                             offsets=offsets, n_chunks=3, layout="ell")
    assert cb.n_chunks == 3
    cobj = ChunkedGLMObjective(obj, cb, max_resident=max_resident,
                               device=CPU)
    w = _t(rng.normal(0, 0.2, d))
    v = _t(rng.normal(0, 1, d))

    f_r, g_r = obj.value_and_gradient(w, resident)
    f_c, g_c = cobj.value_and_gradient(w)
    np.testing.assert_allclose(float(f_c), float(f_r), rtol=VALUE_RTOL)
    _close_vec(g_c, g_r)
    np.testing.assert_allclose(float(cobj.value(w)),
                               float(obj.value(w, resident)),
                               rtol=VALUE_RTOL)
    _close_vec(cobj.hessian_vector(w, v), obj.hessian_vector(w, v,
                                                             resident))
    _close_vec(cobj.hessian_diagonal(w), obj.hessian_diagonal(w, resident))
    _close_vec(cobj.predict_margins(w), obj.predict_margins(w, resident))
    _close_vec(cobj.x_dot(w), resident.x_dot(w))

    jobj = JCO(_ref_objective(), jbuild(
        _ref_rows(rows), d, labels, weights=weights, offsets=offsets,
        n_chunks=3, layout="ell"), max_resident=max_resident)
    f_j, g_j = jobj.value_and_gradient(jax_c1.numpy.asarray(w.numpy()))
    np.testing.assert_allclose(float(f_c), float(f_j), rtol=VALUE_RTOL)
    _close_vec(g_c, g_j)


def test_chunked_prior_and_reg_added_once(rng):
    """Example-independent terms (L2, the Gaussian prior) do not scale
    with the chunk count."""
    rows, labels, weights, offsets = _sparse_problem(rng)
    d = 900
    prior = GaussianPrior.from_model(_t(rng.normal(0, 0.3, d)),
                                     torch.ones(d), 2.0)
    obj = _objective(prior=prior)
    resident = make_sparse_batch(rows, d, labels, weights=weights,
                                 offsets=offsets, device=CPU)
    for n_chunks in (2, 5):
        cobj = ChunkedGLMObjective(
            obj, build_chunked_batch(rows, d, labels, weights=weights,
                                     offsets=offsets, n_chunks=n_chunks),
            device=CPU)
        w = _t(rng.normal(0, 0.2, d))
        f_r, g_r = obj.value_and_gradient(w, resident)
        f_c, g_c = cobj.value_and_gradient(w)
        np.testing.assert_allclose(float(f_c), float(f_r), rtol=VALUE_RTOL)
        _close_vec(g_c, g_r)


@pytest.mark.parametrize("l1", [None, 0.05])
def test_streaming_lbfgs_matches_resident(jax_c1, rng, l1):
    """Streaming L-BFGS (OWL-QN with L1) ends at the resident solver's
    loss and at the reference's streaming solver's."""
    from photon_ml_tpu.data.chunked_batch import (
        build_chunked_batch as jbuild,
    )
    from photon_ml_tpu.optim.base import OptimizerConfig as JCfg
    from photon_ml_tpu.optim.streaming import (
        ChunkedGLMObjective as JCO,
        streaming_lbfgs_solve as jsolve,
    )

    jnp = jax_c1.numpy
    reg = (RegularizationContext.l2(0.5) if l1 is None
           else RegularizationContext.elastic_net(0.5, 0.3))
    rows, labels, weights, offsets = _sparse_problem(rng)
    d = 900
    obj = _objective(reg)
    resident = make_sparse_batch(rows, d, labels, weights=weights,
                                 offsets=offsets, device=CPU)
    cb = build_chunked_batch(rows, d, labels, weights=weights,
                             offsets=offsets, n_chunks=4)
    cobj = ChunkedGLMObjective(obj, cb, max_resident=4, device=CPU)
    cfg = OptimizerConfig(max_iters=80, tolerance=1e-5)
    w0 = torch.zeros(d)
    l1_vec = None if l1 is None else torch.full((d,), reg.l1_weight)

    res_r = lbfgs_solve(lambda w: obj.value_and_gradient(w, resident), w0,
                        cfg, l1_weight=l1_vec)
    res_s = streaming_lbfgs_solve(cobj.value_and_gradient, w0, cfg,
                                  l1_weight=l1_vec, value_fn=cobj.value)
    np.testing.assert_allclose(float(res_s.value), float(res_r.value),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res_s.w.numpy(), res_r.w.numpy(), rtol=0,
                               atol=2 * W_ATOL if l1 else W_ATOL)

    jobj = JCO(_ref_objective(l2=reg.l2_weight, l1=reg.l1_weight), jbuild(
        _ref_rows(rows), d, labels, weights=weights, offsets=offsets,
        n_chunks=4, layout="ell"), max_resident=4)
    res_j = jsolve(jobj.value_and_gradient, jnp.zeros(d, jnp.float32),
                   JCfg(max_iters=80, tolerance=1e-5),
                   l1_weight=(None if l1 is None
                              else jnp.asarray(l1_vec.numpy())),
                   value_fn=jobj.value)
    np.testing.assert_allclose(float(res_s.value), float(res_j.value),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res_s.w.numpy(), np.asarray(res_j.w),
                               rtol=0, atol=2 * W_ATOL if l1 else W_ATOL)
    if l1 is not None:
        # OWL-QN gives sparsity, and the zero sets agree in size.
        zeros_s = int((res_s.w == 0).sum())
        zeros_j = int(np.sum(np.asarray(res_j.w) == 0.0))
        assert zeros_s > 20
        assert abs(zeros_s - zeros_j) <= max(10, zeros_j // 5)


def test_streaming_swept_matches_reference(jax_c1, rng):
    """Streaming λ-lane L-BFGS: each lane ends at the reference's
    streaming swept solve and at a single-λ streaming solve."""
    from photon_ml_tpu.data.chunked_batch import (
        build_chunked_batch as jbuild,
    )
    from photon_ml_tpu.ops.regularization import (
        SweptRegularization as JSwept,
    )
    from photon_ml_tpu.optim.base import OptimizerConfig as JCfg
    from photon_ml_tpu.optim.streaming import (
        ChunkedGLMObjective as JCO,
        streaming_lbfgs_solve_swept as jswept,
    )

    jnp = jax_c1.numpy
    rows, labels, weights, offsets = _sparse_problem(rng, n=1200, d=300)
    d = 300
    lams = [3.0, 0.7, 0.05]
    obj = _objective(RegularizationContext.l2(lams[0]))
    cb = build_chunked_batch(rows, d, labels, weights=weights,
                             offsets=offsets, n_chunks=3)
    cobj = ChunkedGLMObjective(obj, cb, max_resident=0, device=CPU)
    reg = SweptRegularization.from_grid(RegularizationType.L2, lams)
    cfg = OptimizerConfig(max_iters=60, tolerance=1e-6)
    res = streaming_lbfgs_solve_swept(
        lambda W: cobj.value_and_gradient_swept(W, reg),
        lambda W: cobj.value_swept(W, reg), torch.zeros(3, d), cfg)

    jobj = JCO(_ref_objective(l2=lams[0]), jbuild(
        _ref_rows(rows), d, labels, weights=weights, offsets=offsets,
        n_chunks=3, layout="ell"), max_resident=0)
    jreg = JSwept.from_grid("L2", lams)
    jres = jswept(lambda W: jobj.value_and_gradient_swept(W, jreg),
                  lambda W: jobj.value_swept(W, jreg),
                  jnp.zeros((3, d), jnp.float32),
                  JCfg(max_iters=60, tolerance=1e-6))
    np.testing.assert_allclose(res.value.numpy(), np.asarray(jres.value),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(jres.w), rtol=0,
                               atol=W_ATOL)
    for j, lam in enumerate(lams):
        single = streaming_lbfgs_solve(
            ChunkedGLMObjective(_objective(RegularizationContext.l2(lam)),
                                cb, device=CPU).value_and_gradient,
            torch.zeros(d), cfg)
        np.testing.assert_allclose(float(res.value[j]),
                                   float(single.value), rtol=LOSS_RTOL)


@pytest.mark.parametrize("precond", [True, False])
def test_streaming_tron_matches_resident(jax_c1, rng, precond):
    """Streaming TRON (chunked Hessian-vector passes in Steihaug CG)
    ends at the resident TRON's solution and at the reference's
    streaming TRON's."""
    from photon_ml_tpu.data.chunked_batch import (
        build_chunked_batch as jbuild,
    )
    from photon_ml_tpu.optim.base import OptimizerConfig as JCfg
    from photon_ml_tpu.optim.streaming import (
        ChunkedGLMObjective as JCO,
        streaming_tron_solve as jtron,
    )

    jnp = jax_c1.numpy
    rows, labels, weights, offsets = _sparse_problem(rng)
    d = 900
    obj = _objective()
    resident = make_sparse_batch(rows, d, labels, weights=weights,
                                 offsets=offsets, device=CPU)
    cb = build_chunked_batch(rows, d, labels, weights=weights,
                             offsets=offsets, n_chunks=4)
    cobj = ChunkedGLMObjective(obj, cb, max_resident=4, device=CPU)
    cfg = OptimizerConfig(max_iters=60, tolerance=1e-7)
    res_r = tron_solve(lambda w: obj.value_and_gradient(w, resident),
                       lambda w, v: obj.hessian_vector(w, v, resident),
                       torch.zeros(d), cfg)
    res_s = streaming_tron_solve(
        cobj.value_and_gradient, cobj.hvp_pass, torch.zeros(d), cfg,
        hessian_diag=cobj.hessian_diagonal if precond else None)
    assert res_r.converged and res_s.converged
    np.testing.assert_allclose(float(res_s.value), float(res_r.value),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res_s.w.numpy(), res_r.w.numpy(), rtol=0,
                               atol=W_ATOL)
    # Slot 0 (the start) and one an outer iteration, each with its CG
    # passes.
    kt = int(res_s.tracker.count)
    assert kt == res_s.iterations + 1
    assert np.all(res_s.tracker.ls_trials[1:kt].numpy() >= 1)

    jobj = JCO(_ref_objective(), jbuild(
        _ref_rows(rows), d, labels, weights=weights, offsets=offsets,
        n_chunks=4, layout="ell"), max_resident=4)
    res_j = jtron(jobj.value_and_gradient, jobj.hvp_pass,
                  jnp.zeros(d, jnp.float32),
                  JCfg(max_iters=60, tolerance=1e-7),
                  hessian_diag=jobj.hessian_diagonal if precond else None)
    np.testing.assert_allclose(float(res_s.value), float(res_j.value),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res_s.w.numpy(), np.asarray(res_j.w),
                               rtol=0, atol=W_ATOL)


def _game_dataset(rng, n=900, d=120, k=5):
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    ids = rng.integers(0, 12, n)
    m = (np.einsum("nk,nk->n", vals, rng.normal(0, 1, d)[cols])
         + rng.normal(0, 1.0, 12)[ids])
    y = (m + rng.normal(0, 0.3, n) > 0).astype(np.float32)
    return cols, vals, ids, y, d


def _datasets(cols, vals, ids, y, d, pkg):
    if pkg == "torch":
        Dataset = GameDataset
    else:
        from photon_ml_tpu.game.dataset import GameDataset as Dataset
    n = len(y)
    rows = [(cols[i], vals[i]) for i in range(n)]
    return Dataset(labels=y, features={"f": rows,
                                       "per_user": np.ones((n, 1),
                                                           np.float32)},
                   entity_ids={"user": ids}, feature_dims={"f": d})


def _game_config(pkg, **kw):
    if pkg == "torch":
        Cfg, CC, Kind, Opt = (TrainingConfig, CoordinateConfig,
                              CoordinateKind, OptimizerSettings)
        task, ev = TaskType.LOGISTIC_REGRESSION, EvaluatorType.AUC
        kw.setdefault("device", CPU)
    else:
        from photon_ml_tpu.config import (
            CoordinateConfig as CC,
            CoordinateKind as Kind,
            OptimizerSettings as Opt,
            TrainingConfig as Cfg,
        )
        from photon_ml_tpu.evaluation.evaluators import EvaluatorType as E
        from photon_ml_tpu.models.glm import TaskType as T

        task, ev = T.LOGISTIC_REGRESSION, E.AUC
    return Cfg(
        task_type=task,
        coordinates=[
            CC(name="global", kind=Kind.FIXED_EFFECT, feature_shard="f",
               optimizer=Opt(max_iters=60, reg_weight=1.0)),
            CC(name="user", kind=Kind.RANDOM_EFFECT,
               feature_shard="per_user", entity_key="user",
               optimizer=Opt(max_iters=40, reg_weight=2.0))],
        update_sequence=["global", "user"], n_iterations=2,
        evaluators=[ev], validation_fraction=0.0,
        validate_per_iteration=False, intercept=False, **kw)


def _fe_auc(model, ds) -> float:
    from photon_ml_torch.estimators.game_transformer import GameTransformer

    scores = GameTransformer(model=model, task=TaskType.LOGISTIC_REGRESSION,
                             device=CPU).transform(ds)
    return float(auc(torch.from_numpy(np.asarray(scores)),
                     torch.from_numpy(ds.labels.astype(np.float32))))


def test_estimator_chunked_fit_matches_resident(jax_c1, rng, tmp_path):
    """``GameEstimator`` with ``chunk_rows`` (spilled) ≡ the resident
    estimator (fixed effect + random effect CD), and ≡ the reference's
    chunked fit: coefficients 5e-3, AUC 1e-3."""
    from photon_ml_tpu.estimators.game_estimator import (
        GameEstimator as JEst,
    )

    cols, vals, ids, y, d = _game_dataset(rng)
    ds = _datasets(cols, vals, ids, y, d, "torch")
    fit_r = GameEstimator(_game_config("torch")).fit(ds)[0]
    fit_c = GameEstimator(_game_config(
        "torch", chunk_rows=256, chunk_layout="ELL", chunk_max_resident=8,
        spill_dir=str(tmp_path / "spill"))).fit(ds)[0]
    w_r = fit_r.model.models["global"].coefficients.means.numpy()
    w_c = fit_c.model.models["global"].coefficients.means.numpy()
    np.testing.assert_allclose(w_c, w_r, rtol=0, atol=W_ATOL)
    assert abs(_fe_auc(fit_c.model, ds) - _fe_auc(fit_r.model, ds)) \
        <= AUC_ATOL

    fit_j = JEst(_game_config("jax", chunk_rows=256, chunk_layout="ELL",
                              chunk_max_resident=8)).fit(
        _datasets(cols, vals, ids, y, d, "jax"))[0]
    w_j = np.asarray(fit_j.model.models["global"].coefficients.means)
    np.testing.assert_allclose(w_c, w_j, rtol=0, atol=W_ATOL)


def test_chunked_config_validation(jax_c1):
    """The reference's rules for the chunked tier hold in both packages;
    GRR chunks and a mesh name ROADMAP A7, the streamed scoring knobs
    A5b (the streamed random effects and the fused cycle now validate)."""
    from photon_ml_tpu.config import (
        CoordinateConfig as JCC,
        CoordinateKind as JKind,
        NormalizationType as JNorm,
        OptimizerSettings as JOpt,
        TrainingConfig as JCfg,
    )
    from photon_ml_tpu.models.glm import TaskType as JTask

    def base(pkg):
        if pkg == "torch":
            return dict(task_type=TaskType.LOGISTIC_REGRESSION,
                        coordinates=[CoordinateConfig(
                            name="g", kind=CoordinateKind.FIXED_EFFECT,
                            feature_shard="f",
                            optimizer=OptimizerSettings())],
                        update_sequence=["g"], device=CPU), (
                TrainingConfig, NormalizationType)
        return dict(task_type=JTask.LOGISTIC_REGRESSION,
                    coordinates=[JCC(name="g", kind=JKind.FIXED_EFFECT,
                                     feature_shard="f",
                                     optimizer=JOpt())],
                    update_sequence=["g"]), (JCfg, JNorm)

    for pkg in ("torch", "jax"):
        kw, (Cfg, Norm) = base(pkg)
        with pytest.raises(ValueError, match="chunk_rows"):
            Cfg(chunk_rows=0, **kw).validate()
        with pytest.raises(ValueError, match="normalization"):
            Cfg(chunk_rows=100, normalization=Norm.STANDARDIZATION,
                **kw).validate()
        with pytest.raises(ValueError, match="spill_dir requires"):
            Cfg(spill_dir="/tmp/s", **kw).validate()
        with pytest.raises(ValueError, match="resume requires"):
            Cfg(resume=True, **kw).validate()
        with pytest.raises(ValueError, match="prefetch_depth"):
            Cfg(chunk_rows=100, prefetch_depth=-1, **kw).validate()
        Cfg(chunk_rows=100, spill_dir="/tmp/s", checkpoint_dir="/tmp/c",
            resume=True, **kw).validate()
    kw, _ = base("torch")
    TrainingConfig(chunk_rows=100, re_chunk_entities=8, spill_dir="/tmp/s",
                   **kw).validate()
    TrainingConfig(chunk_rows=100, cd_fused=True, **kw).validate()
    from photon_ml_torch.config import ScoringConfig

    ScoringConfig(input_path="x", model_dir="m", score_chunk_rows=4096,
                  spill_dir="/tmp/s", prefetch_depth=0).validate()
    # The live monitor is ported: its knobs validate as the reference's.
    for knob, value in (("monitor", "on"), ("status_port", 0)):
        ScoringConfig(input_path="x", model_dir="m",
                      **{knob: value}).validate()
    for knob, value in (("monitor", "maybe"), ("status_port", 70000),
                        ("monitor_every_s", 0.0)):
        with pytest.raises(ValueError, match=knob):
            ScoringConfig(input_path="x", model_dir="m",
                          **{knob: value}).validate()
    rows = SparseRows.from_rows([(np.array([0, 2], np.int32),
                                  np.ones(2, np.float32))] * 4)
    # GRR chunks and chunks × mesh shards are ported now (A7b, they
    # raised before): they build, and an unknown layout still raises.
    from photon_ml_torch.parallel.mesh import data_parallel_mesh

    grr = build_chunked_batch(rows, 3, np.zeros(4), n_chunks=2,
                              layout="grr")
    assert grr.chunk(0).grr is not None and grr.chunk(0).values.shape == \
        (2, 0)
    meshed = build_chunked_batch(rows, 3, np.zeros(4), n_chunks=2,
                                 mesh=data_parallel_mesh(2, device=CPU))
    assert [len(meshed.chunk(i)) for i in range(2)] == [2, 2]
    with pytest.raises(ValueError, match="unknown chunk layout"):
        build_chunked_batch(rows, 3, np.zeros(4), n_chunks=2, layout="csr")


def test_estimator_chunked_warm_start_prior(rng, tmp_path):
    """Warm start with the Gaussian prior composes with the chunked path
    (the prior added once), and SIMPLE variances come from the chunked
    Hessian diagonal."""
    from photon_ml_torch.io.model_io import save_game_model

    n, d, k = 600, 80, 5
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    m = np.einsum("nk,nk->n", vals, rng.normal(0, 1, d)[cols])
    y = (m + rng.normal(0, 0.3, n) > 0).astype(np.float32)
    ds = GameDataset(labels=y, features={"f": [(cols[i], vals[i])
                                               for i in range(n)]},
                     entity_ids={}, feature_dims={"f": d})

    def cfg(**kw):
        return TrainingConfig(
            task_type=TaskType.LOGISTIC_REGRESSION,
            coordinates=[CoordinateConfig(
                name="global", kind=CoordinateKind.FIXED_EFFECT,
                feature_shard="f", optimizer=OptimizerSettings(
                    max_iters=50, reg_weight=1.0, variance_type="SIMPLE"))],
            update_sequence=["global"], n_iterations=1,
            validation_fraction=0.0, validate_per_iteration=False,
            intercept=False, device=CPU, **kw)

    fit1 = GameEstimator(cfg()).fit(ds)[0]
    mdir = str(tmp_path / "m")
    save_game_model(fit1.model, TaskType.LOGISTIC_REGRESSION, mdir)
    kw2 = dict(warm_start_model_dir=mdir, use_warm_start_as_prior=True,
               prior_weight=1.0)
    fit_r = GameEstimator(cfg(**kw2)).fit(ds)[0]
    fit_c = GameEstimator(cfg(chunk_rows=200, chunk_layout="ELL",
                              chunk_max_resident=4, **kw2)).fit(ds)[0]
    w_r = fit_r.model.models["global"].coefficients.means.numpy()
    w_c = fit_c.model.models["global"].coefficients.means.numpy()
    np.testing.assert_allclose(w_c, w_r, rtol=0, atol=W_ATOL)
    v_c = fit_c.model.models["global"].coefficients.variances
    assert v_c is not None and bool((v_c > 0).all())


def test_chunked_offsets_padding_grid_rule(rng):
    """A longer offsets array is accepted only at the chunk padding
    grid's length, in train and in compute_variances alike."""
    rows, labels, weights, _ = _sparse_problem(rng, n=610, d=80, k=4)
    cb = build_chunked_batch(rows, 80, labels, weights=weights, n_chunks=4)
    coord = ChunkedFixedEffectCoordinate(
        name="f", chunked=cb, objective=_objective(),
        optimizer=OptimizerType.LBFGS, config=OptimizerConfig(max_iters=2),
        device=CPU)
    grid = cb.n_chunks * cb.chunk_rows
    assert grid > cb.n
    np.testing.assert_array_equal(
        coord._coerce_offsets(np.zeros(cb.n, np.float32)),
        np.zeros(cb.n, np.float32))
    padded = np.arange(grid, dtype=np.float32)
    np.testing.assert_array_equal(coord._coerce_offsets(padded),
                                  padded[: cb.n])
    bad = np.zeros(cb.n + 7, np.float32)
    with pytest.raises(ValueError, match="padding grid"):
        coord.train(bad)
    with pytest.raises(ValueError, match="padding grid"):
        coord.compute_variances(torch.zeros(cb.dim), bad,
                                VarianceComputationType.SIMPLE)
    with pytest.raises(ValueError):
        coord.train(np.zeros(cb.n - 3, np.float32))


def test_chunked_coordinate_tron_routes_and_swept_rejects(rng):
    """TRON routes to the streaming TRON and matches the resident
    solve; ``train_swept`` keeps the L-BFGS-lanes-only contract."""
    rows, labels, weights, _ = _sparse_problem(rng, n=610, d=80, k=4)
    d = 80
    obj = _objective()
    cb = build_chunked_batch(rows, d, labels, weights=weights, n_chunks=4)
    cfg = OptimizerConfig(max_iters=60, tolerance=1e-7)
    coord = ChunkedFixedEffectCoordinate(
        name="f", chunked=cb, objective=obj, optimizer=OptimizerType.TRON,
        config=cfg, device=CPU)
    w, res = coord.train(torch.zeros(cb.n))
    assert res.converged
    resident = make_sparse_batch(rows, d, labels, weights=weights,
                                 device=CPU)
    ref = tron_solve(lambda v: obj.value_and_gradient(v, resident),
                     lambda v, u: obj.hessian_vector(v, u, resident),
                     torch.zeros(d), cfg)
    np.testing.assert_allclose(w.numpy(), ref.w.numpy(), rtol=0,
                               atol=W_ATOL)
    with pytest.raises(ValueError, match="LBFGS"):
        coord.train_swept(torch.zeros(cb.n), SweptRegularization.from_grid(
            RegularizationType.L2, [0.1, 1.0]))
    # The L-BFGS coordinate's swept lanes equal its single solves.
    lbfgs = dataclasses.replace(coord, optimizer=OptimizerType.LBFGS)
    W, sres = lbfgs.train_swept(torch.zeros(cb.n),
                                SweptRegularization.from_grid(
                                    RegularizationType.L2, [0.7, 0.1]))
    w1, r1 = lbfgs.train(torch.zeros(cb.n))
    np.testing.assert_allclose(float(sres.value[0]), float(r1.value),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(lbfgs.score(w1).numpy(),
                               resident.x_dot(w1).numpy(), rtol=0,
                               atol=1e-5)


# -- GRR chunks and chunks × mesh shards -------------------------------------


MESH_CASES = [("grr", None), ("ell", 2), ("grr", 4)]


def _mesh(n):
    from photon_ml_torch.parallel.mesh import data_parallel_mesh

    return None if n is None else data_parallel_mesh(n, device=CPU)


def _ref_mesh(n):
    from photon_ml_tpu.parallel.mesh import data_parallel_mesh

    return None if n is None else data_parallel_mesh(n)


@pytest.mark.parametrize("layout,n_dev", MESH_CASES)
def test_chunked_grr_and_mesh_match_resident(jax_c1, rng, layout, n_dev):
    """GRR chunks (B2/B3 on every chunk's congruent plans) and chunks ×
    shards (pieces summed in shard order) give the resident surfaces,
    and the reference's chunked objective on the same layout and mesh
    gives the same value and gradient; swept lanes ride through."""
    from photon_ml_tpu.data.chunked_batch import (
        build_chunked_batch as jbuild,
    )
    from photon_ml_tpu.optim.streaming import ChunkedGLMObjective as JCO

    rows, labels, weights, offsets = _sparse_problem(rng, n=1200)
    d = 900
    obj = _objective()
    resident = make_sparse_batch(rows, d, labels, weights=weights,
                                 offsets=offsets, device=CPU)
    cb = build_chunked_batch(rows, d, labels, weights=weights,
                             offsets=offsets, n_chunks=3, layout=layout,
                             mesh=_mesh(n_dev))
    cobj = ChunkedGLMObjective(obj, cb, max_resident=2, device=CPU)
    w = _t(rng.normal(0, 0.2, d))
    v = _t(rng.normal(0, 1, d))
    f_r, g_r = obj.value_and_gradient(w, resident)
    f_c, g_c = cobj.value_and_gradient(w)
    np.testing.assert_allclose(float(f_c), float(f_r), rtol=VALUE_RTOL)
    _close_vec(g_c, g_r)
    _close_vec(cobj.hessian_vector(w, v),
               obj.hessian_vector(w, v, resident))
    _close_vec(cobj.hessian_diagonal(w), obj.hessian_diagonal(w, resident))
    _close_vec(cobj.x_dot(w), resident.x_dot(w))
    _close_vec(cobj.predict_margins(w), obj.predict_margins(w, resident))
    W = torch.stack([w, 0.5 * w])
    reg = SweptRegularization.from_grid(RegularizationType.L2, [0.7, 0.7])
    fs, gs = cobj.value_and_gradient_swept(W, reg)
    np.testing.assert_allclose(float(fs[1]),
                               float(cobj.value_and_gradient(W[1])[0]),
                               rtol=VALUE_RTOL)
    _close_vec(gs[0], g_c)

    jobj = JCO(_ref_objective(), jbuild(
        _ref_rows(rows), d, labels, weights=weights, offsets=offsets,
        n_chunks=3, layout=layout, mesh=_ref_mesh(n_dev)), max_resident=2)
    f_j, g_j = jobj.value_and_gradient(jax_c1.numpy.asarray(w.numpy()))
    np.testing.assert_allclose(float(f_c), float(f_j), rtol=VALUE_RTOL)
    _close_vec(g_c, g_j)


@pytest.mark.parametrize("first", ["jax", "torch"])
@pytest.mark.parametrize("layout,n_dev", [("grr", 2), ("ell", 4)])
def test_spilled_grr_and_mesh_chunks_shared_between_packages(
        jax_c1, rng, tmp_path, first, layout, n_dev):
    """A spill dir of GRR or mesh chunks written by one package loads
    warm in the other: the same key and file names, nothing built or
    rebuilt on the second side, the pieces and plans equal leaf for
    leaf (the ``"mesh"`` meta both ways)."""
    from photon_ml_tpu.data.chunked_batch import (
        build_chunked_batch as jbuild,
    )
    from test_torch_grr import assert_same_plan

    rows, labels, weights, _ = _sparse_problem(rng, n=800)
    d, spill = 900, str(tmp_path / "spill")
    kw = dict(n_chunks=2, layout=layout, spill_dir=spill,
              host_max_resident=2)

    def port():
        return build_chunked_batch(rows, d, labels, weights=weights,
                                   mesh=_mesh(n_dev), **kw)

    def ref():
        return jbuild(_ref_rows(rows), d, labels, weights=weights,
                      mesh=_ref_mesh(n_dev), **kw)

    writer, reader = (ref(), port()) if first == "jax" else (port(), ref())
    assert writer.store.key == reader.store.key
    assert writer.store.spills == writer.n_chunks
    assert reader.store.spills == 0
    for i in range(reader.n_chunks):
        assert reader.store.path(i) == writer.store.path(i)
        got, want = reader.chunk(i), writer.chunk(i)
        assert isinstance(got, list) and len(got) == len(want) == n_dev
        for g, w_ in zip(got, want):
            for leaf in ("values", "col_ids", "labels", "weights",
                         "offsets", "mask"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(g, leaf)),
                    np.asarray(getattr(w_, leaf)))
            jp, tp = (w_.grr, g.grr) if first == "jax" else (g.grr, w_.grr)
            assert_same_plan(jp, tp)
    assert reader.store.rebuilds == 0

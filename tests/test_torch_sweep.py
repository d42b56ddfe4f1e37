"""The swept λ path of ``photon_ml_torch`` against the JAX package's.

The same numpy inputs go through the reference's swept surfaces
(``ops.objective.sweep_value_and_gradient`` / ``sweep_value``: its
objective under ``jax.vmap``, or ``lax.map`` on a GRR plan), its swept
solvers (``lbfgs_solve_swept``) and its ``GameEstimator`` grid and tuned
fits, and through the port's counterparts on CPU tensors, where the
lane products run the plain versions of the kernels.  The reference's
L2 paths need the ``jax_c1`` fixture (ROADMAP C1).  Tolerances, stated
at each test: surfaces 1e-5 relative (values) and 1e-4·max (gradients),
float32 sums in another order; solves 5e-3 on W (the reference's own
swept-vs-sequential tolerance) and 1e-5 on values; estimator fits 2e-3
on coefficients and 1e-3 on AUC.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_ml_torch.config import (
    CoordinateConfig,
    CoordinateKind,
    OptimizerSettings,
    TrainingConfig,
    TuningConfig,
)
from photon_ml_torch.data.batch import make_sparse_batch
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.estimators.game_estimator import GameEstimator
from photon_ml_torch.evaluation.evaluators import EvaluatorType
from photon_ml_torch.game.dataset import GameDataset
from photon_ml_torch.models.glm import TaskType
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import (
    GLMObjective,
    sweep_value,
    sweep_value_and_gradient,
)
from photon_ml_torch.ops.regularization import (
    RegularizationContext,
    RegularizationType,
    SweptRegularization,
    exclude_intercept_mask,
)
from photon_ml_torch.optim.base import OptimizerConfig
from photon_ml_torch.optim.lbfgs import (
    lbfgs_solve,
    lbfgs_solve_swept,
    owlqn_solve_swept,
)
from test_torch_training import (  # noqa: F401  (C1, C5)
    jax_c1,
    jax_fresh_caches,
)

CPU = "cpu"
LAMS = [10.0, 1.0, 0.1]


def _sparse_problem(seed=7, n=1500, d=300, k=6):
    """``tests/test_sweep.py``'s problem: k distinct columns a row, N(0,
    1) values, labels from a sparse planted model."""
    rng = np.random.default_rng(seed)
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    w_true = rng.normal(0, 0.8, d) * (rng.uniform(size=d) < 0.3)
    m = np.einsum("nk,nk->n", vals, w_true[cols])
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    return cols, vals, labels


def _rows(cols, vals):
    n, k = cols.shape
    return SparseRows.from_flat(np.arange(n + 1, dtype=np.int64) * k,
                                cols.reshape(-1).astype(np.int64),
                                vals.reshape(-1))


def _ref_rows(cols, vals):
    from photon_ml_tpu.data.sparse_rows import SparseRows as JRows

    n, k = cols.shape
    return JRows.from_flat(np.arange(n + 1, dtype=np.int64) * k,
                           cols.reshape(-1).astype(np.int64),
                           vals.reshape(-1))


# -- SweptRegularization --------------------------------------------------------


@pytest.mark.parametrize("reg", ["L2", "L1", "ELASTIC_NET", "NONE"])
def test_swept_regularization_matches_reference(reg):
    from photon_ml_tpu.ops.regularization import SweptRegularization as JS

    want = JS.from_grid(reg, LAMS, elastic_net_alpha=0.3)
    got = SweptRegularization.from_grid(reg, LAMS, elastic_net_alpha=0.3)
    assert got.n_lanes == want.n_lanes == 3
    assert got.has_l1() == want.has_l1()
    np.testing.assert_array_equal(got.l1_weights.numpy(),
                                  np.asarray(want.l1_weights))
    np.testing.assert_array_equal(got.l2_weights.numpy(),
                                  np.asarray(want.l2_weights))
    mask = exclude_intercept_mask(5, 4, device=CPU)
    np.testing.assert_array_equal(
        got.l1_vectors(5, mask).numpy(),
        np.asarray(want.l1_vectors(5, np.asarray(mask.numpy()))))


# -- the sweep surfaces ---------------------------------------------------------


@pytest.mark.parametrize("layout", ["ell", "colmajor", "grr"])
def test_sweep_surfaces_match_reference(jax_c1, layout):
    """values 1e-5 relative, gradients 1e-4·max, lane by lane, with a
    per-lane L2 weight and the intercept exempt."""
    import jax.numpy as jnp

    from photon_ml_tpu.data.batch import make_sparse_batch as jmake
    from photon_ml_tpu.data.normalization import (
        NormalizationContext as JNorm,
    )
    from photon_ml_tpu.ops import losses as jlosses
    from photon_ml_tpu.ops import objective as jobj
    from photon_ml_tpu.ops.regularization import (
        RegularizationContext as JReg,
        exclude_intercept_mask as jmask,
    )

    cols, vals, labels = _sparse_problem(seed=3, n=600, d=200)
    d = 200
    kw = {"col_major": layout == "colmajor", "grr": layout == "grr"}
    jb = jmake(_ref_rows(cols, vals), d, labels, **kw)
    tb = make_sparse_batch(_rows(cols, vals), d, labels, device=CPU, **kw)
    W = np.random.default_rng(4).normal(0, 0.3, (4, d)).astype(np.float32)
    l2s = np.asarray([3.0, 1.0, 0.3, 0.0], np.float32)
    jo = jobj.GLMObjective(jlosses.LOGISTIC, JReg.l2(1.0, jmask(d, d - 1)),
                           JNorm.identity())
    to = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(
        1.0, exclude_intercept_mask(d, d - 1, device=CPU)),
        NormalizationContext.identity())
    use_map = layout == "grr"
    jv, jg = jobj.sweep_value_and_gradient(
        jo, jnp.asarray(W), jb, jnp.asarray(l2s), use_map=use_map)
    jv_only = jobj.sweep_value(jo, jnp.asarray(W), jb, jnp.asarray(l2s),
                               use_map=use_map)
    tv, tg = sweep_value_and_gradient(to, torch.from_numpy(W), tb,
                                      torch.from_numpy(l2s))
    tv_only = sweep_value(to, torch.from_numpy(W), tb, torch.from_numpy(l2s))
    assert tv.shape == (4,) and tg.shape == (4, d)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)
    np.testing.assert_allclose(tv_only.numpy(), np.asarray(jv_only),
                               rtol=1e-5)
    jg = np.asarray(jg)
    for lane in range(4):
        np.testing.assert_allclose(
            tg[lane].numpy(), jg[lane], rtol=0,
            atol=1e-4 * float(np.abs(jg[lane]).max()))


def test_sweep_surface_lanes_equal_single_lambda_objectives():
    """Each lane of the port's swept surface is the single-λ objective
    at that λ (normalization with shifts included): 1e-5 relative."""
    from photon_ml_torch.data.normalization import (
        NormalizationType,
        compute_normalization,
    )
    from photon_ml_torch.data.statistics import compute_statistics

    cols, vals, labels = _sparse_problem(seed=5, n=400, d=80)
    d = 80
    batch = make_sparse_batch(_rows(cols, vals), d, labels, device=CPU)
    st = compute_statistics(batch)
    norm = compute_normalization(st.mean, st.std, st.max_abs,
                                 NormalizationType.STANDARDIZATION,
                                 intercept_index=d - 1)
    mask = exclude_intercept_mask(d, d - 1, device=CPU)
    obj = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(1.0, mask),
                       norm)
    W = torch.from_numpy(np.random.default_rng(2).normal(
        0, 0.2, (3, d)).astype(np.float32))
    l2s = torch.tensor(LAMS)
    vals_s, grads_s = sweep_value_and_gradient(obj, W, batch, l2s)
    for lane, lam in enumerate(LAMS):
        one = GLMObjective(losses.LOGISTIC,
                           RegularizationContext.l2(lam, mask), norm)
        v, g = one.value_and_gradient(W[lane], batch)
        np.testing.assert_allclose(float(vals_s[lane]), float(v), rtol=1e-5)
        np.testing.assert_allclose(grads_s[lane].numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * float(g.abs().max()))


# -- the swept solvers ----------------------------------------------------------


def _solver_problem(jax):
    import jax.numpy as jnp

    from photon_ml_tpu.data.batch import make_sparse_batch as jmake
    from photon_ml_tpu.data.normalization import (
        NormalizationContext as JNorm,
    )
    from photon_ml_tpu.ops import losses as jlosses
    from photon_ml_tpu.ops.objective import GLMObjective as JObj
    from photon_ml_tpu.ops.regularization import RegularizationContext as JReg

    cols, vals, labels = _sparse_problem()
    d = 300
    jb = jmake(_ref_rows(cols, vals), d, labels)
    jo = JObj(jlosses.LOGISTIC, JReg.l2(1.0), JNorm.identity())

    def jvg(w, l2):
        o = jo.replace(reg=jo.reg.replace(l2_weight=l2))
        return o.value_and_gradient(w, jb)

    tb = make_sparse_batch(_rows(cols, vals), d, labels, device=CPU)
    to = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(1.0),
                      NormalizationContext.identity())
    return d, jnp, jvg, tb, to


def test_lbfgs_solve_swept_matches_reference(jax_c1):
    """``tests/test_sweep.py``'s problem, L2 lanes 10, 1, 0.1: W within
    5e-3, values within 1e-5 relative, converged flags equal; and each
    lane is the port's own single-λ solve."""
    from photon_ml_tpu.optim import OptimizerConfig as JCfg
    from photon_ml_tpu.optim import lbfgs_solve_swept as jswept

    d, jnp, jvg, tb, to = _solver_problem(jax_c1)
    ref = jswept(jvg, jnp.zeros((3, d), jnp.float32),
                 jnp.asarray(LAMS, jnp.float32),
                 JCfg(max_iters=200, tolerance=1e-7))
    l2s = torch.tensor(LAMS)
    cfg = OptimizerConfig(max_iters=200, tolerance=1e-7)
    res = lbfgs_solve_swept(
        lambda W: sweep_value_and_gradient(to, W, tb, l2s),
        torch.zeros(3, d), cfg,
        value=lambda W: sweep_value(to, W, tb, l2s))
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(res.value.numpy(), np.asarray(ref.value),
                               rtol=1e-5)
    assert res.converged.tolist() == np.asarray(ref.converged).tolist()
    for lane, lam in enumerate(LAMS):
        one = GLMObjective(losses.LOGISTIC, RegularizationContext.l2(lam),
                           NormalizationContext.identity())
        r = lbfgs_solve(lambda w: one.value_and_gradient(w, tb),
                        torch.zeros(d), cfg,
                        value=lambda w: one.value(w, tb))
        np.testing.assert_allclose(res.w[lane].numpy(), r.w.numpy(),
                                   rtol=5e-3, atol=5e-3)


def test_owlqn_solve_swept_matches_reference(jax_c1):
    """Elastic-net lanes (α 0.5): W within 5e-3, values within 1e-5
    relative, converged flags equal; the strong lane sparsifies most."""
    from photon_ml_tpu.ops.regularization import SweptRegularization as JS
    from photon_ml_tpu.optim import OptimizerConfig as JCfg
    from photon_ml_tpu.optim import lbfgs_solve_swept as jswept

    d, jnp, jvg, tb, to = _solver_problem(jax_c1)
    lams = [1.0, 0.3, 0.03]
    jreg = JS.from_grid(RegularizationType.ELASTIC_NET, lams, 0.5)
    ref = jswept(jvg, jnp.zeros((3, d), jnp.float32), jreg.l2_weights,
                 JCfg(max_iters=80, tolerance=1e-7),
                 l1_weights=jreg.l1_vectors(d, None))
    reg = SweptRegularization.from_grid(RegularizationType.ELASTIC_NET,
                                        lams, 0.5)
    res = owlqn_solve_swept(
        lambda W: sweep_value_and_gradient(to, W, tb, reg.l2_weights),
        torch.zeros(3, d), reg.l1_weights,       # [L] scalars broadcast
        OptimizerConfig(max_iters=80, tolerance=1e-7),
        value=lambda W: sweep_value(to, W, tb, reg.l2_weights))
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(res.value.numpy(), np.asarray(ref.value),
                               rtol=1e-5)
    assert res.converged.tolist() == np.asarray(ref.converged).tolist()
    zeros = (res.w == 0.0).sum(1).tolist()
    assert zeros[0] > zeros[-1] and zeros[0] > 20


# -- the estimator --------------------------------------------------------------


def _glm_split(seed=7, n=1600, d=60):
    """One generative model split train/validation (dense shard)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    m = x @ (rng.normal(0, 1, d) * (rng.uniform(size=d) < 0.4))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    return x, y, int(0.8 * n)


def _datasets(x, y, cut, pkg):
    if pkg == "torch":
        D = GameDataset
    else:
        from photon_ml_tpu.game.dataset import GameDataset as D
    return (D(labels=y[:cut], features={"g": x[:cut]}, entity_ids={}),
            D(labels=y[cut:], features={"g": x[cut:]}, entity_ids={}))


def _config(pkg, **over):
    if pkg == "torch":
        from photon_ml_torch import config as c
        from photon_ml_torch.evaluation.evaluators import EvaluatorType as E
        from photon_ml_torch.models.glm import TaskType as T
        over.setdefault("device", CPU)
    else:
        from photon_ml_tpu import config as c
        from photon_ml_tpu.evaluation.evaluators import EvaluatorType as E
        from photon_ml_tpu.models.glm import TaskType as T
    base = dict(
        task_type=T.LOGISTIC_REGRESSION,
        coordinates=[c.CoordinateConfig(
            name="fixed", kind=c.CoordinateKind.FIXED_EFFECT,
            feature_shard="g",
            optimizer=c.OptimizerSettings(max_iters=200, tolerance=1e-7))],
        update_sequence=["fixed"], evaluators=[E.AUC])
    base.update(over)
    return c.TrainingConfig(**base)


def _estimator(pkg):
    if pkg == "torch":
        return GameEstimator
    from photon_ml_tpu.estimators.game_estimator import GameEstimator as J
    return J


@pytest.mark.parametrize("reg", ["L2", "ELASTIC_NET"])
def test_estimator_grid_swept_matches_reference(jax_c1, monkeypatch, reg):
    """An eligible grid takes the swept path in the port (no
    ``_fit_point``), one validation entry a CD sweep, and matches the
    reference's swept grid lane by lane: coefficients within 2e-3, AUC
    within 1e-3, and each lane's SIMPLE variances (its own λ in the
    Hessian, ``_swept_lane_model``) within 2e-3 relative."""
    x, y, cut = _glm_split()
    grid = [0.1, 1.0, 10.0] if reg == "L2" else [8.0, 0.5]
    out = {}
    for pkg in ("torch", "jax"):
        cfg = _config(pkg, reg_weight_grid={"fixed": grid})
        opt = cfg.coordinates[0].optimizer
        opt.regularization = type(opt.regularization)(reg)
        opt.variance_type = type(opt.variance_type)("SIMPLE")
        train, valid = _datasets(x, y, cut, pkg)
        est_cls = _estimator(pkg)
        calls = []
        orig = est_cls._fit_point
        monkeypatch.setattr(est_cls, "_fit_point",
                            lambda self, *a, **kw: calls.append(1)
                            or orig(self, *a, **kw))
        out[pkg] = (est_cls(cfg).fit(train, valid), calls)
    (mine, my_calls), (ref, ref_calls) = out["torch"], out["jax"]
    assert my_calls == [] and ref_calls == []
    assert [r.reg_weights["fixed"] for r in mine] == grid
    for a, b in zip(mine, ref):
        mine_c = a.model.models["fixed"].coefficients
        ref_c = b.model.models["fixed"].coefficients
        np.testing.assert_allclose(mine_c.means.numpy(),
                                   np.asarray(ref_c.means),
                                   rtol=2e-3, atol=2e-3)
        assert mine_c.variances is not None and ref_c.variances is not None
        np.testing.assert_allclose(mine_c.variances.numpy(),
                                   np.asarray(ref_c.variances), rtol=2e-3)
        auc_a = a.evaluations[EvaluatorType.AUC]
        auc_b = next(iter(b.evaluations.values()))
        assert abs(auc_a - auc_b) < 1e-3
        assert len(a.validation_history) == 1
        assert a.validation_history[-1] == a.evaluations


def test_estimator_grid_swept_matches_sequential_sparse():
    """A sparse (ELL) fixed effect with the intercept: the swept grid ≡
    the port's own per-point fits, coefficients within 2e-3."""
    cols, vals, labels = _sparse_problem(seed=11, n=1200, d=200, k=5)
    train = GameDataset(labels=labels, features={"g": _rows(cols, vals)},
                        entity_ids={}, feature_dims={"g": 200})
    grid = [5.0, 1.0, 0.2]
    cfg = _config("torch", reg_weight_grid={"fixed": grid})
    results = GameEstimator(cfg).fit(train)
    est = GameEstimator(cfg)
    prep = est._prepare(train)
    for r, lam in zip(results, grid):
        seq = est._fit_point(train, prep, {"fixed": lam}, None, None)
        np.testing.assert_allclose(
            r.model.models["fixed"].coefficients.means.numpy(),
            seq.model.models["fixed"].coefficients.means.numpy(),
            rtol=2e-3, atol=2e-3)


def test_estimator_grid_multi_coordinate_stays_sequential(monkeypatch):
    """A grid over a config with a random effect is not swept-eligible:
    one ``_fit_point`` a grid point."""
    from photon_ml_tpu.utils.synthetic import make_movielens_like

    data = make_movielens_like(n_users=40, n_items=1, n_obs=800, seed=3)
    train = GameDataset(
        labels=data["labels"],
        features={"g": data["x"],
                  "u": np.ones((len(data["labels"]), 1), np.float32)},
        entity_ids={"per_user": data["user_ids"]})
    cfg = _config(
        "torch",
        coordinates=[
            CoordinateConfig(name="fixed", kind=CoordinateKind.FIXED_EFFECT,
                             feature_shard="g",
                             optimizer=OptimizerSettings(max_iters=30)),
            CoordinateConfig(name="user", kind=CoordinateKind.RANDOM_EFFECT,
                             feature_shard="u", entity_key="per_user",
                             optimizer=OptimizerSettings(max_iters=20))],
        update_sequence=["fixed", "user"],
        reg_weight_grid={"fixed": [0.1, 1.0]}, evaluators=[])
    calls = []
    orig = GameEstimator._fit_point
    monkeypatch.setattr(GameEstimator, "_fit_point",
                        lambda self, *a, **kw: calls.append(1)
                        or orig(self, *a, **kw))
    assert len(GameEstimator(cfg).fit(train)) == 2
    assert len(calls) == 2


@pytest.mark.parametrize("mode,n_trials", [("RANDOM", 5), ("BAYESIAN", 6)])
def test_fit_tuned_batched_trials(jax_c1, monkeypatch, mode, n_trials):
    """``tests/test_sweep.py``'s tuned fit: whole proposal rounds train as
    swept solves (no ``_fit_point``), ``n_trials`` results in range.
    RANDOM proposes the reference's λ draw for draw; BAYESIAN's first
    round (random seeds of the GP) does too, and its trials' AUCs are
    the reference's within 1e-3."""
    from photon_ml_tpu.config import TuningConfig as JTuning

    x, y, cut = _glm_split()
    out = {}
    for pkg, tuning_cls in (("torch", TuningConfig), ("jax", JTuning)):
        tuning = tuning_cls(n_trials=n_trials, mode=mode, trial_batch=3,
                            reg_weight_ranges={"fixed": {"low": 0.01,
                                                         "high": 10.0}})
        train, valid = _datasets(x, y, cut, pkg)
        est_cls = _estimator(pkg)
        monkeypatch.setattr(est_cls, "_fit_point",
                            lambda self, *a, **kw: pytest.fail(
                                "tuned fell back"))
        out[pkg] = est_cls(_config(pkg, tuning=tuning)).fit_tuned(train,
                                                                   valid)
    mine, ref = out["torch"], out["jax"]
    assert len(mine) == len(ref) == n_trials
    lams = [t.reg_weights["fixed"] for t in mine]
    ref_lams = [t.reg_weights["fixed"] for t in ref]
    assert all(0.01 <= lam <= 10.0 for lam in lams)
    same = n_trials if mode == "RANDOM" else 3
    np.testing.assert_allclose(lams[:same], ref_lams[:same], rtol=1e-12)
    for a, b in zip(mine[:same], ref[:same]):
        assert 0.5 <= a.evaluations[EvaluatorType.AUC] <= 1.0
        assert abs(a.evaluations[EvaluatorType.AUC]
                   - next(iter(b.evaluations.values()))) < 1e-3


def test_checkpointed_swept_fit_names_a8a(tmp_path, monkeypatch):
    """Swept checkpoints, once ROADMAP A8a's open item: the lanes
    snapshot to their stage after each sweep, and a resumed run that
    finds the last sweep done restores the lane matrix without training
    again."""
    from photon_ml_torch.reliability.checkpoint import RunCheckpointer

    x, y, cut = _glm_split(n=200, d=5)
    train, _ = _datasets(x, y, cut, "torch")
    est = GameEstimator(_config("torch", reg_weight_grid={"fixed": [1.0,
                                                                   2.0]}))
    prep = est._prepare(train)
    coords, locked, offsets, _ = est._swept_setup(train, prep, "fixed", 2.0)
    ck_dir = str(tmp_path / "ck")
    _, W = est._train_swept_lanes(coords, "fixed", [1.0, 2.0], offsets,
                                  locked, None, None,
                                  checkpointer=RunCheckpointer(ck_dir))
    stage = RunCheckpointer(ck_dir).load_stage("swept")
    assert stage["sweep"] == est.config.n_iterations
    monkeypatch.setattr(type(coords["fixed"]), "train_swept",
                        lambda *a, **kw: pytest.fail("trained again"))
    _, W2 = est._train_swept_lanes(
        coords, "fixed", [1.0, 2.0], offsets, locked, None, None,
        checkpointer=RunCheckpointer(ck_dir, resume=True), resume=True)
    np.testing.assert_array_equal(W2.numpy(), W.numpy())


def test_swept_lane_variances_match_sequential():
    """A swept lane exports its variances with its own λ in the Hessian
    (``_lane_coordinate``): SIMPLE variances of each lane equal the
    per-point fit's within 2e-3 relative."""
    from photon_ml_torch.optim.variance import VarianceComputationType

    x, y, cut = _glm_split(n=800, d=20)
    train, _ = _datasets(x, y, cut, "torch")
    grid = [0.5, 5.0]
    cfg = _config("torch", reg_weight_grid={"fixed": grid})
    cfg.coordinates[0].optimizer.variance_type = (
        VarianceComputationType.SIMPLE)
    results = GameEstimator(cfg).fit(train)
    est = GameEstimator(cfg)
    prep = est._prepare(train)
    for r, lam in zip(results, grid):
        seq = est._fit_point(train, prep, {"fixed": lam}, None, None)
        got = r.model.models["fixed"].coefficients.variances
        want = seq.model.models["fixed"].coefficients.variances
        assert got is not None
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3)
    v = [r.model.models["fixed"].coefficients.variances for r in results]
    assert bool((v[1][:-1] < v[0][:-1]).all())   # more λ, less variance

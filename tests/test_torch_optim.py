"""Parity of the port's optimizers with the JAX package: TRON, the
lane-batched L-BFGS / OWL-QN / TRON solves, and the variances.

The same seeded numpy problems go through ``photon_ml_tpu`` and through
``photon_ml_torch`` on CPU tensors.  Tolerances: TRON's coefficients
within 1e-4 of the reference's on the squared and Poisson shapes; on
the logistic shape, where the reference rejects its last step at
float32 resolution, within the float32 resolution of the optimum (see
below); ``_boundary_tau`` equal to the reference's (float32); the
lane-batched solves against ``jax.vmap(problem.run)`` with the same
``converged`` flag in every lane, iteration counts within 1 a lane and
coefficients within 1e-4 or the lane's float32 resolution, whichever
is larger; variances within 1e-5 relative.

Float32 resolution: a solve whose line search or ratio test compares
float32 values cannot tell apart points whose objective values differ
by less than an ulp of ``F*``.  Near the optimum ``F(w) − F* ≈
½·λ_min·‖w − w*‖²``, so two points within ``ULPS`` ulps of ``F*`` lie
within ``2·sqrt(2·ULPS·ulp/λ_min)`` of each other.  ``F*``, ``w*`` and
``λ_min`` (of the Hessian at ``w*``) come from an independent float64
solve (scipy), and every port solve held to that bound is also checked
in float64 to end within ``ULPS`` ulps of ``F*``.  On the lane shapes
here (16 rows, 3 features, λ₂ = 0.5) that resolution is 5.6e-4 to
8.4e-3, above 1e-4 in every lane.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_ml_torch.data.batch import DenseBatch
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import RegularizationContext
from photon_ml_torch.optim import variance as tvar
from photon_ml_torch.optim.base import OptimizerConfig, OptimizerType
from photon_ml_torch.optim.problem import OptimizationProblem, solve_batched
from photon_ml_torch.optim.tron import (
    _boundary_tau,
    tron_solve,
    tron_solve_batched,
)
from test_torch_training import jax_c1  # noqa: F401  (the C1 fixture)

CFG = dict(max_iters=200, tolerance=1e-5)
LOSSES = {"logistic": "LOGISTIC", "squared": "SQUARED", "poisson": "POISSON"}
EPS32 = float(np.finfo(np.float32).eps)
ULPS = 4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def _problem(rng, kind: str, n: int, d: int):
    x = rng.normal(0, 0.5 if kind == "poisson" else 1.0, (n, d))
    w_true = rng.normal(0, 0.5 if kind == "poisson" else 1.0, d)
    z = x @ w_true
    if kind == "logistic":
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    elif kind == "poisson":
        y = rng.poisson(np.exp(z)).astype(np.float64)
    else:
        y = z + rng.normal(0, 0.1, n)
    return x.astype(np.float32), y.astype(np.float32)


def _objectives(kind: str, l2: float, l1: float = 0.0):
    from photon_ml_tpu.data.normalization import NormalizationContext as JN
    from photon_ml_tpu.ops import losses as jl
    from photon_ml_tpu.ops.objective import GLMObjective as JO
    from photon_ml_tpu.ops.regularization import RegularizationContext as JR

    name = LOSSES[kind]
    if l1:
        jr = JR.elastic_net(l1 + l2, l1 / (l1 + l2))
        tr = RegularizationContext.elastic_net(l1 + l2, l1 / (l1 + l2))
    else:
        jr, tr = JR.l2(l2), RegularizationContext.l2(l2)
    return (JO(loss=getattr(jl, name), reg=jr, norm=JN.identity()),
            GLMObjective(loss=getattr(losses, name), reg=tr,
                         norm=NormalizationContext.identity()))


def _jbatch(x, y):
    from photon_ml_tpu.data.batch import make_dense_batch

    return make_dense_batch(x, y)


def _tbatch(x, y) -> DenseBatch:
    n = x.shape[0]
    return DenseBatch(x=_t(x), labels=_t(y), weights=torch.ones(n),
                      offsets=torch.zeros(n), mask=torch.ones(n))


def _loss64(kind, z, y):
    """(ℓ, ℓ', ℓ'') in float64."""
    if kind == "logistic":
        s = 1.0 / (1.0 + np.exp(-z))
        return np.logaddexp(0.0, z) - y * z, s - y, s * (1.0 - s)
    if kind == "poisson":
        return np.exp(z) - y * z, np.exp(z) - y, np.exp(z)
    return 0.5 * (z - y) ** 2, z - y, np.ones_like(z)


def _value64(kind, prob, l2, l1, w):
    """F(w) = Σ wt·mask·ℓ + ½λ₂‖w‖² + λ₁‖w‖₁ in float64."""
    x, y, wt, off, mask = (np.asarray(a, np.float64) for a in prob)
    w = np.asarray(w, np.float64)
    lo = _loss64(kind, x @ w + off, y)[0]
    return (wt * mask * lo).sum() + 0.5 * l2 * w @ w + l1 * np.abs(w).sum()


def _resolution64(kind, prob, l2, l1):
    """(F*, float32 resolution of w*) from a float64 scipy solve of
    w = u − v, u, v ≥ 0; see the module docstring."""
    from scipy.optimize import minimize

    x, y, wt, off, mask = (np.asarray(a, np.float64) for a in prob)
    d = x.shape[1]

    def fun(uv):
        w = uv[:d] - uv[d:]
        lo, d1, _ = _loss64(kind, x @ w + off, y)
        g = x.T @ (wt * mask * d1) + l2 * w
        return ((wt * mask * lo).sum() + 0.5 * l2 * w @ w
                + l1 * uv.sum()), np.concatenate([g + l1, l1 - g])

    sol = minimize(fun, np.zeros(2 * d), jac=True, method="L-BFGS-B",
                   bounds=[(0.0, None)] * (2 * d),
                   options=dict(ftol=0.0, gtol=1e-14, maxiter=10000))
    w = sol.x[:d] - sol.x[d:]
    d2 = _loss64(kind, x @ w + off, y)[2]
    lmin = np.linalg.eigvalsh(x.T @ ((wt * mask * d2)[:, None] * x)
                              + l2 * np.eye(d))[0]
    f_star = float(sol.fun)
    ulp = EPS32 * max(1.0, abs(f_star))
    return f_star, 2.0 * np.sqrt(2.0 * ULPS * ulp / lmin)


def _assert_at_float32_floor(kind, prob, l2, l1, w_got, w_other):
    """``w_got`` ends within ULPS ulps of the float64 optimum value, and
    within the problem's float32 resolution (or 1e-4) of ``w_other``.
    Returns the resolution."""
    f_star, res = _resolution64(kind, prob, l2, l1)
    ulp = EPS32 * max(1.0, abs(f_star))
    assert _value64(kind, prob, l2, l1, w_got) - f_star <= ULPS * ulp
    diff = np.abs(np.asarray(w_got) - np.asarray(w_other)).max()
    assert diff <= max(1e-4, res), (diff, res)
    return res


# -- TRON ------------------------------------------------------------------------


def _tron_case(kind, n, d, l2):
    """(problem arrays, port result, reference result) of one TRON solve
    from zero."""
    import jax.numpy as jnp

    from photon_ml_tpu.optim import tron_solve as jtron
    from photon_ml_tpu.optim.base import OptimizerConfig as JC

    x, y = _problem(np.random.default_rng(42), kind, n, d)
    jo, to = _objectives(kind, l2)
    jb, tb = _jbatch(x, y), _tbatch(x, y)
    ref = jtron(lambda w: jo.value_and_gradient(w, jb),
                lambda w, v: jo.hessian_vector(w, v, jb),
                jnp.zeros(d, jnp.float32), JC(**CFG))
    got = tron_solve(lambda w: to.value_and_gradient(w, tb),
                     lambda w, v: to.hessian_vector(w, v, tb),
                     torch.zeros(d), OptimizerConfig(**CFG))
    return (x, y, np.ones(n), np.zeros(n), np.ones(n)), got, ref


TRON_CASES = [("logistic", 200, 8, 1.0), ("squared", 300, 10, 2.5),
              ("poisson", 250, 6, 0.5)]


@pytest.mark.parametrize("kind,n,d,l2", TRON_CASES)
def test_tron_matches_reference(jax_c1, kind, n, d, l2):
    """The ``tests/test_optim.py`` shapes: coefficients within 1e-4; on
    the logistic shape the reference's last step is a float32 no-op (its
    value does not change, so it is rejected) while the port's is a
    one-ulp decrease, so there the two are held to the float32
    resolution of the float64 optimum."""
    prob, got, ref = _tron_case(kind, n, d, l2)
    assert got.converged == bool(ref.converged)
    assert abs(got.iterations - int(ref.iterations)) <= 1
    if kind == "logistic":
        rv = np.asarray(ref.tracker.values)[:int(ref.tracker.count)]
        assert rv[-1] == rv[-2]                 # the rejected last step
        _assert_at_float32_floor(kind, prob, l2, 0.0, got.w.numpy(),
                                 np.asarray(ref.w))
    else:
        np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w),
                                   atol=1e-4)
    np.testing.assert_allclose(float(got.value), float(ref.value), rtol=1e-6)
    c = got.tracker.count
    assert c == got.iterations + 1
    assert np.all(np.diff(got.tracker.values[:c].numpy()) <= 1e-6)


def test_tron_through_problem_and_rejects_l1(jax_c1):
    x, y = _problem(np.random.default_rng(3), "squared", 120, 5)
    _, to = _objectives("squared", 1.0)
    problem = OptimizationProblem(to, OptimizerType.TRON,
                                  OptimizerConfig(**CFG))
    res = problem.run(_tbatch(x, y), torch.zeros(5))
    w_ref = np.linalg.solve(x.T.astype(np.float64) @ x + np.eye(5),
                            x.T.astype(np.float64) @ y)
    assert res.converged
    np.testing.assert_allclose(res.w.numpy(), w_ref, rtol=1e-4, atol=1e-5)
    _, to_l1 = _objectives("logistic", 0.5, l1=0.5)
    with pytest.raises(ValueError, match="TRON requires a smooth"):
        OptimizationProblem(to_l1, OptimizerType.TRON).run(
            _tbatch(x, (y > 0).astype(np.float32)), torch.zeros(5))


@pytest.mark.parametrize("p,d,delta", [
    ([1.0 + 1.2e-7, 0.0], [1.0, 1e-4], 1.0),    # ‖p‖ past Δ by an ulp
    ([0.5, 0.0], [1.0, 0.0], 1.0),               # forward root 0.5
    ([0.5, 0.0], [-1.0, 0.0], 1.0),              # backward root 1.5
    ([0.5, 0.0], [0.0, 0.0], 1.0),               # zero direction
    ([0.3, -0.2, 0.1], [0.7, 0.4, -0.9], 2.0),
])
def test_boundary_tau_equals_reference(p, d, delta):
    import jax.numpy as jnp

    from photon_ml_tpu.optim.tron import _boundary_tau as jtau

    want = float(jtau(jnp.asarray(p, jnp.float32), jnp.asarray(d, jnp.float32),
                      jnp.float32(delta)))
    got = float(_boundary_tau(torch.tensor(p), torch.tensor(d),
                              torch.tensor(delta)))
    assert np.isfinite(got) and got >= 0.0
    assert got == want


def test_boundary_tau_lanes():
    """Over a lane axis: each lane's τ is its own one-lane τ."""
    rng = np.random.default_rng(1)
    p, d = _t(rng.normal(size=(6, 3))), _t(rng.normal(size=(6, 3)))
    delta = _t(rng.uniform(1, 3, 6))
    lanes = _boundary_tau(p, d, delta)
    for e in range(6):
        assert float(lanes[e]) == float(_boundary_tau(p[e], d[e], delta[e]))


# -- lane-batched solves against jax.vmap(problem.run) ----------------------------


def _lanes(rng, kind, lanes, n, d, pad_rows=0):
    xs = rng.normal(0, 1, (lanes, n, d)).astype(np.float32)
    ws = rng.normal(0, 1, (lanes, d))
    z = np.einsum("end,ed->en", xs, ws)
    if kind == "logistic":
        ys = (rng.uniform(size=(lanes, n)) < 1 / (1 + np.exp(-z)))
    else:
        ys = z + rng.normal(0, 0.1, (lanes, n))
    ys = ys.astype(np.float32)
    mask = np.ones((lanes, n), np.float32)
    if pad_rows:
        # Padding rows (mask 0), an entity with one example, and one
        # with an all-zero feature column.
        mask[:, n - pad_rows:] = 0.0
        xs[:, n - pad_rows:] = 0.0
        mask[0, 1:] = 0.0
        xs[1, :, 0] = 0.0
    off = rng.normal(0, 0.3, (lanes, n)).astype(np.float32) * mask
    wt = rng.uniform(0.5, 2.0, (lanes, n)).astype(np.float32) * mask
    return xs, ys, wt, off, mask


def _assert_lanes_close(got, w_ref, it_ref, f_ref, kind, lanes_data, l2,
                        l1=0.0):
    """Iterations within 1 a lane; final values within 1e-5 relative;
    each lane's coefficients at the float32 floor of its float64
    optimum and within 1e-4 or its float32 resolution of ``w_ref``."""
    assert np.abs(got.iterations.numpy() - it_ref).max() <= 1
    np.testing.assert_allclose(got.value.numpy(), f_ref, rtol=1e-5)
    w_got = got.w.numpy()
    for e in range(w_got.shape[0]):
        _assert_at_float32_floor(kind, [a[e] for a in lanes_data], l2, l1,
                                 w_got[e], w_ref[e])
    diff = np.abs(w_got - w_ref).max(-1)
    assert (diff <= 1e-4).mean() >= 0.5


LANE_CFG = dict(max_iters=60, tolerance=1e-4, track_states=False)


def _vmap_case(solver):
    """(loss, λ₁, lane arrays, port result, ``jax.vmap`` result) of 48
    lane solves from zero."""
    import jax
    import jax.numpy as jnp

    from photon_ml_tpu.data.batch import DenseBatch as JD
    from photon_ml_tpu.optim.base import OptimizerConfig as JC
    from photon_ml_tpu.optim.base import OptimizerType as JT
    from photon_ml_tpu.optim.problem import OptimizationProblem as JP

    lanes, n, d = 48, 16, 3
    kind = "squared" if solver == "tron" else "logistic"
    xs, ys, wt, off, mask = _lanes(np.random.default_rng(7), kind, lanes, n,
                                   d, pad_rows=4)
    l1 = 0.3 if solver == "owlqn" else 0.0
    jo, to = _objectives(kind, 0.5, l1=l1)
    opt = "TRON" if solver == "tron" else "LBFGS"
    jp = JP(objective=jo, optimizer=JT(opt), config=JC(**LANE_CFG))
    jb = JD(x=jnp.asarray(xs), labels=jnp.asarray(ys), weights=jnp.asarray(wt),
            offsets=jnp.asarray(off), mask=jnp.asarray(mask))
    has_l1 = jp.has_l1()
    ref = jax.vmap(lambda b, w: jp.run(b, w, has_l1=has_l1))(
        jb, jnp.zeros((lanes, d), jnp.float32))
    tp = OptimizationProblem(to, OptimizerType(opt),
                             OptimizerConfig(**LANE_CFG))
    tb = DenseBatch(x=_t(xs), labels=_t(ys), weights=_t(wt), offsets=_t(off),
                    mask=_t(mask))
    got = solve_batched(tp, tb, torch.zeros(lanes, d))
    return kind, l1, (xs, ys, wt, off, mask), got, ref


@pytest.mark.parametrize("solver", ["lbfgs", "owlqn", "tron"])
def test_solve_batched_matches_vmap(jax_c1, solver):
    kind, l1, data, got, ref = _vmap_case(solver)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    _assert_lanes_close(got, np.asarray(ref.w), np.asarray(ref.iterations),
                        np.asarray(ref.value), kind, data, 0.5, l1)
    assert len(np.unique(got.iterations.numpy())) > 1    # lanes stop apart


def test_lanes_keep_their_own_state():
    """A lane solved beside others ends where it ends alone: lanes that
    finish are not moved by the lanes still running."""
    xs, ys, wt, off, mask = _lanes(np.random.default_rng(9), "logistic", 12,
                                   20, 4)
    _, to = _objectives("logistic", 1.0)
    tp = OptimizationProblem(to, config=OptimizerConfig(**LANE_CFG))
    tb = DenseBatch(x=_t(xs), labels=_t(ys), weights=_t(wt), offsets=_t(off),
                    mask=_t(mask))
    together = solve_batched(tp, tb, torch.zeros(12, 4))
    assert len(np.unique(together.iterations.numpy())) > 1
    alone = [solve_batched(
        tp, DenseBatch(x=tb.x[e:e + 1], labels=tb.labels[e:e + 1],
                       weights=tb.weights[e:e + 1],
                       offsets=tb.offsets[e:e + 1], mask=tb.mask[e:e + 1]),
        torch.zeros(1, 4)) for e in range(12)]
    _assert_lanes_close(
        together, np.concatenate([a.w.numpy() for a in alone]),
        np.concatenate([a.iterations.numpy() for a in alone]),
        np.concatenate([a.value.numpy() for a in alone]), "logistic",
        (xs, ys, wt, off, mask), 1.0)


def test_tron_batched_tracker_and_single_lane_agree():
    x, y = _problem(np.random.default_rng(5), "logistic", 80, 4)
    _, to = _objectives("logistic", 1.0)
    tb = _tbatch(x, y)
    cfg = OptimizerConfig(max_iters=50, tolerance=1e-6)
    one = tron_solve(lambda w: to.value_and_gradient(w, tb),
                     lambda w, v: to.hessian_vector(w, v, tb),
                     torch.zeros(4), cfg)
    lanes = tron_solve_batched(
        lambda W: tuple(t[None] for t in to.value_and_gradient(W[0], tb)),
        lambda W, V: to.hessian_vector(W[0], V[0], tb)[None],
        torch.zeros(1, 4), cfg)
    assert int(lanes.tracker.count[0]) == one.tracker.count
    np.testing.assert_array_equal(lanes.w[0].numpy(), one.w.numpy())


# -- variances ---------------------------------------------------------------------


@pytest.mark.parametrize("vtype", ["SIMPLE", "FULL"])
def test_variances_match_reference(jax_c1, vtype):
    import jax.numpy as jnp

    from photon_ml_tpu.optim import variance as jvar

    x, y = _problem(np.random.default_rng(11), "logistic", 150, 6)
    jo, to = _objectives("logistic", 0.7)
    w = np.random.default_rng(12).normal(0, 0.3, 6).astype(np.float32)
    ref = jvar.compute_variances(jo, jnp.asarray(w), _jbatch(x, y),
                                 jvar.VarianceComputationType(vtype))
    got = tvar.compute_variances(to, _t(w), _tbatch(x, y),
                                 tvar.VarianceComputationType(vtype))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    assert tvar.compute_variances(
        to, _t(w), _tbatch(x, y), tvar.VarianceComputationType.NONE) is None


def test_lane_variances_match_vmapped_reference(jax_c1):
    import jax
    import jax.numpy as jnp

    from photon_ml_tpu.data.batch import DenseBatch as JD
    from photon_ml_tpu.optim.variance import simple_variances

    xs, ys, wt, off, mask = _lanes(np.random.default_rng(13), "logistic", 10,
                                   12, 3, pad_rows=2)
    jo, to = _objectives("logistic", 0.4)
    w = np.random.default_rng(14).normal(0, 0.5, (10, 3)).astype(np.float32)
    jb = JD(x=jnp.asarray(xs), labels=jnp.asarray(ys), weights=jnp.asarray(wt),
            offsets=jnp.asarray(off), mask=jnp.asarray(mask))
    ref = jax.vmap(lambda w_, b_: simple_variances(jo, w_, b_))(
        jnp.asarray(w), jb)
    tb = DenseBatch(x=_t(xs), labels=_t(ys), weights=_t(wt), offsets=_t(off),
                    mask=_t(mask))
    got = tvar.simple_variances(to, _t(w), tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


# -- readings ------------------------------------------------------------------------


def _readings() -> None:
    """Per case: the largest coefficient gap to the reference, the lanes
    past 1e-4, the float32 resolution and the port's largest distance to
    the float64 optimum value in ulps."""
    def show(name, kind, probs, l2, l1, w_got, w_ref):
        res, ulps = [], []
        for prob, w in zip(probs, w_got):
            f_star, r = _resolution64(kind, prob, l2, l1)
            res.append(r)
            ulps.append((_value64(kind, prob, l2, l1, w) - f_star)
                        / (EPS32 * max(1.0, abs(f_star))))
        gap = np.abs(np.asarray(w_got) - np.asarray(w_ref)).reshape(
            len(probs), -1).max(-1)
        print(f"{name}: max |Δw| {gap.max():.3g}, past 1e-4 "
              f"{int((gap > 1e-4).sum())}/{len(gap)}, resolution "
              f"{min(res):.3g}–{max(res):.3g}, port F − F* ≤ "
              f"{max(ulps):.3g} ulps")

    for kind, n, d, l2 in TRON_CASES:
        prob, got, ref = _tron_case(kind, n, d, l2)
        show(f"TRON {kind}", kind, [prob], l2, 0.0, [got.w.numpy()],
             [np.asarray(ref.w)])
    for solver in ("lbfgs", "owlqn", "tron"):
        kind, l1, data, got, ref = _vmap_case(solver)
        show(f"lanes {solver}", kind,
             [[a[e] for a in data] for e in range(len(data[0]))], 0.5, l1,
             got.w.numpy(), np.asarray(ref.w))


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_optim.py
    import jax
    import jax._src.core

    jax.config.update("jax_platforms", "cpu")
    # ROADMAP C1, restored as the ``jax_c1`` fixture restores it.
    jax.core.trace_state_clean = jax._src.core.trace_state_clean
    _readings()

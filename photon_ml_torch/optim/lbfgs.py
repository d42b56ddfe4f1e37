"""L-BFGS and OWL-QN as a host loop over device tensors.

Counterpart of ``photon_ml_tpu/optim/lbfgs.py``, whose solvers are
``lax.while_loop`` programs.  The arithmetic and the decisions are the
same: the two-loop recursion over the newest ``lbfgs_memory`` (s, y)
pairs, a backtracking Armijo line search, the curvature guard on a pair
(``sᵀy > ε‖s‖‖y‖``), the steepest-descent restart on a non-descent
direction, and the stopping rules of ``optim.base``.  With an L1 weight
the same loop is OWL-QN: the pseudo-gradient drives the direction and
the convergence test, the direction is projected onto its descent
orthant, and line-search points are projected onto the starting orthant
and scored with the L1 term.

The loop is written once over a leading lane axis:
``lbfgs_solve_batched`` solves E problems at once, the counterpart of
``jax.vmap`` of the reference's solve (its random-effect buckets), and
``lbfgs_solve`` is the one-lane case.  Every lane keeps its own (s, y)
memory, line search (its own number of trials and its own step),
curvature guard and stopping decisions; a finished lane keeps its
state.  One host read a line-search trial and one an iteration ask
whether any lane is still running.

``lbfgs_solve_swept`` / ``owlqn_solve_swept`` are the λ-sweep entries:
the same batched loop over L λ-lanes of ONE problem, whose objective
evaluates every lane against a shared batch
(``ops.objective.sweep_value_and_gradient``), with per-lane L1 weights
for OWL-QN.
"""

from __future__ import annotations

import torch

from photon_ml_torch.optim.base import (
    OptimizationResult,
    OptimizerConfig,
    StatesTracker,
    ValueAndGrad,
    grad_converged,
    loss_converged,
)

Tensor = torch.Tensor

_CURVATURE_EPS = 1e-10


def _pseudo_gradient(g: Tensor, w: Tensor, l1: Tensor) -> Tensor:
    """OWL-QN pseudo-gradient of f(w) + ‖l1 ⊙ w‖₁ (Andrew & Gao 2007)."""
    g_plus = g + l1
    g_minus = g - l1
    zero = torch.zeros_like(g)
    return torch.where(
        w > 0.0, g_plus,
        torch.where(w < 0.0, g_minus,
                    torch.where(g_minus > 0.0, g_minus,
                                torch.where(g_plus < 0.0, g_plus, zero))))


def _orthant(w: Tensor, pg: Tensor) -> Tensor:
    """OWL-QN search orthant: sign(w), or sign(−pg) where w = 0."""
    return torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))


def _vdot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def _two_loop(g_dir: Tensor, s_buf: Tensor, y_buf: Tensor,
                    rho_buf: Tensor, count: Tensor, used: int) -> Tensor:
    """Two-loop recursion per lane over newest-first buffers ([E, m, d];
    slot j holds a lane's (j+1)-th newest pair, valid for j < count).
    ``used`` bounds every lane's count (no slot past it is valid)."""
    q = g_dir
    alphas = []
    for j in range(used):                       # newest → oldest
        valid = j < count
        a = rho_buf[:, j] * _vdot(s_buf[:, j], q)
        a = torch.where(valid, a, torch.zeros_like(a))
        q = q - a[:, None] * y_buf[:, j]
        alphas.append(a)
    y_new = y_buf[:, 0]
    gamma = torch.where(
        count > 0,
        1.0 / torch.clamp(rho_buf[:, 0] * _vdot(y_new, y_new),
                          min=_CURVATURE_EPS),
        torch.ones_like(rho_buf[:, 0]))
    r = gamma[:, None] * q
    for j in reversed(range(used)):             # oldest → newest
        valid = (j < count)[:, None]
        beta = rho_buf[:, j] * _vdot(y_buf[:, j], r)
        upd = s_buf[:, j] * (alphas[j] - beta)[:, None]
        r = r + torch.where(valid, upd, torch.zeros_like(upd))
    return -r


def _line_search(value_fn, w: Tensor, f0: Tensor, pg: Tensor,
                       d: Tensor, config: OptimizerConfig,
                       xi: Tensor | None, active: Tensor):
    """Backtracking Armijo lane by lane → (w_new, f_new, ok, alpha,
    trials); each active lane halves its own step until it accepts or
    runs out of halvings, the others keep their first trial."""

    def trial(alpha):
        w_try = w + alpha[:, None] * d
        if xi is not None:
            w_try = torch.where(torch.sign(w_try) == xi, w_try,
                                torch.zeros_like(w_try))
        return w_try, value_fn(w_try)

    def accepts(w_try, f_try):
        return f_try <= f0 + config.ls_c1 * _vdot(pg, w_try - w)

    alpha = torch.ones_like(f0)
    steps = torch.zeros(f0.shape, dtype=torch.int32, device=f0.device)
    w_try, f_try = trial(alpha)
    searching = active & ~accepts(w_try, f_try)
    while bool(searching.any()):
        alpha = torch.where(searching, alpha * config.ls_shrink, alpha)
        w_next, f_next = trial(alpha)
        w_try = torch.where(searching[:, None], w_next, w_try)
        f_try = torch.where(searching, f_next, f_try)
        steps = torch.where(searching, steps + 1, steps)
        searching = (searching & ~accepts(w_try, f_try)
                     & (steps < config.ls_max_steps))
    return w_try, f_try, f_try < f0, alpha, steps + 1


def lbfgs_solve_batched(value_and_grad: ValueAndGrad, w0: Tensor,
                        config: OptimizerConfig = OptimizerConfig(),
                        l1_weight: Tensor | float | None = None,
                        value=None) -> OptimizationResult:
    """Minimize E smooth objectives at once (plus an optional L1 term →
    OWL-QN on every lane).

    Args:
      value_and_grad: ``W [E, d] → (f [E], G [E, d])``, lane by lane;
        L1 not folded in.
      w0: [E, d] starting points (their device is the solver's).
      l1_weight: None, or L1 weights ([d] or [E, d]; a scalar
        broadcasts), which turns on OWL-QN.
      value: optional ``W → f [E]`` for line-search trials.

    Returns a lane-batched ``OptimizationResult``."""
    m = config.lbfgs_memory
    lanes, d = w0.shape
    dev = w0.device
    owlqn = l1_weight is not None
    l1 = (torch.as_tensor(l1_weight, dtype=w0.dtype, device=dev)
          .expand(lanes, d) if owlqn else None)
    smooth_value = value if value is not None else (
        lambda w: value_and_grad(w)[0])

    def full_value(w):
        f = smooth_value(w)
        return f + (l1 * w.abs()).sum(-1) if owlqn else f

    f0_s, g = value_and_grad(w0)
    f = f0_s + (l1 * w0.abs()).sum(-1) if owlqn else f0_s
    pg0 = _pseudo_gradient(g, w0, l1) if owlqn else g
    g0_norm = torch.linalg.norm(pg0, dim=-1)
    tracker = StatesTracker.create(lanes, config.max_iters, dev)
    every = torch.ones(lanes, dtype=torch.bool, device=dev)
    if config.track_states:
        tracker.record(0, every, f, g0_norm)
    converged = grad_converged(g0_norm, g0_norm, config.tolerance)
    done = converged.clone()

    s_buf = torch.zeros((lanes, m, d), dtype=w0.dtype, device=dev)
    y_buf = torch.zeros_like(s_buf)
    rho_buf = torch.zeros((lanes, m), dtype=w0.dtype, device=dev)
    count = torch.zeros(lanes, dtype=torch.int32, device=dev)
    iterations = torch.zeros(lanes, dtype=torch.int32, device=dev)
    w = w0
    step = 0
    while step < config.max_iters and bool((~done).any()):
        active = ~done
        pg = _pseudo_gradient(g, w, l1) if owlqn else g
        d_dir = _two_loop(pg, s_buf, y_buf, rho_buf, count,
                                min(step, m))
        xi = None
        if owlqn:
            d_dir = torch.where(d_dir * -pg > 0.0, d_dir,
                                torch.zeros_like(d_dir))
            xi = _orthant(w, pg)
        bad = _vdot(pg, d_dir) >= 0.0
        d_dir = torch.where(bad[:, None], -pg, d_dir)

        w_new, f_new, ls_ok, alpha, trials = _line_search(
            full_value, w, f, pg, d_dir, config, xi, active)
        _, g_new = value_and_grad(w_new)

        s = w_new - w
        y = g_new - g
        sy = _vdot(s, y)
        good = ls_ok & (sy > _CURVATURE_EPS * torch.linalg.norm(s, dim=-1)
                        * torch.linalg.norm(y, dim=-1))
        rho = 1.0 / torch.clamp(sy, min=_CURVATURE_EPS)
        push = (active & good)[:, None, None]
        s_buf = torch.where(push, torch.cat([s[:, None], s_buf[:, :-1]], 1),
                            s_buf)
        y_buf = torch.where(push, torch.cat([y[:, None], y_buf[:, :-1]], 1),
                            y_buf)
        rho_buf = torch.where(push[:, :, 0],
                              torch.cat([rho[:, None], rho_buf[:, :-1]], 1),
                              rho_buf)
        count = torch.where(active & good, torch.clamp(count + 1, max=m),
                            count)

        pg_new = _pseudo_gradient(g_new, w_new, l1) if owlqn else g_new
        g_norm = torch.linalg.norm(pg_new, dim=-1)
        # A failed backtrack on a guaranteed descent direction: the
        # decrease is below float32 resolution; reported converged.
        conv = (grad_converged(g_norm, g0_norm, config.tolerance)
                | loss_converged(f_new, f, config.rel_tolerance)
                | ~ls_ok)
        step += 1
        if config.track_states:
            tracker.record(step, active, f_new, g_norm,
                           step_size=torch.where(ls_ok, alpha,
                                                 torch.zeros_like(alpha)),
                           ls_trials=trials)
        take = active & ls_ok
        w = torch.where(take[:, None], w_new, w)
        f = torch.where(take, f_new, f)
        g = torch.where(take[:, None], g_new, g)
        iterations = torch.where(active, torch.full_like(iterations, step),
                                 iterations)
        converged = converged | (active & conv)
        done = done | (active & conv)

    pg_f = _pseudo_gradient(g, w, l1) if owlqn else g
    return OptimizationResult(
        w=w, value=f, grad_norm=torch.linalg.norm(pg_f, dim=-1),
        iterations=iterations, converged=converged, tracker=tracker)


def lbfgs_solve(value_and_grad: ValueAndGrad, w0: Tensor,
                config: OptimizerConfig = OptimizerConfig(),
                l1_weight: Tensor | float | None = None,
                value=None) -> OptimizationResult:
    """Minimize one smooth objective (plus an optional L1 term → OWL-QN):
    ``lbfgs_solve_batched`` over a single lane.

    Args:
      value_and_grad: the smooth part, ``w → (f, ∇f)``; L1 not folded in.
      w0: [dim] initial point (its device is the solver's).
      l1_weight: None, or per-coordinate L1 weights [dim] (a scalar
        broadcasts), which turns on OWL-QN.
      value: optional ``w → f`` for line-search trials (the value alone,
        without the gradient's contraction).
    """
    l1 = (None if l1_weight is None else torch.as_tensor(
        l1_weight, dtype=w0.dtype, device=w0.device).expand(w0.shape[-1]))
    res = lbfgs_solve_batched(
        lambda W: tuple(t[None] for t in value_and_grad(W[0])), w0[None],
        config, l1_weight=l1,
        value=None if value is None else (lambda W: value(W[0])[None]))
    return OptimizationResult(
        w=res.w[0], value=res.value[0], grad_norm=res.grad_norm[0],
        iterations=int(res.iterations[0]), converged=bool(res.converged[0]),
        tracker=res.tracker.lane(0))


def owlqn_solve(value_and_grad: ValueAndGrad, w0: Tensor,
                l1_weight: Tensor | float,
                config: OptimizerConfig = OptimizerConfig(),
                value=None) -> OptimizationResult:
    """OWL-QN = L-BFGS with orthant-wise L1 handling."""
    return lbfgs_solve(value_and_grad, w0, config, l1_weight=l1_weight,
                       value=value)


def lbfgs_solve_swept(value_and_grad, w0s: Tensor,
                      config: OptimizerConfig = OptimizerConfig(),
                      l1_weights: Tensor | None = None,
                      value=None) -> OptimizationResult:
    """Batched masked-lane L-BFGS / OWL-QN over the L points of a λ grid.

    One solve drives every grid point at once, so each objective
    evaluation serves all L coefficient lanes against the SAME batch:
    one data stream amortized across the grid.  Every lane converges on
    its own criteria, as ``lbfgs_solve`` would alone.

    Args:
      value_and_grad: ``W [L, d] → (f [L], G [L, d])`` over the shared
        batch, each lane with its own L2 weight
        (``ops.objective.sweep_value_and_gradient``).
      w0s: [L, d] stacked starting points.
      l1_weights: None (L-BFGS) or per-lane L1 weights, [L] scalars or
        [L, d] vectors, which turn on OWL-QN on EVERY lane (a zero row
        is an all-zero L1 vector).
      value: optional ``W → f [L]`` for line-search trials
        (``ops.objective.sweep_value``).
    """
    l1 = None
    if l1_weights is not None:
        l1 = torch.as_tensor(l1_weights, dtype=w0s.dtype, device=w0s.device)
        if l1.dim() == 1:
            l1 = l1[:, None]
        l1 = l1.expand(w0s.shape)
    return lbfgs_solve_batched(value_and_grad, w0s, config, l1_weight=l1,
                               value=value)


def owlqn_solve_swept(value_and_grad, w0s: Tensor, l1_weights: Tensor,
                      config: OptimizerConfig = OptimizerConfig(),
                      value=None) -> OptimizationResult:
    """Batched-lane OWL-QN (see ``lbfgs_solve_swept``)."""
    return lbfgs_solve_swept(value_and_grad, w0s, config,
                             l1_weights=l1_weights, value=value)

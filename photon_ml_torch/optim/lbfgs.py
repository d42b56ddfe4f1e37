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
and scored with the L1 term.  Each line-search trial and each iteration
end read one decision back to the host.

The swept (stacked-λ) solvers are ROADMAP A6.
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


def _two_loop(g_dir: Tensor, pairs: list) -> Tensor:
    """Two-loop recursion over ``pairs`` (oldest first) → descent
    direction; with no pairs, steepest descent."""
    q = g_dir
    alphas = []
    for s, y, rho in reversed(pairs):          # newest → oldest
        alpha = rho * torch.dot(s, q)
        q = q - alpha * y
        alphas.append(alpha)
    if pairs:
        _, y_new, rho_new = pairs[-1]
        gamma = 1.0 / torch.clamp(rho_new * torch.dot(y_new, y_new),
                                  min=_CURVATURE_EPS)
        r = gamma * q
    else:
        r = q
    for (s, y, rho), alpha in zip(pairs, reversed(alphas)):  # oldest → newest
        beta = rho * torch.dot(y, r)
        r = r + s * (alpha - beta)
    return -r


def _orthant(w: Tensor, pg: Tensor) -> Tensor:
    """OWL-QN search orthant: sign(w), or sign(−pg) where w = 0."""
    return torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))


def _line_search(value_fn, w: Tensor, f0: Tensor, pg: Tensor, d: Tensor,
                 config: OptimizerConfig, xi: Tensor | None):
    """Backtracking Armijo → (w_new, f_new, ok, alpha, trials).

    Accepts ``f(x⁺) ≤ f(x) + c1 · pgᵀ(x⁺ − x)`` with x⁺ = π(x + α·d; ξ)
    (Andrew & Gao's condition; plain Armijo without a projection)."""

    def trial(alpha):
        w_try = w + alpha * d
        if xi is not None:
            w_try = torch.where(torch.sign(w_try) == xi, w_try,
                                torch.zeros_like(w_try))
        return w_try, value_fn(w_try)

    def accepts(w_try, f_try) -> bool:
        return bool(f_try <= f0 + config.ls_c1 * torch.dot(pg, w_try - w))

    alpha = 1.0
    steps = 0
    w_try, f_try = trial(alpha)
    while not accepts(w_try, f_try) and steps < config.ls_max_steps:
        alpha *= config.ls_shrink
        w_try, f_try = trial(alpha)
        steps += 1
    return w_try, f_try, bool(f_try < f0), alpha, steps + 1


def lbfgs_solve(value_and_grad: ValueAndGrad, w0: Tensor,
                config: OptimizerConfig = OptimizerConfig(),
                l1_weight: Tensor | float | None = None,
                value=None) -> OptimizationResult:
    """Minimize a smooth objective (plus an optional L1 term → OWL-QN).

    Args:
      value_and_grad: the smooth part, ``w → (f, ∇f)``; L1 not folded in.
      w0: [dim] initial point (its device is the solver's).
      l1_weight: None, or per-coordinate L1 weights [dim] (a scalar
        broadcasts), which turns on OWL-QN.
      value: optional ``w → f`` for line-search trials (the value alone,
        without the gradient's contraction); defaults to
        ``value_and_grad(w)[0]``.
    """
    m = config.lbfgs_memory
    d = w0.shape[-1]
    owlqn = l1_weight is not None
    l1 = (torch.as_tensor(l1_weight, dtype=w0.dtype, device=w0.device)
          .expand(d) if owlqn else None)
    smooth_value = value if value is not None else (
        lambda w: value_and_grad(w)[0])

    def full_value(w):
        f = smooth_value(w)
        return f + (l1 * w.abs()).sum() if owlqn else f

    f0_s, g = value_and_grad(w0)
    f = f0_s + (l1 * w0.abs()).sum() if owlqn else f0_s
    pg0 = _pseudo_gradient(g, w0, l1) if owlqn else g
    g0_norm_t = torch.linalg.norm(pg0)
    tracker = StatesTracker.create(config.max_iters, w0.device)
    if config.track_states:
        tracker.record(0, f, g0_norm_t)
    g0_norm = float(g0_norm_t)
    converged = done = grad_converged(g0_norm, g0_norm, config.tolerance)

    w = w0
    pairs: list = []        # (s, y, 1/sᵀy), oldest first, at most m
    it = 0
    while not done and it < config.max_iters:
        pg = _pseudo_gradient(g, w, l1) if owlqn else g
        d_dir = _two_loop(pg, pairs)
        xi = None
        if owlqn:
            # Constrain to the pseudo-gradient's descent orthant.
            d_dir = torch.where(d_dir * -pg > 0.0, d_dir,
                                torch.zeros_like(d_dir))
            xi = _orthant(w, pg)
        # Not a descent direction (numerical breakdown): steepest descent.
        d_dir = torch.where(torch.dot(pg, d_dir) >= 0.0, -pg, d_dir)

        w_new, f_new, ls_ok, alpha, trials = _line_search(
            full_value, w, f, pg, d_dir, config, xi)
        _, g_new = value_and_grad(w_new)

        s = w_new - w
        y = g_new - g
        sy = torch.dot(s, y)
        curvature = sy > _CURVATURE_EPS * torch.linalg.norm(s) \
            * torch.linalg.norm(y)
        pg_new = _pseudo_gradient(g_new, w_new, l1) if owlqn else g_new
        g_norm_t = torch.linalg.norm(pg_new)
        g_norm, f_new_v, f_old_v, good = torch.stack([
            g_norm_t, f_new.to(g_norm_t.dtype), f.to(g_norm_t.dtype),
            curvature.to(g_norm_t.dtype)]).tolist()
        if ls_ok and good:
            pairs.append((s, y, 1.0 / torch.clamp(sy, min=_CURVATURE_EPS)))
            del pairs[:-m]
        conv = (grad_converged(g_norm, g0_norm, config.tolerance)
                or loss_converged(f_new_v, f_old_v, config.rel_tolerance))
        # A failed backtrack on a guaranteed descent direction means the
        # decrease is below float32 resolution: report converged.
        stalled = not ls_ok
        conv = conv or stalled
        it += 1
        if config.track_states:
            tracker.record(it, f_new, g_norm_t,
                           step_size=alpha if ls_ok else 0.0,
                           ls_trials=trials)
        if ls_ok:
            w, f, g = w_new, f_new, g_new
        done = conv
        converged = converged or conv

    pg_f = _pseudo_gradient(g, w, l1) if owlqn else g
    return OptimizationResult(
        w=w, value=f, grad_norm=torch.linalg.norm(pg_f), iterations=it,
        converged=converged, tracker=tracker)


def owlqn_solve(value_and_grad: ValueAndGrad, w0: Tensor,
                l1_weight: Tensor | float,
                config: OptimizerConfig = OptimizerConfig(),
                value=None) -> OptimizationResult:
    """OWL-QN = L-BFGS with orthant-wise L1 handling."""
    return lbfgs_solve(value_and_grad, w0, config, l1_weight=l1_weight,
                       value=value)

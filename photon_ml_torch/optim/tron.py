"""TRON: trust-region Newton with a Steihaug conjugate-gradient inner loop.

Counterpart of ``photon_ml_tpu/optim/tron.py``, whose two loops are
``lax.while_loop`` programs with converged-lane guards.  Here both loops
are host loops over device tensors, written once over a leading lane
axis: ``tron_solve_batched`` solves E problems at once, each lane with
its own trust radius, its own CG loop and its own stopping decisions,
exactly as ``jax.vmap`` of the reference's solve does (a lane that has
finished keeps its state); ``tron_solve`` is the one-lane case.  Each
CG step and each outer iteration read one decision back to the host:
whether any lane is still running.  In a telemetry session the solve
counts ``solver.resident.iterations`` and ``solver.resident.host_reads``,
as L-BFGS does.

The arithmetic is the reference's: LIBLINEAR's radius schedule, the
ρ = actual/predicted acceptance test, the precision stop when the model
predicts less reduction than float32 resolves on |f|, and
``_boundary_tau`` in its cancellation-safe float32 form.
"""

from __future__ import annotations

import torch

from photon_ml_torch import telemetry
from photon_ml_torch.optim.base import (
    Hvp,
    OptimizationResult,
    OptimizerConfig,
    StatesTracker,
    ValueAndGrad,
    any_lane,
    grad_converged,
    loss_converged,
)

Tensor = torch.Tensor

# LIBLINEAR / Lin-Moré trust-region constants.
_ETA0 = 1e-4    # minimum ρ to accept a step
_SIGMA1 = 0.25  # shrink factor on poor steps
_SIGMA3 = 4.0   # growth factor on very good boundary steps
_DELTA_MIN = 1e-12


def _vdot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def _boundary_tau(p: Tensor, d: Tensor, delta: Tensor) -> Tensor:
    """τ ≥ 0 with ‖p + τ·d‖ = Δ (the largest root), over the last axis.

    When p sits on the boundary to rounding, Δ² − ‖p‖² goes negative by
    an ulp and the textbook ``(disc − pd)/dd`` cancels for pd > 0 into a
    small negative τ; the conjugate form ``gap/(pd + disc)`` is exact
    there.  The root form is picked by sign(pd) and τ clamped at 0."""
    dd = torch.clamp(_vdot(d, d), min=1e-30)
    pd = _vdot(p, d)
    pp = _vdot(p, p)
    gap = delta * delta - pp
    disc = torch.sqrt(torch.clamp(pd * pd + dd * gap, min=0.0))
    tau = torch.where(pd > 0.0,
                      gap / torch.clamp(pd + disc, min=1e-30),
                      (disc - pd) / dd)
    return torch.clamp(tau, min=0.0)


def _steihaug_cg(hvp_w, g: Tensor, delta: Tensor, config: OptimizerConfig,
                 active: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Approximately solve H p = −g within ‖p‖ ≤ Δ, lane by lane.

    Returns (p [E, d], hit_boundary [E], cg_iters [E]).  A lane stops on
    ‖r‖ ≤ cg_tolerance·‖g‖, the iteration cap, the trust boundary or
    non-positive curvature; lanes not ``active`` do not run."""
    g_norm = torch.linalg.norm(g, dim=-1)
    tol = config.cg_tolerance * g_norm
    p = torch.zeros_like(g)
    r = -g
    d = r
    rs = _vdot(r, r)
    iters = torch.zeros(g.shape[0], dtype=torch.int32, device=g.device)
    done = (g_norm <= 0.0) | ~active
    boundary = torch.zeros_like(done)
    for _ in range(config.cg_max_iters):
        if not any_lane(~done):
            break
        live = ~done
        hd = hvp_w(d)
        dhd = _vdot(d, hd)
        neg_curv = dhd <= 0.0
        alpha = torch.where(neg_curv, torch.zeros_like(dhd),
                            rs / torch.clamp(dhd, min=1e-30))
        p_try = p + alpha[:, None] * d
        outside = torch.linalg.norm(p_try, dim=-1) >= delta
        take = neg_curv | outside
        tau = _boundary_tau(p, d, delta)
        p_new = torch.where(take[:, None], p + tau[:, None] * d, p_try)
        r_new = r - alpha[:, None] * hd
        rs_new = _vdot(r_new, r_new)
        finished = take | (torch.sqrt(rs_new) <= tol)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        d_new = r_new + beta[:, None] * d
        lv = live[:, None]
        p = torch.where(lv, p_new, p)
        r = torch.where(lv, r_new, r)
        d = torch.where(lv, d_new, d)
        rs = torch.where(live, rs_new, rs)
        iters = torch.where(live, iters + 1, iters)
        boundary = boundary | (live & take)
        done = done | finished
    return p, boundary, iters


def tron_solve_batched(value_and_grad: ValueAndGrad, hvp: Hvp, w0: Tensor,
                       config: OptimizerConfig = OptimizerConfig()
                       ) -> OptimizationResult:
    """Minimize E twice-differentiable objectives at once.

    Args:
      value_and_grad: ``W [E, d] → (f [E], G [E, d])``, lane by lane.
      hvp: ``(W, V) → H(W)·V`` lane by lane, the L2 term included (the
        objective's ``hessian_vector`` over a lane-stacked batch does).
        L1 is not supported, as in the reference.
      w0: [E, d] starting points (their device is the solver's).

    Returns a lane-batched ``OptimizationResult``: [E]-shaped value,
    grad_norm, iterations and converged, [E, d] w."""
    lanes = w0.shape[0]
    dev = w0.device
    f, g = value_and_grad(w0)
    g0_norm = torch.linalg.norm(g, dim=-1)
    tracker = StatesTracker.create(lanes, config.max_iters, dev)
    every = torch.ones(lanes, dtype=torch.bool, device=dev)
    if config.track_states:
        tracker.record(0, every, f, g0_norm)
    converged = grad_converged(g0_norm, g0_norm, config.tolerance)
    done = converged.clone()
    delta = g0_norm.clone()      # LIBLINEAR's initial radius
    iterations = torch.zeros(lanes, dtype=torch.int32, device=dev)
    w = w0
    step = 0
    while step < config.max_iters and any_lane(~done):
        telemetry.count("solver.resident.iterations")
        active = ~done
        w_at = w

        def hvp_w(v):
            return hvp(w_at, v)

        p, _, cg_iters = _steihaug_cg(hvp_w, g, delta, config, active)
        f_new, g_new = value_and_grad(w + p)
        actual = f - f_new
        predicted = -(_vdot(g, p) + 0.5 * _vdot(p, hvp_w(p)))
        rho = actual / torch.clamp(predicted, min=1e-30)
        accept = (rho > _ETA0) & (actual > 0.0)
        p_norm = torch.linalg.norm(p, dim=-1)
        # Radius update (Lin & Moré's simplified schedule, as in LIBLINEAR).
        delta_new = torch.where(
            rho < _SIGMA1, torch.minimum(delta, p_norm) * _SIGMA1,
            torch.where(rho > 0.75,
                        torch.maximum(delta, _SIGMA3 * p_norm / 2.0), delta))
        delta_new = torch.clamp(delta_new, min=_DELTA_MIN)
        acc = accept[:, None]
        w_new = torch.where(acc, w + p, w)
        f_kept = torch.where(accept, f_new, f)
        g_kept = torch.where(acc, g_new, g)
        g_norm = torch.linalg.norm(g_kept, dim=-1)
        conv = grad_converged(g_norm, g0_norm, config.tolerance) | (
            accept & loss_converged(f_new, f, config.rel_tolerance))
        # Precision stop: the model predicts less reduction than float32
        # resolves on |f|, so further steps would only shrink Δ.
        conv = conv | (predicted <= 1e-6 * torch.clamp(f.abs(), min=1.0))
        stalled = delta_new <= _DELTA_MIN
        step += 1
        if config.track_states:
            tracker.record(step, active, f_kept, g_norm,
                           step_size=torch.where(accept, p_norm,
                                                 torch.zeros_like(p_norm)),
                           ls_trials=cg_iters)
        act = active[:, None]
        w = torch.where(act, w_new, w)
        f = torch.where(active, f_kept, f)
        g = torch.where(act, g_kept, g)
        delta = torch.where(active, delta_new, delta)
        iterations = torch.where(active, torch.full_like(iterations, step),
                                 iterations)
        converged = converged | (active & conv)
        done = done | (active & (conv | stalled))
    return OptimizationResult(
        w=w, value=f, grad_norm=torch.linalg.norm(g, dim=-1),
        iterations=iterations, converged=converged, tracker=tracker)


def tron_solve(value_and_grad: ValueAndGrad, hvp: Hvp, w0: Tensor,
               config: OptimizerConfig = OptimizerConfig()
               ) -> OptimizationResult:
    """One problem: ``tron_solve_batched`` over a single lane.

    ``hvp(w, v)`` must return ``H(w)·v`` including the L2 term (the
    objective's ``hessian_vector`` does)."""
    res = tron_solve_batched(
        lambda W: tuple(t[None] for t in value_and_grad(W[0])),
        lambda W, V: hvp(W[0], V[0])[None], w0[None], config)
    # The lane's iterations, its convergence and its tracker's count.
    telemetry.count("solver.resident.host_reads", 3)
    return OptimizationResult(
        w=res.w[0], value=res.value[0], grad_norm=res.grad_norm[0],
        iterations=int(res.iterations[0]), converged=bool(res.converged[0]),
        tracker=res.tracker.lane(0))

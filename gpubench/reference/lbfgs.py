"""L-BFGS as the configurations state it, over a leading lane axis.

Written from the configuration's solver settings, not from the program:
the two-loop recursion over the newest ``memory`` (s, y) pairs, a
backtracking Armijo line search that starts at step 1 and halves up to
``ls_max_steps`` times, a pair kept only when sᵀy > ε·‖s‖·‖y‖, the
steepest-descent direction where the two-loop's is not a descent one,
and the stopping rules: ‖g‖ ≤ tolerance·max(1, ‖g₀‖), or a line search
that found no decrease.  Every lane keeps its own memory, steps and
stopping decision; a stopped lane keeps its point.

The arithmetic runs in the dtype of ``w0``: float64 for the reference,
a lower precision for the control.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(-1)


def _direction(g: Tensor, s_hist: list, y_hist: list, rho_hist: list
               ) -> Tensor:
    """−H·g by the two-loop recursion over per-lane histories (newest
    first); a lane's missing pairs are zero rows with rho 0."""
    q = g
    alphas = []
    for s, y, rho in zip(s_hist, y_hist, rho_hist):
        a = rho * _dot(s, q)
        q = q - a[:, None] * y
        alphas.append(a)
    if s_hist:
        y0, rho0 = y_hist[0], rho_hist[0]
        yy = _dot(y0, y0)
        gamma = torch.where(rho0 > 0, 1.0 / torch.clamp(rho0 * yy, min=1e-10),
                            torch.ones_like(rho0))
    else:
        gamma = torch.ones(g.shape[0], dtype=g.dtype, device=g.device)
    r = gamma[:, None] * q
    for s, y, rho, a in reversed(list(zip(s_hist, y_hist, rho_hist,
                                          alphas))):
        b = rho * _dot(y, r)
        r = r + s * (a - b)[:, None]
    return -r


def minimize(value_and_grad, value, w0: Tensor, solver: dict,
             max_iters: int, tolerance: float) -> Tensor:
    """Minimize E lanes of a smooth objective from ``w0`` [E, p].

    ``value_and_grad(W) → (f [E], G [E, p])``, ``value(W) → f [E]``;
    ``solver`` holds ``memory``, ``ls_shrink``, ``ls_c1``,
    ``ls_max_steps`` and ``curvature_eps``.  Returns W [E, p]."""
    memory = int(solver["memory"])
    shrink, c1 = float(solver["ls_shrink"]), float(solver["ls_c1"])
    max_steps, eps = int(solver["ls_max_steps"]), float(solver["curvature_eps"])
    w = w0.clone()
    f, g = value_and_grad(w)
    g0_norm = torch.linalg.vector_norm(g, dim=-1)
    limit = tolerance * torch.clamp(g0_norm, min=1.0)
    done = g0_norm <= limit
    s_hist: list = []
    y_hist: list = []
    rho_hist: list = []
    for _ in range(max_iters):
        if bool(done.all()):
            break
        d = _direction(g, s_hist, y_hist, rho_hist)
        d = torch.where((_dot(g, d) >= 0)[:, None], -g, d)
        # Armijo backtracking, lane by lane.
        alpha = torch.ones_like(f)
        w_try = w + alpha[:, None] * d
        f_try = value(w_try)
        searching = ~done & ~(f_try <= f + c1 * _dot(g, w_try - w))
        halvings = torch.zeros_like(f, dtype=torch.int64)
        while bool(searching.any()):
            alpha = torch.where(searching, alpha * shrink, alpha)
            w_next = w + alpha[:, None] * d
            f_next = value(w_next)
            w_try = torch.where(searching[:, None], w_next, w_try)
            f_try = torch.where(searching, f_next, f_try)
            halvings = halvings + searching.long()
            searching = (searching & ~(f_try <= f + c1 * _dot(g, w_try - w))
                         & (halvings < max_steps))
        decreased = f_try < f
        _, g_try = value_and_grad(w_try)
        s = w_try - w
        y = g_try - g
        sy = _dot(s, y)
        keep = (~done & decreased
                & (sy > eps * torch.linalg.vector_norm(s, dim=-1)
                   * torch.linalg.vector_norm(y, dim=-1)))
        rho = torch.where(keep, 1.0 / torch.clamp(sy, min=eps),
                          torch.zeros_like(sy))
        # A lane that keeps no pair keeps its history: its new slot is
        # the old newest, shifted in only where the lane keeps one.
        if not s_hist or bool(keep.any()):
            new_s, new_y, new_rho = [], [], []
            old = list(zip(s_hist, y_hist, rho_hist))
            n_slots = min(len(old) + 1, memory)
            for j in range(n_slots):
                shifted = (s, y, rho) if j == 0 else old[j - 1]
                kept = old[j] if j < len(old) else (
                    torch.zeros_like(s), torch.zeros_like(y),
                    torch.zeros_like(rho))
                new_s.append(torch.where(keep[:, None], shifted[0], kept[0]))
                new_y.append(torch.where(keep[:, None], shifted[1], kept[1]))
                new_rho.append(torch.where(keep, shifted[2], kept[2]))
            s_hist, y_hist, rho_hist = new_s, new_y, new_rho
        take = ~done & decreased
        w = torch.where(take[:, None], w_try, w)
        f = torch.where(take, f_try, f)
        g = torch.where(take[:, None], g_try, g)
        stop = (torch.linalg.vector_norm(g_try, dim=-1) <= limit) | ~decreased
        done = done | stop
    return w

"""Shared helpers of the benchmark's CPU tests: cells cut to a size a
test run holds, and ports with a fault planted under the timed path."""

from __future__ import annotations

import dataclasses
import types

import torch

from gpubench import manifest, port

CELLS = tuple(w["name"] for w in manifest.benchmark()["workloads"])


def tiny(name: str) -> dict:
    """``name``'s cell at 6,000 rows of 500 features, 10 a row, and then
    its configuration's own ``tiny`` overrides where its file has them
    (entity counts, say): its entry, traffic and limits as they are."""
    cell = manifest.cell(name)
    config = cell["config"]
    config.update(rows=6000, features=500, nnz_per_row=10)
    config.update(config.get("tiny", {}))
    return cell


def _negate_largest(w):
    """``w`` (a tensor, or a random effect's tensors a bucket) with its
    largest coefficient negated, in a copy."""
    if isinstance(w, torch.Tensor):
        return _negate_largest([w])[0]
    w = [b.clone() for b in w]
    b = max((i for i in range(len(w)) if w[i].numel()),
            key=lambda i: float(w[i].abs().max()))
    flat = w[b].view(-1)
    j = int(flat.abs().argmax())
    flat[j] = -flat[j]
    return w


def _start(w, initial):
    """The starting coefficients of a coordinate whose answer is ``w``:
    ``initial``, or zeros shaped as ``w``."""
    if initial is not None:
        return initial
    if isinstance(w, torch.Tensor):
        return torch.zeros_like(w)
    return [torch.zeros_like(b) for b in w]


def faulty_port(fault: str):
    """``gpubench.port`` with ``fault`` planted where each entry's fit
    produces its answer (``fixed_effect_solve``, ``game_fit``):
    ``unchanged`` (a fit returns its starting state: every coordinate's
    starting coefficients), ``altered`` (the largest coefficient of each
    answer, each coordinate's, negated).  ``half_rows`` is planted in the
    objective instead (``half_rows_objective``)."""
    fake = types.SimpleNamespace(**{k: getattr(port, k) for k in dir(port)
                                    if not k.startswith("__")})

    def solve(coord, w0):
        w = port.fixed_effect_solve(coord, w0)
        return w0.clone() if fault == "unchanged" else _negate_largest(w)

    def game(est, coords, initial=None):
        got = port.game_fit(est, coords, initial)
        if fault == "unchanged":
            return {k: _start(w, (initial or {}).get(k))
                    for k, w in got.items()}
        return {k: _negate_largest(w) for k, w in got.items()}

    fake.fixed_effect_solve = solve
    fake.game_fit = game
    return fake


def half_rows_objective(monkeypatch) -> None:
    """Every evaluation of the objective sees the first half of its rows
    weighted twice and the rest left out (the mean over the rest)."""
    cls = port.GLMObjective

    def halved(batch):
        n = batch.weights.shape[-1]
        f = torch.zeros(n, dtype=batch.weights.dtype,
                        device=batch.weights.device)
        f[: n // 2] = 2.0
        return dataclasses.replace(batch, weights=batch.weights * f)

    value, value_and_gradient = cls.value, cls.value_and_gradient
    monkeypatch.setattr(cls, "value",
                        lambda self, w, batch: value(self, w, halved(batch)))
    monkeypatch.setattr(
        cls, "value_and_gradient",
        lambda self, w, batch: value_and_gradient(self, w, halved(batch)))

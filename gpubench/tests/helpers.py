"""Shared helpers of the benchmark's CPU tests: cells cut to a size a
test run holds, and ports with a fault planted under the timed path."""

from __future__ import annotations

import dataclasses
import types

import torch

from gpubench import manifest, port

CELLS = tuple(w["name"] for w in manifest.benchmark()["workloads"])


def tiny(name: str) -> dict:
    """``name``'s cell at 6,000 rows of 500 features, 10 a row: its
    entry, traffic and limits as they are."""
    cell = manifest.cell(name)
    cell["config"].update(rows=6000, features=500, nnz_per_row=10)
    return cell


def _negate_largest(w: torch.Tensor) -> torch.Tensor:
    w = w.clone()
    flat = w.view(-1)
    j = int(flat.abs().argmax())
    flat[j] = -flat[j]
    return w


def faulty_port(fault: str):
    """``gpubench.port`` with ``fault`` planted where each entry's fit
    produces its answer: ``unchanged`` (a fit returns its starting
    state), ``altered`` (the largest coefficient of each answer
    negated).  ``half_rows`` is planted in the objective instead
    (``half_rows_objective``)."""
    fake = types.SimpleNamespace(**{k: getattr(port, k) for k in dir(port)
                                    if not k.startswith("__")})

    def solve(coord, w0):
        w = port.fixed_effect_solve(coord, w0)
        return w0.clone() if fault == "unchanged" else _negate_largest(w)

    fake.fixed_effect_solve = solve
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

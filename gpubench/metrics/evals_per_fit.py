"""Objective evaluations a fit, as the port's resident solvers count
them (``solver.resident.evaluations``: value-and-gradient and
value-only calls)."""

from gpubench.metrics import _spans


def read(sources):
    return _spans.counter(sources, "solver.resident.evaluations")

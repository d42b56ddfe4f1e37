"""Reads of a device value by the host a fit (each one waits for the
device), as the port's resident solvers count them
(``solver.resident.host_reads``)."""

from gpubench.metrics import _spans


def read(sources):
    return _spans.counter(sources, "solver.resident.host_reads")

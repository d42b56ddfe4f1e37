"""Line-search trials an L-BFGS iteration, as the port's resident
solvers count them (``solver.resident.ls_trials`` over
``solver.resident.iterations``)."""

from gpubench.metrics import _spans


def read(sources):
    trials = _spans.counter(sources, "solver.resident.ls_trials")
    iterations = _spans.counter(sources, "solver.resident.iterations")
    if trials is None or not iterations:
        return None
    return trials / iterations

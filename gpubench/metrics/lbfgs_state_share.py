"""Share (%) of the device's busy time launched under the port's
``lbfgs.direction`` and ``lbfgs.update`` spans (the L-BFGS history: the
two-loop recursion and the update of the pairs), in the session
span."""

from gpubench.metrics import _spans


def read(sources):
    return _spans.share(sources, ("lbfgs.direction", "lbfgs.update"))

"""B1 (``gather_rowsum``) against its byte bound (%): the bounds of the
launches recorded in the traced window over the device time of its
events there."""

from gpubench import bounds
from gpubench.metrics import _roofline


def _bound(launch, peak):
    n, k = launch["shapes"]["vals"]
    return bounds.gather_rowsum_bound_s(n, k, launch["distinct"]["ids"],
                                        peak)


def read(sources):
    return _roofline.share(sources, "gather_rowsum", _bound)

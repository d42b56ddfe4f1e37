"""Xᵀr over the column-sorted copy (``sorted_colsum``, its kernel and
fix-up) against its byte bound (%): the bounds of the launches recorded
in the traced window over the device time of their events there."""

from gpubench import bounds
from gpubench.metrics import _roofline


def _bound(launch, peak):
    nnz = launch["shapes"]["rows"][0]
    dim = launch["shapes"]["col_ptr"][0] - 1
    return bounds.sorted_colsum_bound_s(nnz, dim, launch["distinct"]["rows"],
                                        peak)


def read(sources):
    return _roofline.share(sources, "sorted_colsum", _bound)

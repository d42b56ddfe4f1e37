"""Share (%) of the device's busy time launched under the port's ``xtr``
span (Xᵀr on whichever path runs: ``sorted_colsum`` over the
column-sorted copy, or the ``index_add_`` scatter, with their casts and
fills), in the session span.

The span's bounds are the port's (``xtr`` in ``data/batch.py``): work
moved into or out of it moves this share.  Readings taken before the
metric read the span (the summed ``indexFunc`` scatter kernels of the
device-only span) are not comparable with these."""

from gpubench.metrics import _spans


def read(sources):
    return _spans.share(sources, ("xtr",))

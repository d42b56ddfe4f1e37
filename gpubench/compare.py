"""The numbers that decide ``correct``.

A fit is judged by its final coefficients against the float64 reference
fit, leaf by leaf (a coordinate's coefficients, a λ-lane), the largest
over the leaves:

- ``obj_gap``: |F(w) − F(w_ref)| / |F(w_ref)|, F the configuration's
  objective in float64 at the leaf's λ;
- ``coef_gap``: ‖w − w_ref‖ over the larger of ‖w_ref‖ and the median
  leaf's ‖w_ref‖ (a strongly regularized lane is all but zero);
- ``coef_max_gap``: the same with the largest magnitude in place of the
  Euclidean norm: the worst single coefficient against the leaf's
  largest, so that one coefficient altered reads about 2 however many
  coefficients the leaf has.
"""

from __future__ import annotations

import numpy as np

_TINY = np.finfo(np.float64).tiny


def _norm(x, order) -> float:
    return float(np.linalg.norm(np.ravel(x), order))


def leaf_scales(reference: dict, order=None) -> dict:
    names = list(reference)
    norms = [_norm(reference[k], order) for k in names]
    median = float(np.median(norms))
    return {k: max(n, median, _TINY) for k, n in zip(names, norms)}


def leaf_gaps(answer: dict, reference: dict, order=None) -> dict:
    """Each leaf's gap in the ``order`` norm (``numpy.linalg.norm``'s;
    None the Euclidean) over its scale (``leaf_scales``)."""
    scales = leaf_scales(reference, order)
    out = {}
    for name, ref in reference.items():
        got = np.asarray(answer[name], np.float64)
        if got.shape != ref.shape:
            raise ValueError(f"leaf {name}: shape {got.shape} against the "
                             f"reference's {ref.shape}")
        out[name] = _norm(got - ref, order) / scales[name]
    return out


def coef_gap(answer: dict, reference: dict) -> float:
    """One fit's ``coef_gap``."""
    return max(leaf_gaps(answer, reference).values())


def coef_max_gap(answer: dict, reference: dict) -> float:
    """One fit's ``coef_max_gap``."""
    return max(leaf_gaps(answer, reference, np.inf).values())


def obj_gap(values: dict, reference: dict) -> float:
    """One fit's ``obj_gap`` from its objective values and the
    reference's, by leaf."""
    return max(abs(values[k] - r) / max(abs(r), _TINY)
               for k, r in reference.items())


def unchanged(reference: dict) -> dict:
    """The answer of a fit that returns its starting state unchanged:
    zero coefficients."""
    return {k: np.zeros_like(v) for k, v in reference.items()}


def altered(reference: dict) -> dict:
    """The reference's answer with the largest coefficient of each leaf
    negated: an answer altered where it is produced."""
    out = {}
    for k, v in reference.items():
        w = np.array(v, np.float64)
        flat = w.reshape(-1)
        j = int(np.argmax(np.abs(flat)))
        flat[j] = -flat[j]
        out[k] = w
    return out

"""The one generator of the benchmark's training inputs.

A configuration's ``data`` names its model of the rows, a module
``gpubench/traffic/<data>.py`` with ``draw(config, rng)``; ``generate``
seeds one ``numpy`` generator with the run's seed and hands it over, so
a seed gives the same inputs every time and every seed draws its own
rows, columns and labels at the configuration's sizes.  The pieces the
models share are frozen copies of ``chip_smoke.py``'s
``_power_law_rows`` and the labelling of ``make_training_data`` (the
repository's KDD Cup 2012 scale generator, ``examples/kdd_scale.py``).

A model returns plain arrays: ``indptr``, ``cols``, ``vals`` (CSR over
the features, no intercept column), ``labels`` and ``dim``.
"""

from __future__ import annotations

import importlib

import numpy as np


def generate(config: dict, seed: int) -> dict:
    """The training rows of ``config`` for ``seed`` (see the module)."""
    model = config["data"]
    if not model.isidentifier():
        raise ValueError(f"bad data model {model!r}")
    module = importlib.import_module(f"gpubench.traffic.{model}")
    return module.draw(config, np.random.default_rng(int(seed)))


def power_law_rows(rng, n: int, d: int, k: int):
    """(indptr, cols, vals) of ``k`` distinct power-law columns a row,
    values 1.0; a planted sparse w_true [d]."""
    cols = np.sort(((d - k) * rng.random((n, k)) ** 2.2).astype(np.int64),
                   axis=1)
    for j in range(1, k):
        bump = cols[:, j] <= cols[:, j - 1]
        cols[bump, j] = cols[bump, j - 1] + 1
    indptr = np.arange(n + 1, dtype=np.int64) * k
    vals = np.ones(n * k, np.float32)
    w_true = np.zeros(d)
    n_active = max(d // 20, 200)
    active = rng.choice(d, size=n_active, replace=False)
    w_true[active] = rng.normal(0, 1.2, n_active)
    return indptr, cols.reshape(-1), vals, w_true


def dot(indptr, cols, vals, w) -> np.ndarray:
    """X·w by prefix sums in float64, rounded to float32."""
    contrib = vals.astype(np.float64) * w[cols]
    cs = np.zeros(len(contrib) + 1, np.float64)
    np.cumsum(contrib, out=cs[1:])
    return (cs[indptr[1:]] - cs[indptr[:-1]]).astype(np.float32)


def bernoulli(rng, margins: np.ndarray) -> np.ndarray:
    return (rng.random(len(margins))
            < 1.0 / (1.0 + np.exp(-margins))).astype(np.float32)

"""Rows of a planted sparse fixed effect: ``nnz_per_row`` distinct
power-law columns of ``features`` a row, values 1.0, labels Bernoulli
of the planted effect's margin less 1 (``chip_smoke.py``'s
``make_training_data``)."""

from __future__ import annotations

import numpy as np

from gpubench.traffic.generate import bernoulli, dot, power_law_rows


def draw(config: dict, rng) -> dict:
    n, d, k = (int(config["rows"]), int(config["features"]),
               int(config["nnz_per_row"]))
    indptr, cols, vals, w_true = power_law_rows(rng, n, d, k)
    margins = dot(indptr, cols, vals, w_true).astype(np.float64)
    return {"dim": d, "indptr": indptr, "cols": cols, "vals": vals,
            "labels": bernoulli(rng, margins - 1.0)}

"""Deterministic synthetic datasets standing in for the reference fixtures.

Counterpart of ``photon_ml_tpu/utils/synthetic.py``: numpy only, and the
same arrays from the same seed.

The reference's integration tests run on small Avro fixtures (a1a-style
binary classification, Yahoo-music-style user/song random effects —
SURVEY.md §4 tier 3).  This environment has no network, so equivalent
datasets are generated deterministically: same shapes, same statistical
character (sparse binary indicator features, power-law entity sizes),
fixed seeds.  They serve as the permanent parity fixtures and the
benchmark inputs.
"""

from __future__ import annotations

import numpy as np


def make_a1a_like(
    n: int = 3000,
    dim: int = 123,
    nnz_per_row: int = 14,
    seed: int = 7,
) -> tuple[list[tuple[np.ndarray, np.ndarray]], np.ndarray, np.ndarray]:
    """a1a-shaped binary classification: sparse 0/1 indicator features.

    a1a (Adult) has d=123 binary features, ~14 nnz/row.  Labels follow a
    sparse logistic ground truth with an achievable AUC in the high .80s,
    matching the class of threshold the reference's a1a fixtures gate on.

    Returns (rows, labels01, w_true).
    """
    rng = np.random.default_rng(seed)
    # Feature popularity is skewed (indicator features from categorical
    # one-hots): sample columns with a Zipf-ish distribution.
    popularity = 1.0 / np.arange(1, dim + 1) ** 0.7
    popularity /= popularity.sum()
    w_true = np.zeros(dim)
    active = rng.choice(dim, size=25, replace=False)
    w_true[active] = rng.normal(0, 1.6, size=25)

    rows = []
    margins = np.empty(n)
    for i in range(n):
        k = int(np.clip(rng.poisson(nnz_per_row), 3, dim))
        cols = np.sort(
            rng.choice(dim, size=k, replace=False, p=popularity)
        ).astype(np.int32)
        vals = np.ones(k, np.float32)
        rows.append((cols, vals))
        margins[i] = w_true[cols].sum()
    margins -= margins.mean()
    p = 1.0 / (1.0 + np.exp(-margins))
    labels = (rng.uniform(size=n) < p).astype(np.float32)
    return rows, labels, w_true


def make_movielens_like(
    n_users: int = 200,
    n_items: int = 100,
    n_obs: int = 8000,
    dim_global: int = 20,
    seed: int = 11,
) -> dict:
    """Mixed-effect data: global features + per-user and per-item effects.

    The GAME analog of the reference's Yahoo-music integration fixture:
    response = sigmoid(x·w_global + u_user + b_item-ish per-entity effects)
    with power-law entity frequencies (the skew that makes random-effect
    bucketing hard, SURVEY.md §7 "hard parts").

    Returns dict with x [n,dim_global], user_ids, item_ids, labels, and
    the ground-truth effects.
    """
    rng = np.random.default_rng(seed)
    w_global = rng.normal(0, 1.0, dim_global)
    # Per-entity coefficient vectors over a small per-entity feature space
    # (intercept-only effects here; richer RE features in game tests).
    u_eff = rng.normal(0, 1.2, n_users)
    i_eff = rng.normal(0, 0.8, n_items)

    user_pop = 1.0 / np.arange(1, n_users + 1) ** 1.1
    user_pop /= user_pop.sum()
    item_pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    item_pop /= item_pop.sum()

    users = rng.choice(n_users, size=n_obs, p=user_pop)
    items = rng.choice(n_items, size=n_obs, p=item_pop)
    x = rng.normal(0, 1, (n_obs, dim_global)).astype(np.float32)
    margins = x @ w_global + u_eff[users] + i_eff[items]
    p = 1.0 / (1.0 + np.exp(-margins))
    labels = (rng.uniform(size=n_obs) < p).astype(np.float32)
    return {
        "x": x,
        "user_ids": users.astype(np.int32),
        "item_ids": items.astype(np.int32),
        "labels": labels,
        "w_global": w_global,
        "user_effects": u_eff,
        "item_effects": i_eff,
    }

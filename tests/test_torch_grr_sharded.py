"""Parity of the port's sharded GRR plans with the JAX package's.

``data.grr.build_sharded_grr_pairs`` is the reference's numpy builder,
copied, so the shard plans must equal the reference's leaf for leaf
(bitwise) on the ``tests/test_grr_sharded.py`` shapes: uniform, a forced
hot column, Zipf-skewed columns, pooled overflow and a mid-hot set.  The
shard list caches as one plan-cache entry (``"sharded": True`` in its
key) that loads in either package.  Every padded level (real supertiles
followed by zero-valued dummy ones, and the all-dummy levels of a shard
holding only padding rows) goes through the plain B2/B3 against the
reference's Pallas kernels in interpret mode at 1e-5, and the shards'
contractions sum to the global plan's (the JAX package's tolerance
against its own global plan: 2e-4 relative, 5e-4 absolute).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import pytest
import torch

from photon_ml_torch.cache import plan_cache as tcache
from photon_ml_torch.data import grr as tgrr
from photon_ml_torch.ops import grr_kernel as tk
from test_torch_grr import _table_t, _to_torch, assert_same_plan
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)


def _ell(rng, n, d, k, hot_col=None, skew=False):
    """The reference test's synthetic ELL (optional forced-hot column and
    power-law columns, unique ids a row)."""
    if skew:
        cols = (rng.zipf(1.3, (n, k)) % d).astype(np.int64)
        for _ in range(4):
            s = np.sort(cols, axis=1)
            dup = (s[:, 1:] == s[:, :-1]).any(axis=1)
            if not dup.any():
                break
            cols[dup] = rng.choice(d, (int(dup.sum()), k), replace=True)
        base = np.arange(k) * (d // k)
        for i in np.flatnonzero([len(set(r)) < k for r in cols]):
            cols[i] = base + rng.integers(0, d // k, k)
    else:
        block = d // k
        cols = (np.arange(k) * block)[None, :] + rng.integers(
            0, block, (n, k))
    if hot_col is not None:
        cols[:, 0] = hot_col
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    return cols.astype(np.int32), vals


def _split(a, n_dev):
    per = a.shape[0] // n_dev
    return [a[i * per:(i + 1) * per] for i in range(n_dev)]


CASES = {
    # name: (n, d, k, n_dev, ell options, build options)
    "uniform": (1024, 600, 8, 8, {}, {"overflow_threshold": 64}),
    "hot": (512, 400, 6, 8, {"hot_col": 3}, {}),
    "skew": (1024, 600, 8, 8, {"skew": True}, {"overflow_threshold": 64}),
    "pooled": (512, 256, 8, 4, {"pooled": True},
               {"hot_threshold": 10 ** 9, "overflow_threshold": 4}),
    "mid": (2048, 3000, 6, 4, {"skew": True}, {"mid_threshold": 40}),
}


def _case(name, seed=3):
    n, d, k, n_dev, eo, bo = CASES[name]
    rng = np.random.default_rng(seed)
    pooled = eo.pop("pooled", False) if eo else False
    cols, vals = _ell(rng, n, d, k, **eo)
    eo["pooled"] = pooled
    if pooled:
        cols[:, :4] = np.arange(4)[None, :]
    return cols, vals, d, n_dev, dict(bo)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_pairs_identical_to_reference(name):
    """Every shard's plan equals the reference's, leaf for leaf; the
    shards are congruent (one shape a leaf, one cap a direction, one hot
    and mid set); their contractions sum to the global plan's."""
    from photon_ml_tpu.data import grr as jgrr

    cols, vals, d, n_dev, bo = _case(name)
    jp = jgrr.build_sharded_grr_pairs(_split(cols, n_dev),
                                      _split(vals, n_dev), d, **bo)
    tp = tgrr.build_sharded_grr_pairs(_split(cols, n_dev),
                                      _split(vals, n_dev), d, **bo)
    assert len(tp) == n_dev
    for i, (a, b) in enumerate(zip(jp, tp)):
        assert_same_plan(a, b, where=f"shard {i}")
    assert len({p.col_dir.vals.shape for p in tp}) == 1
    assert len({p.col_dir.cap for p in tp}) == 1
    if name == "pooled":
        assert all(p.col_dir.overflow is not None and p.col_dir.n_spill == 0
                   for p in tp)
    if name == "mid":
        assert tp[0].mid_ids is not None
    bo.pop("overflow_threshold", None)
    bo.pop("mid_threshold", None)
    ref = tgrr.build_grr_pair(cols, vals, d, device="cpu", **bo)
    placed = [p.to("cpu") for p in tp]
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(0, 1, d).astype(np.float32))
    r = torch.from_numpy(rng.normal(0, 1, cols.shape[0]).astype(np.float32))
    np.testing.assert_allclose(
        torch.cat([p.dot(w) for p in placed]).numpy(), ref.dot(w).numpy(),
        rtol=2e-4, atol=5e-4)
    got = sum(p.t_dot(rr) for p, rr in zip(placed, r.chunk(n_dev)))
    np.testing.assert_allclose(got.numpy(), ref.t_dot(r).numpy(),
                               rtol=2e-4, atol=5e-4)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sharded_plan_cache_shared_both_ways(writer, tmp_path):
    """The shard list is one cache entry, written by either package and
    a hit in the other, with the reference's leaves."""
    from photon_ml_tpu.cache import plan_cache as jcache
    from photon_ml_tpu.data import grr as jgrr

    cols, vals, d, n_dev, bo = _case("hot")
    cc, vv = _split(cols, n_dev), _split(vals, n_dev)
    cache = str(tmp_path)
    first, second = ((jgrr, tgrr) if writer == "jax" else (tgrr, jgrr))
    a = first.build_sharded_grr_pairs(cc, vv, d, cache_dir=cache, **bo)
    files = [f for f in os.listdir(tmp_path / "plans")]
    assert len(files) == 1
    path = str(tmp_path / "plans" / files[0])
    mtime = os.path.getmtime(path)
    b = second.build_sharded_grr_pairs(cc, vv, d, cache_dir=cache, **bo)
    assert os.path.getmtime(path) == mtime      # a hit: nothing rewritten
    assert os.listdir(tmp_path / "plans") == files
    jp, tp = (a, b) if writer == "jax" else (b, a)
    for x, y in zip(jp, tp):
        assert_same_plan(x, y)
    for x, y in zip(jcache.load_plan(path), tcache.load_plan(path)):
        assert_same_plan(x, y)


def _levels(direction):
    d = direction
    while d is not None:
        yield d
        d = d.overflow


def test_padded_levels_plain_kernels_match_interpret():
    """Each padded level of every shard, through the plain B2/B3, against
    the reference's Pallas kernels in interpret mode (1e-5).  The last
    shard holds only padding rows: its levels are all dummy supertiles,
    and both give exact zeros."""
    import jax.numpy as jnp

    from photon_ml_tpu.data import grr as jgrr
    from photon_ml_tpu.ops.grr_kernel import (
        grr_contract_kernel,
        grr_contract_kernel_dense,
    )

    cols, vals, d, n_dev, bo = _case("pooled")
    vals[-cols.shape[0] // n_dev:] = 0.0          # shard 3: padding only
    pairs = jgrr.build_sharded_grr_pairs(_split(cols, n_dev),
                                         _split(vals, n_dev), d, **bo)
    rng = np.random.default_rng(5)
    padded = 0
    for s, pair in enumerate(pairs):
        for name in ("row_dir", "col_dir"):
            for lvl in _levels(getattr(pair, name)):
                table = rng.normal(0, 1, lvl.table_len).astype(np.float32)
                tt = _table_t(lvl, table)
                jt = jnp.asarray(tt.numpy())
                p = _to_torch(lvl)
                if lvl.dense_grid:
                    want = grr_contract_kernel_dense(
                        jt, lvl.g1, lvl.g2, lvl.g3, lvl.vals, lvl.gw_of_st,
                        n_ow_p=lvl.n_ow_padded, cap=lvl.cap, interpret=True)
                    got = tk.grr_contract_dense(
                        tt, p["g1"], p["g2"], p["g3"], p["vals"],
                        p["gw_of_st"], n_ow_p=lvl.n_ow_padded, cap=lvl.cap)
                else:
                    want = grr_contract_kernel(
                        jt, lvl.g1, lvl.g2, lvl.g3, lvl.vals, lvl.gw_of_st,
                        lvl.ow_of_st, lvl.first_of_ow, n_ow=lvl.n_ow,
                        cap=lvl.cap, interpret=True)
                    got = tk.grr_contract(
                        tt, p["g1"], p["g2"], p["g3"], p["vals"],
                        p["gw_of_st"], p["ow_of_st"], p["first_of_ow"],
                        n_ow=lvl.n_ow, cap=lvl.cap)
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-5)
                real = int(np.count_nonzero(
                    np.abs(np.asarray(lvl.vals)).sum(axis=(1, 2))))
                padded += real < lvl.n_supertiles
                if s == n_dev - 1:
                    assert real == 0 and not got.any()
    assert padded >= n_dev


def test_collect_spill_warnings_one_summary(caplog):
    """The public scope folds every nested plan build's spill flags into
    one summary line (the sharded builds below each flag)."""
    cols, vals, d, n_dev, bo = _case("uniform")
    bo["overflow_threshold"] = None
    with caplog.at_level(logging.WARNING, logger=tgrr.__name__):
        with tgrr.collect_spill_warnings():
            for cap in (4, 8):
                tgrr.build_sharded_grr_pairs(
                    _split(cols, n_dev), _split(vals, n_dev), d, cap=cap)
    lines = [r for r in caplog.records if "spill" in r.getMessage()]
    assert len(lines) == 1

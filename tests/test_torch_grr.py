"""Parity of the port's GRR layer with the JAX package.

The same numpy inputs go through ``photon_ml_tpu`` (its builder, its jnp
plan executors and its Pallas kernels in interpret mode) and through
``photon_ml_torch`` on CPU tensors (the builder, the torch plan types and
the plain versions of the B2/B3 kernels).  Plans must be identical leaf
for leaf; contractions agree to float32 reordering (``rtol=1e-5``
against the reference's executors, the JAX package's own
``rtol=2e-5, atol=2e-4`` against a float64 dense product).

The CUDA kernels run only on the GPU: the tests marked ``cuda`` skip
without a card.  The JAX package is imported inside the tests that use
it, so the ``cuda`` tests also run where only PyTorch is installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_grr.py
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from photon_ml_torch.data import grr as tgrr
from photon_ml_torch.kernels import _build
from photon_ml_torch.ops import grr_kernel as tk
from photon_ml_torch.ops.crossbar import apply_route_numpy, route_tile
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)

RTOL, ATOL = 2e-5, 2e-4


def _jax():
    """(jax.numpy, photon_ml_tpu.data.grr), imported on use."""
    import jax.numpy as jnp

    from photon_ml_tpu.data import grr as jgrr

    return jnp, jgrr


def _coo(rng, nnz, L, S):
    return (rng.integers(0, L, nnz), rng.integers(0, S, nnz),
            rng.normal(0, 1, nnz).astype(np.float32))


def _direct(idx, seg, val, table, S):
    out = np.zeros(S, np.float64)
    np.add.at(out, seg, val.astype(np.float64) * table[idx])
    return out


def _dense(cols, vals, n, dim):
    x = np.zeros((n, dim), np.float64)
    np.add.at(x, (np.repeat(np.arange(n), cols.shape[1]), cols.reshape(-1)),
              vals.reshape(-1).astype(np.float64))
    return x


def _powerlaw_ell(rng, n, k, dim, x0=3000.0):
    u = rng.uniform(size=(n, k))
    cols = np.minimum(x0 * np.exp(u * np.log((dim + x0) / x0)) - x0,
                      dim - 1).astype(np.int32)
    return cols, rng.normal(0, 1, (n, k)).astype(np.float32)


def _host(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same_plan(ref, port, where="plan"):
    """Leaf-for-leaf identity of a reference plan node and a port one."""
    if ref is None or port is None:
        assert ref is None and port is None, where
        return
    kind = type(ref).__name__
    assert type(port).__name__ == kind, (where, kind, type(port).__name__)
    if kind == "GrrPair":
        for f in ("hot_ids", "x_hot", "mid_ids"):
            a, b = getattr(ref, f), getattr(port, f)
            assert (a is None) == (b is None), (where, f)
            if a is not None:
                a, b = np.asarray(a), _host(b)
                assert a.dtype == b.dtype and np.array_equal(a, b), (where, f)
        for f in ("row_dir", "col_dir", "col_mid"):
            assert_same_plan(getattr(ref, f), getattr(port, f), f"{where}.{f}")
        return
    if kind == "GrrRangeSplit":
        assert tuple(ref.bounds) == tuple(port.bounds), where
        assert (ref.table_len, ref.n_segments) == (port.table_len,
                                                   port.n_segments)
        assert len(ref.parts) == len(port.parts), where
        for i, (a, b) in enumerate(zip(ref.parts, port.parts)):
            assert_same_plan(a, b, f"{where}.p{i}")
        return
    for f in tgrr._ARRAY_FIELDS:
        a, b = np.asarray(getattr(ref, f)), _host(getattr(port, f))
        assert a.dtype == b.dtype, (where, f, a.dtype, b.dtype)
        assert a.shape == b.shape and np.array_equal(a, b), (where, f)
    for f in ("table_len", "n_segments", "cap", "n_gw", "n_ow",
              "dense_grid"):
        assert getattr(ref, f) == getattr(port, f), (where, f)
    assert_same_plan(ref.overflow, port.overflow, where + ".o")


def _to_torch(jdir):
    """A reference direction's leaves as CPU tensors (kernel inputs)."""
    return {f: torch.from_numpy(np.array(getattr(jdir, f)))
            for f in tgrr._ARRAY_FIELDS}


def _table_t(d, table):
    pad = d.n_gw * tgrr.WIN - d.table_len
    return torch.nn.functional.pad(torch.from_numpy(table), (0, pad)).view(
        d.n_gw, 128, 128)


# -- the composed-index formula --------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_composed_index_formula_matches_apply_route_numpy(seed):
    """out[r,l] = x[b, g1[b,a]] with a = g3[r,l], b = g2[a,r] — the chain
    each CUDA thread walks — equals the three staged lane gathers."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(128 * 128).reshape(128, 128)
    g1, g2, g3 = route_tile(perm)
    x = rng.normal(0, 1, (128, 128)).astype(np.float32)
    a = g3
    b = g2[a, np.arange(128)[:, None]]
    composed = x[b, g1[b, a]]
    np.testing.assert_array_equal(composed, apply_route_numpy(x, g1, g2, g3))
    want = np.empty_like(x)
    want.reshape(-1)[perm.reshape(-1)] = x.reshape(-1)
    np.testing.assert_array_equal(composed, want)


# -- the plain versions against the reference's executors ------------------------


@pytest.mark.parametrize("cap", [4, 8])
def test_plain_b3_matches_jnp_and_pallas_interpret(cap):
    jnp, jgrr = _jax()
    from photon_ml_tpu.ops.grr_kernel import (
        grr_contract_jnp,
        grr_contract_kernel,
    )

    rng = np.random.default_rng(cap)
    idx, seg, val = _coo(rng, 4000, 40000, 5000)
    d = jgrr.build_grr_direction(idx, seg, val, 40000, 5000, cap=cap,
                                 dense_grid=False)
    table = rng.normal(0, 1, 40000).astype(np.float32)
    tt = _table_t(d, table)
    jt = jnp.asarray(tt.numpy())
    want_j = np.asarray(grr_contract_jnp(
        jt, d.g1, d.g2, d.g3, d.vals, d.gw_of_st, d.ow_of_st, n_ow=d.n_ow,
        cap=d.cap))
    want_k = np.asarray(grr_contract_kernel(
        jt, d.g1, d.g2, d.g3, d.vals, d.gw_of_st, d.ow_of_st, d.first_of_ow,
        n_ow=d.n_ow, cap=d.cap, interpret=True))
    p = _to_torch(d)
    got = tk.grr_contract(tt, p["g1"], p["g2"], p["g3"], p["vals"],
                          p["gw_of_st"], p["ow_of_st"], p["first_of_ow"],
                          n_ow=d.n_ow, cap=d.cap).numpy()
    assert got.shape == (d.n_ow, 128 // cap, 128)
    np.testing.assert_allclose(got, want_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_k, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cap", [8, 16])
def test_plain_b2_matches_jnp_and_pallas_interpret(cap):
    jnp, jgrr = _jax()
    from photon_ml_tpu.ops.grr_kernel import (
        grr_contract_jnp_dense,
        grr_contract_kernel_dense,
    )

    rng = np.random.default_rng(cap)
    idx, seg, val = _coo(rng, 40000, 40000, 5000)
    d = jgrr.build_grr_direction(idx, seg, val, 40000, 5000, cap=cap,
                                 dense_grid=True)
    assert d.dense_grid
    table = rng.normal(0, 1, 40000).astype(np.float32)
    tt = _table_t(d, table)
    jt = jnp.asarray(tt.numpy())
    want_j = np.asarray(grr_contract_jnp_dense(
        jt, d.g1, d.g2, d.g3, d.vals, n_ow_p=d.n_ow_padded, cap=d.cap))
    want_k = np.asarray(grr_contract_kernel_dense(
        jt, d.g1, d.g2, d.g3, d.vals, d.gw_of_st, n_ow_p=d.n_ow_padded,
        cap=d.cap, interpret=True))
    p = _to_torch(d)
    got = tk.grr_contract_dense(tt, p["g1"], p["g2"], p["g3"], p["vals"],
                                p["gw_of_st"], n_ow_p=d.n_ow_padded,
                                cap=d.cap).numpy()
    assert got.shape == (d.n_ow_padded, 128 // cap, 128)
    np.testing.assert_allclose(got, want_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_k, rtol=1e-5, atol=1e-5)


def test_cpu_calls_launch_nothing():
    rng = np.random.default_rng(3)
    idx, seg, val = _coo(rng, 3000, 20000, 3000)
    before = (tk.grr_contract.launches, tk.grr_contract_dense.launches)
    for force in (True, False):
        d = tgrr.build_grr_direction(idx, seg, val, 20000, 3000,
                                     dense_grid=force, device="cpu")
        d.contract(torch.zeros(20000))
    assert (tk.grr_contract.launches,
            tk.grr_contract_dense.launches) == before


@pytest.mark.parametrize("bad,exc,match", [
    ("table64", TypeError, "float32 table_t"),
    ("g1_int32", TypeError, "int8 route planes"),
    ("maps_int64", TypeError, "int32 tile maps"),
    ("table_2d", ValueError, "table_t must be"),
    ("planes_shape", ValueError, r"\[n_st, 128, 128\]"),
    ("cap", ValueError, "power of two"),
    ("meta", ValueError, "share one device"),
])
def test_dispatcher_rejects_bad_inputs(bad, exc, match):
    tt = torch.zeros(1, 128, 128)
    g = [torch.zeros(2, 128, 128, dtype=torch.int8) for _ in range(3)]
    vals = torch.zeros(2, 128, 128)
    maps = [torch.zeros(2, dtype=torch.int32) for _ in range(3)]
    cap = 4
    if bad == "table64":
        tt = tt.double()
    elif bad == "g1_int32":
        g[0] = g[0].int()
    elif bad == "maps_int64":
        maps[1] = maps[1].long()
    elif bad == "table_2d":
        tt = torch.zeros(128, 128)
    elif bad == "planes_shape":
        g[2] = torch.zeros(2, 128, 64, dtype=torch.int8)
    elif bad == "cap":
        cap = 48
    elif bad == "meta":
        vals = vals.to("meta")
    with pytest.raises(exc, match=match):
        tk.grr_contract(tt, *g, vals, *maps, n_ow=1, cap=cap)


def test_dense_dispatcher_rejects_bad_grid():
    tt = torch.zeros(1, 128, 128)
    g = [torch.zeros(8, 128, 128, dtype=torch.int8) for _ in range(3)]
    vals = torch.zeros(8, 128, 128)
    with pytest.raises(ValueError, match="dense grid"):
        tk.grr_contract_dense(tt, *g, vals, torch.zeros(2, dtype=torch.int32),
                              n_ow_p=6, cap=4)
    with pytest.raises(ValueError, match="gwg must be"):
        tk.grr_contract_dense(tt, *g, vals, torch.zeros(3, dtype=torch.int32),
                              n_ow_p=8, cap=4)


# -- the builder: identical plans, both builders ---------------------------------


@pytest.mark.parametrize("native", [True, False])
def test_build_grr_pair_identical_to_reference(native, monkeypatch):
    _jnp, jgrr = _jax()
    import photon_ml_torch.native as tnat
    import photon_ml_tpu.native as jnat

    if native:
        if not (tnat.native_available() and jnat.native_available()):
            pytest.skip("native library unavailable (no g++)")
    else:
        monkeypatch.setattr(tnat, "_lib", None)
        monkeypatch.setattr(jnat, "_lib", None)
    rng = np.random.default_rng(5)
    n, k, dim = 300, 5, 1000
    cols = np.stack([rng.choice(dim, k, replace=False) for _ in range(n)])
    cols = cols.astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    vals[rng.random((n, k)) < 0.1] = 0.0
    ref = jgrr.build_grr_pair(cols, vals, dim)
    port = tgrr.build_grr_pair(cols, vals, dim, device="cpu")
    assert_same_plan(ref, port)


def _case_overflow(rng):
    n, d, k = 600, 300, 6
    cols = np.where(rng.random((n, k)) < 0.5, rng.integers(0, 8, (n, k)),
                    rng.integers(0, d, (n, k))).astype(np.int32)
    cols = np.sort(cols, axis=1)
    for j in range(1, k):
        bump = cols[:, j] <= cols[:, j - 1]
        cols[bump, j] = cols[bump, j - 1] + 1
    cols = np.minimum(cols, d - 1)
    vals = rng.normal(size=(n, k)).astype(np.float32)
    return cols, vals, d, {"hot_threshold": 10**9, "overflow_threshold": 1}


def _case_mid_hot(rng):
    n, k, dim = 4096, 8, 2000
    cols = np.zeros((n, k), np.int64)
    cols[:, 0] = rng.integers(0, 6, n)
    cols[:, 1] = rng.integers(6, 30, n)
    cols[:, 2:] = rng.integers(30, dim, (n, k - 2))
    for j in range(1, k):
        for _ in range(6):
            dup = (cols[:, j:j + 1] == cols[:, :j]).any(axis=1)
            if not dup.any():
                break
            lo = 6 if j == 1 else 30
            cols[dup, j] = rng.integers(lo, dim, int(dup.sum()))
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    return cols.astype(np.int32), vals, dim, {"hot_threshold": 500,
                                              "mid_threshold": 40}


def _case_range_split(rng):
    cols, vals = _powerlaw_ell(rng, 12000, 20, 70000)
    return cols, vals, 70000, {"col_range_split": True}


def _case_hot(rng):
    n, k, dim = 700, 8, 900
    cols = np.stack([rng.choice(np.arange(1, dim), k, replace=False)
                     for _ in range(n)])
    cols[:, 0] = 0                 # column 0 in every row: hot
    return (cols.astype(np.int32), rng.normal(0, 1, (n, k)).astype(
        np.float32), dim, {})


@pytest.mark.parametrize("case", ["overflow", "mid_hot", "range_split",
                                  "hot"])
def test_pair_shapes_match_reference(case):
    """The reference's overflow, mid-hot, range-split and hot-column
    shapes (``tests/test_grr.py``): identical plans, and dot / t_dot /
    squared equal the reference's and a float64 dense product."""
    jnp, jgrr = _jax()
    rng = np.random.default_rng(11)
    cols, vals, dim, opts = {
        "overflow": _case_overflow, "mid_hot": _case_mid_hot,
        "range_split": _case_range_split, "hot": _case_hot}[case](rng)
    n = cols.shape[0]
    ref = jgrr.build_grr_pair(cols, vals, dim, **opts)
    port = tgrr.build_grr_pair(cols, vals, dim, device="cpu", **opts)
    assert_same_plan(ref, port)
    if case == "overflow":
        assert (port.col_dir.overflow is not None
                or port.row_dir.overflow is not None)
    if case == "mid_hot":
        assert port.col_mid is not None and port.hot_ids.shape[0] > 0
    if case == "range_split":
        assert isinstance(port.row_dir, tgrr.GrrRangeSplit)
    if case == "hot":
        assert 0 in port.hot_ids.tolist()
    x = _dense(cols, vals, n, dim)
    x2 = _dense(cols, vals * vals, n, dim)   # entries squared, as planned
    w = rng.normal(0, 1, dim).astype(np.float32)
    r = rng.normal(0, 1, n).astype(np.float32)
    for got, want, dense in (
            (port.dot(torch.from_numpy(w)), ref.dot(jnp.asarray(w)), x @ w),
            (port.t_dot(torch.from_numpy(r)), ref.t_dot(jnp.asarray(r)),
             x.T @ r),
            (port.squared().t_dot(torch.from_numpy(r)),
             ref.squared().t_dot(jnp.asarray(r)), x2.T @ r)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), dense, rtol=RTOL, atol=5e-4)


def test_overflow_chain_identical_to_reference():
    _jnp, jgrr = _jax()
    rng = np.random.default_rng(2)
    nnz, L, S = 120_000, 3000, 3000
    seg = (S * rng.random(nnz) ** 3.0).astype(np.int64)
    idx = rng.integers(0, L, nnz)
    val = rng.normal(0, 1, nnz).astype(np.float32)
    ref = jgrr.build_grr_direction(idx, seg, val, L, S, cap=4,
                                   overflow_threshold=500)
    port = tgrr.build_grr_direction(idx, seg, val, L, S, cap=4,
                                    overflow_threshold=500, device="cpu")
    assert_same_plan(ref, port)
    assert len(port.plan_stats()["overflow_levels"]) >= 2
    table = rng.normal(0, 1, L).astype(np.float32)
    np.testing.assert_allclose(port.contract(torch.from_numpy(table)).numpy(),
                               _direct(idx, seg, val, table, S),
                               rtol=RTOL, atol=5e-4)


# -- contractions ------------------------------------------------------------------


@pytest.mark.parametrize("nnz,L,S,cap,dense", [
    (2000, 300, 150, None, None),
    (5000, 40000, 5000, 4, False),
    (5000, 5000, 40000, 8, None),
    (30000, 70000, 70000, None, True),
    (30000, 70000, 70000, None, False),
    (64, 17000, 17, 4, None),
])
def test_direction_matches_direct(nnz, L, S, cap, dense):
    rng = np.random.default_rng(nnz + L)
    idx, seg, val = _coo(rng, nnz, L, S)
    d = tgrr.build_grr_direction(idx, seg, val, L, S, cap=cap,
                                 dense_grid=dense, device="cpu")
    if dense is not None:
        assert d.dense_grid == dense
    table = rng.normal(0, 1, L).astype(np.float32)
    out = d.contract(torch.from_numpy(table))
    assert out.dtype == torch.float32 and out.shape == (S,)
    np.testing.assert_allclose(out.numpy(), _direct(idx, seg, val, table, S),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        d.squared().contract(torch.from_numpy(table)).numpy(),
        _direct(idx, seg, val * val, table, S), rtol=RTOL, atol=ATOL)


def test_direction_empty():
    d = tgrr.build_grr_direction(np.empty(0, np.int64), np.empty(0, np.int64),
                                 np.empty(0, np.float32), 100, 50,
                                 device="cpu")
    out = d.contract(torch.zeros(100))
    assert out.shape == (50,) and not out.any()


def _coo_residual_direction(rng, device, m=20000, L=300, S=40):
    """An empty plan given a COO residual of ``m`` terms over ``S``
    segments (~500 terms a segment)."""
    idx, seg, val = _coo(rng, m, L, S)
    d = tgrr.build_grr_direction(np.empty(0, np.int64),
                                 np.empty(0, np.int64),
                                 np.empty(0, np.float32), L, S,
                                 device="cpu")
    d = dataclasses.replace(
        d, spill_idx=torch.from_numpy(idx.astype(np.int32)),
        spill_seg=torch.from_numpy(seg.astype(np.int32)),
        spill_val=torch.from_numpy(val)).to(device)
    assert d.n_spill == m
    return d, (idx, seg, val)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_coo_residual_sums_in_float64(device):
    """The COO residual (~500 terms a segment, each a float32 product) is
    summed in float64: each of twenty contractions is the float64 sum of
    the products rounded to float32 (within 2^-23 relative; a float32
    sum misses by ~1e-6), and on the CPU, which adds in index order,
    they are bitwise equal."""
    if device == "cuda":
        _cuda_or_skip()
    rng = np.random.default_rng(21)
    d, (idx, seg, val) = _coo_residual_direction(rng, device)
    table = rng.normal(0, 1, 300).astype(np.float32)
    t = torch.from_numpy(table).to(device)
    outs = [d.contract(t).cpu().numpy() for _ in range(20)]
    want = np.zeros(40, np.float64)
    np.add.at(want, seg, (val * table[idx]).astype(np.float64))
    for o in outs:
        np.testing.assert_allclose(o, want, rtol=2.0 ** -23,
                                   atol=1e-9 * float(np.abs(want).max()))
    if device == "cpu":
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])


def test_pair_matches_dense():
    rng = np.random.default_rng(4)
    n, k, dim = 700, 8, 900
    cols = np.stack([rng.choice(dim, k, replace=False) for _ in range(n)])
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    cols[:, 0] = 0
    pair = tgrr.build_grr_pair(cols, vals, dim, device="cpu")
    x = _dense(cols, vals, n, dim)
    w = rng.normal(0, 1, dim).astype(np.float32)
    r = rng.normal(0, 1, n).astype(np.float32)
    np.testing.assert_allclose(pair.dot(torch.from_numpy(w)).numpy(), x @ w,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pair.t_dot(torch.from_numpy(r)).numpy(),
                               x.T @ r, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        pair.squared().dot(torch.from_numpy(w)).numpy(), (x * x) @ w,
        rtol=RTOL, atol=ATOL)


def test_autograd_backward_is_the_other_direction():
    """grad of Σ(X·w)·r is Xᵀr, and grad of Σ(Xᵀr)·v is X·v: the custom
    Functions hand each backward to the other direction's plan."""
    rng = np.random.default_rng(6)
    n, k, dim = 200, 5, 150
    cols = np.stack([rng.choice(dim, k, replace=False) for _ in range(n)])
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    pair = tgrr.build_grr_pair(cols, vals, dim, device="cpu")
    r = torch.from_numpy(rng.normal(0, 1, n).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, dim).astype(np.float32))
    w = torch.zeros(dim, requires_grad=True)
    (pair.dot(w) * r).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), pair.t_dot(r).numpy(),
                               rtol=RTOL, atol=ATOL)
    q = torch.zeros(n, requires_grad=True)
    (pair.t_dot(q) * v).sum().backward()
    np.testing.assert_allclose(q.grad.numpy(), pair.dot(v).numpy(),
                               rtol=RTOL, atol=ATOL)


# -- the shared plan cache ------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_plan_cache_shared_both_ways(writer, tmp_path):
    """A plan cached by one package is a hit in the other, at the same
    path, and contracts to the same result."""
    jnp, jgrr = _jax()
    from photon_ml_tpu.cache import plan_cache as jcache

    from photon_ml_torch.cache import plan_cache as tcache

    rng = np.random.default_rng(17)
    n, d, k = 3000, 1200, 6
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    cache = str(tmp_path)
    if writer == "jax":
        ref = jgrr.build_grr_pair(cols, vals, d, cache_dir=cache)
        assert jgrr.last_build_phases["cache_hit"] == 0.0
        port = tgrr.build_grr_pair(cols, vals, d, cache_dir=cache,
                                   device="cpu")
        assert tgrr.last_build_phases["cache_hit"] == 1.0
    else:
        port = tgrr.build_grr_pair(cols, vals, d, cache_dir=cache,
                                   device="cpu")
        assert tgrr.last_build_phases["cache_hit"] == 0.0
        ref = jgrr.build_grr_pair(cols, vals, d, cache_dir=cache)
        assert jgrr.last_build_phases["cache_hit"] == 1.0
    path = jgrr.pair_cache_path_for(cols, vals, d, cache)
    assert os.listdir(os.path.dirname(path)) == [os.path.basename(path)]
    assert_same_plan(jcache.load_plan(path), tcache.load_plan(path))
    w = rng.normal(0, 1, d).astype(np.float32)
    r = rng.normal(0, 1, n).astype(np.float32)
    np.testing.assert_allclose(port.dot(torch.from_numpy(w)).numpy(),
                               np.asarray(ref.dot(jnp.asarray(w))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.t_dot(torch.from_numpy(r)).numpy(),
                               np.asarray(ref.t_dot(jnp.asarray(r))),
                               rtol=1e-5, atol=1e-5)


def test_plan_stats_match_reference():
    _jnp, jgrr = _jax()
    rng = np.random.default_rng(8)
    cols, vals = _powerlaw_ell(rng, 12000, 20, 70000)
    ref = jgrr.build_grr_pair(cols, vals, 70000)
    port = tgrr.build_grr_pair(cols, vals, 70000, device="cpu")
    stats = port.plan_stats()
    assert stats["row"] == ref.row_dir.plan_stats()
    assert stats["col"] == ref.col_dir.plan_stats()
    assert stats["hot_columns"] == int(ref.hot_ids.shape[0])


def test_launch_shape_one_range_a_block(monkeypatch):
    """At most one block an SM, at least one tile a block (one block for
    an empty plan), and scratch for two pieces a block when there are
    several."""
    dev = torch.device("cpu")
    monkeypatch.setitem(tk._SM_COUNT, dev, 132)
    for n_tiles, cap, want in ((2860, 8, 132), (223, 4, 132), (60, 1, 60),
                               (1, 128, 1), (0, 4, 1)):
        n_blocks, scratch = tk._launch_shape(dev, n_tiles, cap)
        assert n_blocks == want
        assert scratch.dtype == torch.float32
        assert tuple(scratch.shape) == ((want if want > 1 else 0), 2,
                                        128 // cap, 128)


def test_kernel_layout_check():
    """The CUDA kernel's layout rule: contiguous and 16-byte aligned."""
    buf = torch.zeros(2 * 128 * 128 + 16, dtype=torch.int8)
    ok = buf[:2 * 128 * 128].view(2, 128, 128)
    tk._check_layout("k", (ok,))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tk._check_layout("k", (buf[1:2 * 128 * 128 + 1].view(2, 128, 128),))
    with pytest.raises(ValueError, match="contiguous"):
        tk._check_layout("k", (ok.transpose(1, 2),))


def test_kernel_library_holds_both_launchers():
    p = _build.library_path("grr_contract")
    assert p.parent == _build.BUILD_DIR and p.name.startswith(
        "grr_contract-")
    assert set(_build._SIGNATURES["grr_contract"]) == {
        "grr_contract_dense_launch", "grr_contract_launch"}


# -- the CUDA kernels against their plain versions (card only) ----------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _kernel_args(d, table):
    tt = _table_t(d, table).cuda()
    leaves = {f: getattr(d, f) for f in tgrr._ARRAY_FIELDS}
    return tt, leaves


def _assert_kernel_close(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(want).max()), 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [4, 16, 64])
def test_cuda_b2_matches_plain(cap):
    """Dense grid with dummy tiles (a sparse block grid forced dense)."""
    _cuda_or_skip()
    rng = np.random.default_rng(cap)
    idx, seg, val = _coo(rng, 6000, 50000, 9000)
    d = tgrr.build_grr_direction(idx, seg, val, 50000, 9000, cap=cap,
                                 dense_grid=True, device="cuda")
    assert d.dense_grid
    tt, p = _kernel_args(d, rng.normal(0, 1, 50000).astype(np.float32))
    before = tk.grr_contract_dense.launches
    got = tk.grr_contract_dense(tt, p["g1"], p["g2"], p["g3"], p["vals"],
                                p["gw_of_st"], d.n_ow_padded, cap)
    torch.cuda.synchronize()
    assert tk.grr_contract_dense.launches == before + 1
    want = tk.grr_contract_dense_reference(tt, p["g1"], p["g2"], p["g3"],
                                           p["vals"], d.n_ow_padded, cap)
    _assert_kernel_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [4, 16, 64])
def test_cuda_b3_matches_plain(cap):
    _cuda_or_skip()
    rng = np.random.default_rng(cap + 1)
    idx, seg, val = _coo(rng, 6000, 50000, 9000)
    d = tgrr.build_grr_direction(idx, seg, val, 50000, 9000, cap=cap,
                                 dense_grid=False, device="cuda")
    tt, p = _kernel_args(d, rng.normal(0, 1, 50000).astype(np.float32))
    before = tk.grr_contract.launches
    got = tk.grr_contract(tt, p["g1"], p["g2"], p["g3"], p["vals"],
                          p["gw_of_st"], p["ow_of_st"], p["first_of_ow"],
                          d.n_ow, cap)
    torch.cuda.synchronize()
    assert tk.grr_contract.launches == before + 1
    want = tk.grr_contract_reference(tt, p["g1"], p["g2"], p["g3"],
                                     p["vals"], p["gw_of_st"], p["ow_of_st"],
                                     d.n_ow, cap)
    _assert_kernel_close(got, want)


@pytest.mark.cuda
def test_cuda_b3_empty_window_is_zero():
    """An output window with no supertile comes out as zeros in both
    versions (the builder never makes one; the kernel must not read
    another window's run)."""
    _cuda_or_skip()
    rng = np.random.default_rng(9)
    idx, seg, val = _coo(rng, 6000, 30000, 20000)
    d = tgrr.build_grr_direction(idx, seg, val, 30000, 20000, cap=4,
                                 dense_grid=False, device="cuda")
    tt, p = _kernel_args(d, rng.normal(0, 1, 30000).astype(np.float32))
    keep = p["ow_of_st"] != 1
    args = [p[f][keep].contiguous() for f in ("g1", "g2", "g3", "vals",
                                               "gw_of_st", "ow_of_st",
                                               "first_of_ow")]
    got = tk.grr_contract(tt, *args, d.n_ow, 4)
    torch.cuda.synchronize()
    want = tk.grr_contract_reference(tt, *args[:6], d.n_ow, 4)
    assert not want[1].any() and not got[1].any()
    _assert_kernel_close(got, want)


@pytest.mark.cuda
def test_cuda_pair_matches_cpu_pair():
    """A whole plan (range split, overflow, mid and hot sides) on the
    card against the same plan on the CPU."""
    _cuda_or_skip()
    rng = np.random.default_rng(12)
    cols, vals = _powerlaw_ell(rng, 20000, 20, 70000)
    cpu = tgrr.build_grr_pair(cols, vals, 70000, device="cpu")
    gpu = cpu.to("cuda")
    w = rng.normal(0, 0.1, 70000).astype(np.float32)
    r = rng.normal(0, 1, 20000).astype(np.float32)
    for fn, x in (("dot", w), ("t_dot", r)):
        got = getattr(gpu, fn)(torch.from_numpy(x).cuda())
        want = getattr(cpu, fn)(torch.from_numpy(x))
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-4)


# -- tile-range launches: edge shapes, synthetic planes (card only) -----------------
#
# The kernels compute the composed chain for any lane indices, so these
# cases use random planes and hand-made tile maps: one tile, runs of length
# one, long runs cut by many tile ranges, empty windows at both ends, a
# single table window, tile counts that are not a multiple of the SM count.


def _planes(rng, n_st, n_gw):
    dev = "cuda"
    g = [torch.from_numpy(rng.integers(0, 128, (n_st, 128, 128))
                          .astype(np.int8)).to(dev) for _ in range(3)]
    vals = torch.from_numpy(rng.normal(0, 1, (n_st, 128, 128))
                            .astype(np.float32)).to(dev)
    vals[vals.abs() < 0.5] = 0.0        # unfilled slots
    tt = torch.from_numpy(rng.uniform(-1, 1, (n_gw, 128, 128))
                          .astype(np.float32)).to(dev)
    return tt, g, vals


def _check_twice(run, plain):
    """Two launches agree bitwise, and with the plain version."""
    a, b = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(a, b), "two launches differ"
    want = plain()
    _assert_kernel_close(a, want)
    return a


def _runs_case(rng, ows, n_gw, n_ow, cap):
    """B3 over tiles whose output windows are ``ows`` (sorted), each run
    walking table windows in order."""
    ows = np.asarray(ows, np.int32)
    gw = np.concatenate([np.arange(c) % n_gw for c in
                         np.unique(ows, return_counts=True)[1]]).astype(
        np.int32)
    first = np.r_[True, ows[1:] != ows[:-1]].astype(np.int32)
    tt, g, vals = _planes(rng, len(ows), n_gw)
    maps = [torch.from_numpy(m).cuda() for m in (gw, ows, first)]
    before = tk.grr_contract.launches
    got = _check_twice(
        lambda: tk.grr_contract(tt, *g, vals, *maps, n_ow, cap),
        lambda: tk.grr_contract_reference(tt, *g, vals, *maps[:2], n_ow,
                                          cap))
    assert tk.grr_contract.launches == before + 2
    return got


def _dense_case(rng, n_gw, n_ow_p, cap):
    tt, g, vals = _planes(rng, n_gw * n_ow_p, n_gw)
    gwg = torch.from_numpy(np.repeat(np.arange(n_gw, dtype=np.int32),
                                     n_ow_p // tk.DENSE_B)).cuda()
    before = tk.grr_contract_dense.launches
    _check_twice(
        lambda: tk.grr_contract_dense(tt, *g, vals, gwg, n_ow_p, cap),
        lambda: tk.grr_contract_dense_reference(tt, *g, vals, n_ow_p, cap))
    assert tk.grr_contract_dense.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 128])
def test_cuda_extreme_caps(cap):
    """cap 1 (each slot its own output row) and cap 128 (all 128 rows of a
    tile into one), on both kernels, with runs cut by tile ranges."""
    _cuda_or_skip()
    rng = np.random.default_rng(cap + 20)
    _dense_case(rng, n_gw=3, n_ow_p=52, cap=cap)
    _runs_case(rng, np.repeat(np.arange(60), rng.integers(1, 6, 60)), 7,
               60, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [4, 8])
def test_cuda_one_tile(cap):
    _cuda_or_skip()
    rng = np.random.default_rng(30 + cap)
    _runs_case(rng, [0], 1, 1, cap)
    _dense_case(rng, n_gw=1, n_ow_p=4, cap=cap)


@pytest.mark.cuda
def test_cuda_runs_of_length_one_and_one_window():
    """n_gw = 1: every output window is one tile (B3), and B2's walk over
    gw is one tile long, over more windows than SMs."""
    _cuda_or_skip()
    rng = np.random.default_rng(40)
    _runs_case(rng, np.arange(300), 1, 300, 4)
    _dense_case(rng, n_gw=1, n_ow_p=300, cap=4)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [8, 16, 64])
def test_cuda_long_runs_cut_by_many_ranges(cap):
    """Runs far longer than a tile range (the gradient direction's shape:
    few windows, tens of tiles each), and tile counts that are not a
    multiple of the SM count: the pieces are summed across many blocks."""
    _cuda_or_skip()
    rng = np.random.default_rng(50 + cap)
    _dense_case(rng, n_gw=55, n_ow_p=8, cap=cap)
    _runs_case(rng, np.repeat([0, 1, 2], [200, 1, 97]), 200, 3, cap)


@pytest.mark.cuda
def test_cuda_empty_windows_at_both_ends():
    """Windows with no tile before the first run, between runs and after
    the last come out as zeros."""
    _cuda_or_skip()
    rng = np.random.default_rng(60)
    ows = np.repeat([2, 3, 7, 8, 12], [3, 1, 40, 2, 5])
    got = _runs_case(rng, ows, 9, 15, 4)
    for x in (0, 1, 4, 5, 6, 9, 10, 11, 13, 14):
        assert not got[x].any()


@pytest.mark.cuda
def test_cuda_empty_plan_is_zero():
    _cuda_or_skip()
    rng = np.random.default_rng(70)
    tt, g, vals = _planes(rng, 0, 1)
    maps = [torch.zeros(0, dtype=torch.int32, device="cuda")
            for _ in range(3)]
    got = tk.grr_contract(tt, *g, vals, *maps, 5, 8)
    torch.cuda.synchronize()
    assert got.shape == (5, 16, 128) and not got.any()

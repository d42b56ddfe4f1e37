"""The column-sorted copy and the segmented-sum Xᵀr (``data.colsorted``,
``ops.kernels.sorted_colsum``, ``csrc/sorted_colsum.cu``).

On the CPU: the copy each plain-ELL batch carries equals a numpy CSC
build of its slots; its merge-path partition is the one the kernel
walks; ``SparseBatch.xt_dot`` over it (``sorted_colsum_reference``)
equals the float64 ``index_add_`` scatter it replaces, and so do the
Hessian products (the squared copy); the down-sampled view, host and
streamed chunks and the λ-lane form keep the scatter; the telemetry
counters ``xtr.sorted`` and ``xtr.scatter`` count each path's calls.
Tolerance against the scatter: float32 rounding (``rtol=1e-6``); both
add the same float32 products in float64, in the same order on the CPU.

The CUDA kernel runs only on the card: the ``cuda`` tests skip without
one.  This file imports no JAX, so they run where only PyTorch is::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_sorted_colsum.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_torch import telemetry
from photon_ml_torch.data.batch import make_sparse_batch
from photon_ml_torch.data.chunked_batch import build_chunked_batch
from photon_ml_torch.data.colsorted import build_column_sorted
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.data.sparse_rows import SparseRows
from photon_ml_torch.game.coordinates import _apply_training_view
from photon_ml_torch.ops import kernels as tk
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import RegularizationContext
from photon_ml_torch.optim.streaming import _place_cpu
from photon_ml_torch.parallel import data_parallel_mesh, shard_batch

TILE = tk.SORTED_COLSUM_TILE


def _ell(case: str, seed: int = 0):
    """(cols [n, k] i32, vals [n, k] f32, d) of one case:

    - ``power_law``: power-law columns (head columns in most rows), 30 %
      of the slots zero-valued (ELL padding, col 0), the intercept
      column d − 1 in every row;
    - ``empty_columns``: 300 rows over 50,000 columns, most empty;
    - ``head_column``: one column in every one of 9,000 rows (the
      intercept of ``glm-fit`` in small: it spans several merge tiles),
      a second spread over the rest;
    - ``all_zero``: every slot zero-valued (no slot kept)."""
    rng = np.random.default_rng(seed)
    if case == "power_law":
        n, k, d = 3000, 9, 4001
        cols = ((d - 1) * rng.random((n, k)) ** 2.2).astype(np.int32)
        vals = rng.random((n, k)).astype(np.float32)
        pad = rng.random((n, k)) < 0.3
        cols[pad], vals[pad] = 0, 0.0
        cols[:, -1], vals[:, -1] = d - 1, 1.0
    elif case == "empty_columns":
        n, k, d = 300, 4, 50_000
        cols = rng.integers(0, d, (n, k)).astype(np.int32)
        vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    elif case == "head_column":
        n, k, d = 9000, 2, 700
        cols = np.stack([np.full(n, 5), rng.integers(6, d, n)], 1)
        cols = cols.astype(np.int32)
        vals = rng.random((n, k)).astype(np.float32) + 0.5
    else:
        n, k, d = 50, 3, 20
        cols = rng.integers(0, d, (n, k)).astype(np.int32)
        vals = np.zeros((n, k), np.float32)
    return cols, vals, d


CASES = ["power_law", "empty_columns", "head_column", "all_zero"]


def _rows(cols, vals) -> SparseRows:
    """SparseRows of the ELL's slots, each row's ids unique (a repeated
    id's slots summed) and zero-valued slots dropped."""
    indptr, out_c, out_v = [0], [], []
    for c, v in zip(cols, vals):
        keep = v != 0
        u, inv = np.unique(c[keep], return_inverse=True)
        s = np.zeros(len(u), np.float32)
        np.add.at(s, inv, v[keep])
        out_c.append(u)
        out_v.append(s)
        indptr.append(indptr[-1] + len(u))
    return SparseRows.from_flat(np.asarray(indptr, np.int64),
                                np.concatenate(out_c).astype(np.int64),
                                np.concatenate(out_v).astype(np.float32))


def _batch(case: str, seed: int = 0, **kw):
    cols, vals, d = _ell(case, seed)
    rows = _rows(cols, vals)
    n = len(rows)
    labels = (np.random.default_rng(seed + 1).random(n) < 0.4)
    return make_sparse_batch(rows, d, labels.astype(np.float32),
                             device="cpu", **kw)


def _scatter(batch):
    """The same batch without its copy: the float64 scatter."""
    return dataclasses.replace(batch, colsorted=None)


def _residual(n: int, seed: int = 2) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).normal(0, 1, n).astype(np.float32))


# -- the copy and its partition -------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_copy_matches_numpy_csc(case):
    """rows, vals and col_ptr equal a stable numpy CSC build of the
    ELL's slots with the zero-valued ones dropped: zero-valued slots out,
    empty columns empty, the head column and the intercept whole."""
    cols, vals, d = _ell(case)
    cs = build_column_sorted(torch.from_numpy(cols), torch.from_numpy(vals),
                             d)
    n, k = cols.shape
    flat_c, flat_v = cols.reshape(-1), vals.reshape(-1)
    flat_r = np.repeat(np.arange(n), k)
    keep = flat_v != 0
    order = np.argsort(flat_c[keep], kind="stable")
    want_ptr = np.zeros(d + 1, np.int64)
    np.cumsum(np.bincount(flat_c[keep], minlength=d), out=want_ptr[1:])
    np.testing.assert_array_equal(cs.col_ptr.numpy(), want_ptr)
    np.testing.assert_array_equal(cs.rows.numpy(), flat_r[keep][order])
    np.testing.assert_array_equal(cs.vals.numpy(), flat_v[keep][order])
    assert cs.rows.dtype == torch.int32 and cs.col_ptr.dtype == torch.int64
    assert cs.dim == d and 0.0 not in cs.vals
    if case == "head_column":
        assert int(cs.col_ptr[6] - cs.col_ptr[5]) == n > 4 * TILE
    if case == "power_law":
        assert int(cs.col_ptr[d] - cs.col_ptr[d - 1]) == n
    if case == "empty_columns":
        assert int((cs.col_ptr.diff() == 0).sum()) > d // 2


@pytest.mark.parametrize("case", CASES)
def test_tiles_are_the_merge_path(case):
    """Tile b starts at item b·TILE of the merged list (each column's end
    after its slots): the columns ended before it are those whose end
    item comes earlier, and its slots start where they stop."""
    cols, vals, d = _ell(case)
    cs = build_column_sorted(torch.from_numpy(cols), torch.from_numpy(vals),
                             d)
    ptr, tiles = cs.col_ptr.numpy(), cs.tiles.numpy()
    nnz = int(ptr[-1])
    total = d + nnz
    assert len(tiles) == -(-total // TILE) + 1
    end_item = ptr[1:] + np.arange(d)          # column j's end, 0-based
    for b, x in enumerate(tiles):
        start = min(b * TILE, total)
        assert x == int((end_item < start).sum())
        y = start - x                             # slots before the tile
        assert 0 <= y <= nnz and (x == d or ptr[x + 1] >= y)
    assert tiles[0] == 0 and tiles[-1] == d
    assert (np.diff(tiles) >= 0).all()


# -- Xᵀr and the Hessian products on the two paths ------------------------


@pytest.mark.parametrize("case", CASES)
def test_sorted_xt_dot_equals_the_scatter(case):
    batch = _batch(case)
    assert batch.colsorted is not None
    r = _residual(batch.n_padded)
    got = batch.xt_dot(r)
    want = _scatter(batch).xt_dot(r)
    assert got.dtype == torch.float32 and got.shape == (batch.dim,)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max() + 1))
    dense = batch.to_dense().x.double().T @ r.double()
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5 * float(dense.abs().max() + 1))


@pytest.mark.parametrize("what", ["hessian_diagonal", "hessian_vector",
                                  "value_and_gradient"])
def test_objective_paths_agree(what):
    """The objective's products over the copy (and its squared copy)
    against the scatter's."""
    batch = _batch("power_law", seed=3)
    obj = GLMObjective(loss=losses.LOGISTIC, reg=RegularizationContext.l2(0.5),
                       norm=NormalizationContext.identity())
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(0, 0.2, batch.dim).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, batch.dim).astype(np.float32))
    args = {"hessian_diagonal": (w,), "hessian_vector": (w, v),
            "value_and_gradient": (w,)}[what]
    got = getattr(obj, what)(*args, batch)
    want = getattr(obj, what)(*args, _scatter(batch))
    if what == "value_and_gradient":
        assert float(got[0]) == float(want[0])
        got, want = got[1], want[1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


def test_squared_copy():
    batch = _batch("power_law")
    sq = batch.colsorted.squared()
    assert torch.equal(sq.vals, batch.colsorted.vals ** 2)
    assert sq.rows is batch.colsorted.rows
    assert sq.col_ptr is batch.colsorted.col_ptr


def test_training_view_drops_the_copy():
    """The down-sampled view indexes a row subset: it drops the copy and
    runs the scatter, on its own rows."""
    batch = _batch("power_law", seed=5)
    n = batch.n_padded
    idx = torch.from_numpy(np.sort(np.random.default_rng(6).choice(
        n, n // 3, replace=False)))
    offsets = torch.zeros(n)
    view = _apply_training_view(batch, offsets, idx, torch.ones(len(idx)))
    assert view.colsorted is None
    r = _residual(len(idx), seed=7)
    want = view.to_dense().x.double().T @ r.double()
    np.testing.assert_allclose(view.xt_dot(r).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    # Without a row subset the copy stays.
    assert _apply_training_view(batch, offsets, None, None).colsorted \
        is batch.colsorted


def test_layouts_and_chunks_carry_no_copy():
    """Only a plain-ELL batch placed by ``make_sparse_batch`` carries the
    copy: not the transposed ELL, not GRR, not a host chunk nor its
    streamed placement."""
    assert _batch("power_law", col_major=True).colsorted is None
    assert _batch("power_law", grr=True).colsorted is None
    cols, vals, d = _ell("power_law")
    rows = _rows(cols, vals)
    cb = build_chunked_batch(rows, d, np.zeros(len(rows), np.float32),
                             n_chunks=3)
    for i in range(cb.n_chunks):
        host = cb.chunk(i)
        assert host.colsorted is None
        assert _place_cpu(host).batch.colsorted is None


def test_mesh_shards_carry_their_own_copy():
    """``shard_batch`` gives each shard the copy of its own rows, so a
    shard's Xᵀr sums its rows only."""
    batch = _batch("power_law", pad_to=3000)
    mesh = data_parallel_mesh(4, device="cpu")
    sb = shard_batch(batch, mesh)
    r = _residual(batch.n_padded, seed=8)
    per = batch.n_padded // 4
    total = torch.zeros(batch.dim, dtype=torch.float64)
    for j, shard in enumerate(sb.shards):
        assert shard.colsorted is not None
        assert int(shard.colsorted.rows.max()) < per
        part = shard.xt_dot(r[j * per:(j + 1) * per].contiguous())
        np.testing.assert_array_equal(
            part.numpy(),
            _scatter(shard).xt_dot(r[j * per:(j + 1) * per]).numpy())
        total += part.double()
    want = _scatter(batch).xt_dot(r).double()
    np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("form", ["vector", "lanes", "view", "chunk"])
def test_counters_name_the_path(form):
    """In a session each call counts ``xtr.sorted`` (a batch with the
    copy, one vector) or ``xtr.scatter`` (the λ-lane form R [L, n], the
    down-sampled view, a host chunk placed for streaming)."""
    batch = _batch("power_law")
    n = batch.n_padded
    if form == "vector":
        call, want = (lambda: batch.xt_dot(_residual(n))), "xtr.sorted"
    elif form == "lanes":
        R = torch.stack([_residual(n, s) for s in range(3)])
        call, want = (lambda: batch.xt_dot(R)), "xtr.scatter"
    elif form == "view":
        idx = torch.arange(0, n, 2)
        view = _apply_training_view(batch, torch.zeros(n), idx,
                                    torch.ones(len(idx)))
        call, want = (lambda: view.xt_dot(_residual(len(idx)))), \
            "xtr.scatter"
    else:
        cols, vals, d = _ell("power_law")
        rows = _rows(cols, vals)
        cb = build_chunked_batch(rows, d, np.zeros(len(rows), np.float32),
                                 n_chunks=2)
        placed = _place_cpu(cb.chunk(0)).batch
        call, want = (lambda: placed.xt_dot(_residual(placed.n_padded))), \
            "xtr.scatter"
    call()                               # no session: nothing counted
    t = telemetry.start("metrics", device="cpu")
    try:
        call()
        call()
        c = t.summary()["counters"]
    finally:
        t.close()
    other = ({"xtr.sorted", "xtr.scatter"} - {want}).pop()
    assert c.get(want) == 2 and other not in c


# -- the wrapper -------------------------------------------------------------


def test_cpu_calls_launch_nothing():
    batch = _batch("head_column")
    before = tk.sorted_colsum.launches
    batch.xt_dot(_residual(batch.n_padded))
    assert tk.sorted_colsum.launches == before


@pytest.mark.parametrize("bad,match", [
    ("r64", "float32 r and vals"), ("rows64", "int32 rows"),
    ("r2d", "1-D"), ("short_vals", "1-D"), ("tiles", "partition"),
])
def test_wrapper_rejects(bad, match):
    cs = _batch("power_law").colsorted
    r = _residual(3000)
    args = [r, cs.rows, cs.vals, cs.col_ptr, cs.tiles]
    if bad == "r64":
        args[0] = r.double()
    elif bad == "rows64":
        args[1] = cs.rows.long()
    elif bad == "r2d":
        args[0] = r[None]
    elif bad == "short_vals":
        args[2] = cs.vals[:-1]
    else:
        args[4] = cs.tiles[:-1]
    with pytest.raises((TypeError, ValueError), match=match):
        tk.sorted_colsum(*args)


# -- the kernel on the card ---------------------------------------------------


def _cuda_batch(case: str, seed: int = 0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cols, vals, d = _ell(case, seed)
    rows = _rows(cols, vals)
    return make_sparse_batch(rows, d, np.zeros(len(rows), np.float32),
                             device="cuda")


def _close(got, want):
    """Within two float32 ulps: float64 sums of the same float32 products
    in two orders, each rounded once, differ by far less than the last
    bit but may round to neighbours."""
    want = want.cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2 ** -22,
                               atol=1e-12 * float(np.abs(want).max(
                                   initial=0)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain(case):
    """Bitwise equal over two launches (no atomics); within float32
    rounding of the plain version and of the scatter; one counted call
    an Xᵀr."""
    batch = _cuda_batch(case)
    cs = batch.colsorted
    r = _residual(batch.n_padded).cuda()
    before = tk.sorted_colsum.launches
    got = batch.xt_dot(r)
    again = batch.xt_dot(r)
    torch.cuda.synchronize()
    assert tk.sorted_colsum.launches == before + 2
    assert torch.equal(got, again)
    want = tk.sorted_colsum_reference(r, cs.rows, cs.vals, cs.col_ptr)
    _close(got, want)
    _close(got, _scatter(batch).xt_dot(r))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 1), (5, 3), (4097, 2), (70_001, 900)])
def test_cuda_kernel_at_ragged_sizes(n, d):
    """Slot counts not a multiple of 4 or of the tile, a single column,
    a last tile partly filled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(n)
    k = 3
    cols = torch.from_numpy(rng.integers(0, d, (n, k)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(0, 1, (n, k)).astype(np.float32))
    cs = build_column_sorted(cols.cuda(), vals.cuda(), d)
    r = _residual(n).cuda()
    got = cs.xt_dot(r)
    want = tk.sorted_colsum_reference(r, cs.rows, cs.vals, cs.col_ptr)
    torch.cuda.synchronize()
    _close(got, want)
